"""The rate of a decode cell's searcher against its batch size: how the
batch of an offline (closed-loop) decode cell is chosen.

    python asr_bench/sweep.py --workload flagship.decode_enh --seed 7
        --batches 128,256,512,1024,2048 --seconds 6

One process on the card: the cell's weights from the seed, ``--distinct``
utterances of its traffic synthesised once and repeated to each batch
size (the searcher does the same work for a repeated row), the searcher
warmed on each shape, then a closed loop for ``--seconds`` (copy in,
search, tokens out). Prints one JSON line a batch size (utterances a
second, ms a batch, peak device memory) and, last, the knee: the smallest
batch whose rate is within ``--within`` of the best.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def knee(rates, within: float) -> int:
    """The smallest batch whose rate is at least (1 - within) x the best."""
    best = max(rates.values())
    return min(b for b, r in rates.items() if r >= (1.0 - within) * best)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", default="128,256,512,1024,2048")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--distinct", type=int, default=128)
    ap.add_argument("--within", type=float, default=0.1)
    args = ap.parse_args(argv)

    from asr_bench import core

    core.environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from asr_bench import weights

    dev = torch.device("cuda", 0)
    bench = core.benchmark(ROOT)
    w = core.workload(bench, args.workload)
    cfg = core.config_file(bench, w["config"], ROOT)
    traffic = core.traffic_file(w["traffic"])
    drv = core.driver(traffic["kind"])
    lm_cfg = drv.lm_fields(traffic)
    vocab = cfg["e2e"]["decoder"]["vocab_size"]
    wts = weights.make(weights.generator_layout(cfg), args.seed, dev)
    lm_w = (weights.make(weights.lm_layout(lm_cfg, vocab), args.seed, dev,
                         "lm") if lm_cfg else None)
    _, searcher, _ = drv.program(cfg, traffic, wts, lm_w, dev)
    t0 = time.perf_counter()
    (x0, n0), = drv.pool(cfg, dict(traffic, batch=args.distinct,
                                   pool_batches=1), args.seed)
    synth_s = time.perf_counter() - t0
    print(f"card {core.gpu_facts()}", flush=True)
    rates = {}
    for b in (int(s) for s in args.batches.split(",") if s):
        reps = -(-b // args.distinct)
        x = x0.repeat(reps, 1)[:b].pin_memory()
        n = n0.repeat(reps)[:b].pin_memory()
        line = {"batch": b}
        try:
            for _ in range(2):  # warm this shape
                searcher(x.to(dev), n.to(dev)).tokens.cpu()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            done, start = 0, time.perf_counter()
            while time.perf_counter() - start < args.seconds:
                res = searcher(x.to(dev, non_blocking=True),
                               n.to(dev, non_blocking=True))
                res.tokens.cpu()
                done += 1
            wall = time.perf_counter() - start
            rates[b] = done * b / wall
            line.update(utt_per_s=rates[b], ms_a_batch=1e3 * wall / done,
                        batches=done,
                        memory_peak_bytes=torch.cuda.max_memory_allocated(
                            dev))
        except (RuntimeError, ValueError) as e:  # a shape the port refuses
            line["error"] = f"{type(e).__name__}: {e}"[:400]
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"knee": knee(rates, args.within) if rates else None,
                      "within": args.within,
                      "synth_s_per_utt": synth_s / args.distinct}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
