"""Readings that the limits of a cell's comparison are set from.

    python asr_bench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 3,4,5] [--fault-seeds 6,7,8]

In one process, for each seed: the weights and host batches a run of the
cell makes from it, the program's timed call on the batches a run checks
(a decode cell's checked pool batches through the searcher; a training
cell's first steps through the joint step), and the numbers a run
compares. For each control seed, the same with the control in the
program's place: the reference computed in float8 (parameters and e4m3
operands, e5m2 gradients), the precision below the configuration's
bfloat16, or in the precision ``--control`` names. For each
fault seed of a training cell, the float32 reference that leaves out half
of each batch. Prints one JSON line a reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# the precision below the configurations' bfloat16
CONTROL = "fp8"


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


class _Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def mark(self, name):
        pass


def decode_reading(ctx, drv, seed, control):
    import torch

    from asr_bench import weights

    ctx.seed = seed
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    lm_cfg = drv.lm_fields(traffic)
    vocab = cfg["e2e"]["decoder"]["vocab_size"]
    w = weights.make(weights.generator_layout(cfg), seed, dev)
    lm_w = (weights.make(weights.lm_layout(lm_cfg, vocab), seed, dev, "lm")
            if lm_cfg else None)
    model, searcher, _ = drv.program(cfg, traffic, w, lm_w, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cap = drv.Capture(model, sync)
    host = drv.pool(cfg, traffic, seed)
    checks = {b: b for b in range(len(host))}
    kept = {}
    for b, (x, n) in enumerate(host):
        cap.keep = True
        res = searcher(x.to(dev), n.to(dev))
        kept[b] = dict(cap.kept, tokens=res.tokens.cpu(),
                       lengths=res.lengths.cpu(), score=res.scores.cpu(),
                       beams=drv.beams(res))
        cap.kept = {}
    del searcher, model, cap
    return drv.check_numbers(ctx, w, lm_w, lm_cfg, host, checks, kept,
                             control=control)


def train_reading(ctx, drv, seed, control, fault, detail=None):
    from asr_bench import weights

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    wg = weights.make(weights.generator_layout(cfg), seed, dev)
    wd = weights.make(weights.discriminator_layout(cfg), seed, dev,
                      "discriminator")
    host = drv.pool(cfg, traffic, seed)[:traffic["checked_steps"]]
    wg0 = {k: v.cpu() for k, v in wg.items()}
    wd0 = {k: v.cpu() for k, v in wd.items()}
    rec = None
    if control is None and fault is None:
        state, step = drv.program(cfg, traffic, wg, wd, dev)
        rec = {"losses": []}
        for i, bt in enumerate(host):
            m = step(state, {k: v.to(dev) for k, v in bt.items()})
            rec["losses"].append({k: float(m[k]) for k in ("loss_g",
                                                            "loss_d")})
            if i == 0:
                rec["grad_g"] = drv.first_moment_grads(
                    state.opt_g, state.model.named_parameters())
                rec["grad_d"] = drv.first_moment_grads(
                    state.opt_d, state.discriminator.named_parameters())
        rec["params_g"] = {k: v.detach().cpu().clone()
                           for k, v in state.model.state_dict().items()}
        rec["params_d"] = {k: v.detach().cpu().clone() for k, v in
                           state.discriminator.state_dict().items()}
        del state, step
    del wg, wd
    return drv.check_numbers(ctx, wg0, wd0, host, rec, control=control,
                             fault=fault, detail=detail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--control", default=CONTROL,
                    help="the control's precision (fp8; bf16 as a witness)")
    args = ap.parse_args(argv)

    import torch

    from asr_bench import core

    core.environment(ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = core.benchmark(ROOT)
    w = core.workload(bench, args.workload)
    cfg = core.config_file(bench, w["config"], ROOT)
    traffic = core.traffic_file(w["traffic"])
    drv = core.driver(traffic["kind"])
    ctx = _Ctx(cfg=cfg, traffic=traffic, device=dev)
    print(f"card {core.gpu_facts()}", flush=True)
    runs = ([("program", s) for s in _ints(args.seeds)]
            + [("control", s) for s in _ints(args.control_seeds)]
            + [("fault_half", s) for s in _ints(args.fault_seeds)])
    for kind, seed in runs:
        t0 = time.perf_counter()
        control = args.control if kind == "control" else None
        detail = {}
        if traffic["kind"] == "decode":
            if kind == "fault_half":
                continue
            nums = decode_reading(ctx, drv, seed, control)
        else:
            nums = train_reading(ctx, drv, seed, control,
                                 "half" if kind == "fault_half" else None,
                                 detail)
        torch.cuda.empty_cache()
        line = {"cell": args.workload, "kind": kind, "seed": seed,
                "precision": control or "program",
                "numbers": nums, "s": time.perf_counter() - t0,
                "detail": detail}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
