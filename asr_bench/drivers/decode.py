"""Driver of the decode cells: offline batch transcription, a closed loop
with one client.

Set-up makes the weights from the seed on the device, a pool of host
batches from the seed, binds the searcher of ``decode/beam.py`` and warms
it on the pool's shape. Each iteration of the window takes the pool's next
batch, copies its waveforms and lengths to the device, calls the searcher
and copies the best tokens, lengths and scores back; that copy ends the
batch. The window runs from its start to the end of the last batch begun
before ``--seconds`` had passed, and ``decode_utt_per_s`` is every
utterance whose tokens reached the host in it over its length (so a
batch cut by the deadline neither drops its work nor leaves its time
out). A traced run adds a span per batch, a split of
each batch at the end of the encoder pass (a synchronise there), and a
profiled window of a few batches after the timed one.

After the window, the checked iterations (one per pool batch, drawn from
the seed) are held against the plain reference (``reference/
decode_check.py``) on a sample of their rows drawn from the seed, the
longest utterance among them; the program's state is freed first.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from asr_bench import core, flops, synth, trace, weights
from asr_bench.reference import decode_check
from asr_bench.reference import model as ref

class Capture:
    """Observes the searcher's encoder pass through the model's public
    entry ``encode_for_decode`` and forward hooks: keeps the enhancer's
    mask logits, the encoder's input features, its outputs and the CTC
    logits of the checked iterations, and in a traced run times the
    pass's end."""

    def __init__(self, model, sync: Callable[[], None]):
        self.keep = False
        self.split = False
        self.sync = sync
        self.t_encoded = 0.0
        self.kept: Dict[str, torch.Tensor] = {}
        encode = model.encode_for_decode

        def observed_encode(*args, **kwargs):
            out = encode(*args, **kwargs)
            if self.keep:
                self.kept.update(hs=out[0], ctc=out[3])
            if self.split:
                self.sync()
                self.t_encoded = time.perf_counter()
            return out

        model.encode_for_decode = observed_encode
        model.asr.encoder.register_forward_pre_hook(self._feats_hook)
        model.enhancer.mask_out.register_forward_hook(self._logits_hook)

    def _feats_hook(self, module, args):
        if self.keep:
            self.kept["feats"] = args[0]

    def _logits_hook(self, module, args, output):
        if self.keep:
            self.kept["enh_logits"] = output


def program(cfg: dict, traffic: dict, w, lm_w, dev):
    """(model, searcher, lm) of the port, loaded with the benchmark's
    weights."""
    from robust_e2e_gan_torch.config import (
        BeamSearchConfig,
        JointConfig,
        LMConfig,
        from_dict,
    )
    from robust_e2e_gan_torch.decode.beam import make_beam_searcher
    from robust_e2e_gan_torch.models.lm import RNNLM
    from robust_e2e_gan_torch.pipeline import build_model

    jcfg = from_dict(JointConfig, cfg)
    if traffic.get("frontend_fused"):
        e2e = jcfg.e2e
        jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(
            e2e, frontend=dataclasses.replace(e2e.frontend, fused=True)))
    model = build_model(jcfg).to(dev).eval()
    model.load_state_dict(w)
    lm = None
    if traffic.get("lm"):
        lcfg = LMConfig(vocab_size=jcfg.e2e.decoder.vocab_size,
                        **traffic["lm"])
        lm = RNNLM(lcfg).to(dev).eval()
        lm.load_state_dict(lm_w)
    bcfg = BeamSearchConfig(**traffic["beam"])
    searcher = make_beam_searcher(model, jcfg.e2e, bcfg,
                                  use_enhancer=traffic["use_enhancer"], lm=lm)
    return model, searcher, lm


def pool(cfg: dict, traffic: dict, seed: int):
    """The host batches of a run: (wav (B, N) f32, lengths (B,) int32)."""
    rng = np.random.default_rng(weights.seed64(seed))
    scfg = synth.SyntheticConfig(
        vocab_size=cfg["e2e"]["decoder"]["vocab_size"], **traffic["synth"])
    out = []
    for _ in range(traffic["pool_batches"]):
        data = synth.make_batch(traffic["batch"], scfg, rng,
                                pad_to_samples=traffic.get("pad_to_samples"))
        out.append((torch.from_numpy(data[traffic["wav"]]),
                    torch.from_numpy(data["wav_lengths"])))
    return out


def checked_iterations(traffic: dict, seed: int) -> Dict[int, int]:
    """Window iteration -> pool batch, one per pool batch, drawn from the
    seed among its first ``check_rounds`` turns."""
    rng = np.random.default_rng([weights.seed64(seed), 7])
    p = traffic["pool_batches"]
    return {b + p * int(rng.integers(0, traffic["check_rounds"])): b
            for b in range(p)}


def checked_rows(traffic: dict, seed: int, lengths: torch.Tensor
                 ) -> torch.Tensor:
    """The rows of a checked batch that the reference works out again:
    ``check_rows`` of them drawn from the seed, the longest utterance
    among them; every row where the batch has no more."""
    b = lengths.shape[0]
    n = traffic.get("check_rows") or b
    if n >= b:
        return torch.arange(b)
    longest = int(torch.argmax(lengths))
    rng = np.random.default_rng([weights.seed64(seed), 11])
    others = [r for r in rng.permutation(b).tolist() if r != longest]
    return torch.tensor(sorted([longest] + others[:n - 1]))


def beams(res) -> tuple:
    """The searcher's K final hypotheses on the host: tokens (B, K, L),
    lengths (B, K), scores (B, K)."""
    return (res.beam_tokens.cpu(), res.beam_lengths.cpu(),
            res.beam_scores.cpu())


def lm_fields(traffic: dict) -> Optional[dict]:
    """The RNNLM's fields of the traffic, or None where it fuses none."""
    if not traffic.get("lm"):
        return None
    return {"num_layers": 1, **traffic["lm"]}


def run(ctx) -> dict:
    """One run of a decode cell: set-up, the window, the traced extras,
    the check. Returns the driver's part of the result."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    b = traffic["batch"]
    vocab = cfg["e2e"]["decoder"]["vocab_size"]
    lm_cfg = lm_fields(traffic)

    # ---- set-up
    ctx.mark("imported")
    w = weights.make(weights.generator_layout(cfg), ctx.seed, dev)
    lm_w = (weights.make(weights.lm_layout(lm_cfg, vocab), ctx.seed, dev,
                         "lm") if lm_cfg else None)
    ctx.mark("weights")
    model, searcher, lm = ctx.program(cfg, traffic, w, lm_w, dev)
    ctx.mark("program")
    host = pool(cfg, traffic, ctx.seed)
    ctx.mark("pool")
    if on_cuda:
        host = [(x.pin_memory(), n.pin_memory()) for x, n in host]
    cap = Capture(model, sync)
    checks = checked_iterations(traffic, ctx.seed)

    def batch(i: int):
        x, n = host[i % len(host)]
        res = searcher(x.to(dev, non_blocking=True),
                       n.to(dev, non_blocking=True))
        return res, (res.tokens.cpu(), res.lengths.cpu(), res.scores.cpu())

    routes_before = ctx.routes()
    for i in range(traffic["warmup_batches"]):
        batch(i)
        ctx.mark(f"warm batch {i}")
    sync()
    ctx.setup_done()

    # ---- the window
    served, failed, spans, enc_ms, search_ms = 0, 0, [], [], []
    kept = {}
    cap.split = ctx.trace
    start = time.perf_counter()
    deadline = start + ctx.seconds
    i = 0
    while time.perf_counter() < deadline:
        cap.keep = i in checks
        t0 = time.perf_counter()
        res, (toks, lens, scores) = batch(i)
        t1 = time.perf_counter()
        if cap.keep:
            kept[i] = dict(cap.kept, tokens=toks, lengths=lens, score=scores,
                           beams=beams(res))
            cap.kept = {}
            cap.keep = False
        del res
        served += b
        bad_len = (lens < 0) | (lens > traffic["beam"]["max_steps"])
        failed += int((~torch.isfinite(scores) | bad_len).sum())
        spans.append((t1 - t0) * 1e3)
        if ctx.trace:
            enc_ms.append((cap.t_encoded - t0) * 1e3)
            search_ms.append((t1 - cap.t_encoded) * 1e3)
        i += 1
    window_s = t1 - start  # to the end of the last batch begun in time
    cap.split = False
    out = {"attempted": served, "failed": failed, "iterations": i,
           "e2e": {"decode_utt_per_s": served / window_s},
           "spread": core.quartiles(spans)}
    if ctx.trace:
        units = traffic["profile_batches"]
        at = [i]

        def one():
            batch(at[0])
            at[0] += 1

        prof = trace.profile(one, units, sync) if on_cuda else None
        del one
        lengths = [host[(i + u) % len(host)][1].tolist()
                   for u in range(units)]
        model_flops = sum(flops.decode_batch_flops(
            host[j % len(host)][1].tolist(), cfg, traffic["beam"],
            traffic["use_enhancer"], lm_cfg)
            for j in range(len(spans)))
        out["layer"] = {"batch_ms": spans, "encode_ms": enc_ms,
                        "search_ms": search_ms, "profile": prof,
                        "profile_lengths": lengths, "lm": lm_cfg,
                        "model_flops": model_flops,
                        "window_s": window_s, "kind": "decode"}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if on_cuda else 0)
    out["routes"] = ctx.routes(routes_before)

    # ---- the check, after the program's state is freed
    del searcher, model, lm, cap, batch
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    missing = sorted(set(checks) - set(kept))
    if missing:
        out["checks"] = {"checked_iterations_missing": (float(len(missing)),
                                                        0.0)}
        return out
    numbers = check_numbers(ctx, w, lm_w, lm_cfg, host, checks, kept)
    out["checks"] = core.limited(numbers, ctx.limits)
    out["uncompared"] = {k: v for k, v in numbers.items()
                         if k not in ctx.limits}
    return out


def _rows(t: torch.Tensor, rows: torch.Tensor, lengths: torch.Tensor):
    """The checked rows of a tensor the searcher produced for the batch;
    None where it has not a row an utterance (the comparison fails)."""
    if t.shape[0] != lengths.shape[0]:
        return None
    return t[rows.to(t.device)]


def widest(a: float, b: float) -> float:
    """The larger of two gaps; NaN wins, so that it fails its limit."""
    return a if a != a or b <= a else b


def check_numbers(ctx, w, lm_w, lm_cfg, host, checks, kept,
                  control: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared over the checked iterations: each the widest
    gap between what the searcher served (or, with ``control`` a
    precision, what the reference computes in it) and the reference."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    use_enh = traffic["use_enhancer"]
    old = ref.no_tf32()
    try:
        worst: Dict[str, float] = {}
        for it, pb in sorted(checks.items()):
            lens0 = host[pb][1]
            rows = checked_rows(traffic, ctx.seed, lens0)
            wav, lens = (t[rows].to(dev) for t in host[pb])
            want = decode_check.reference_encode(ref.Prec("f32"), w, cfg,
                                                 wav, lens, use_enh)
            got = {k: (tuple(_rows(t, rows, lens0) for t in v)
                       if k == "beams" else _rows(v, rows, lens0))
                   for k, v in kept[it].items()}
            toks = got["tokens"].to(dev)
            tl = got["lengths"].to(dev)
            bt, bl, bs = (t.to(dev) for t in got["beams"])
            want.update(decode_check.rescore_served(
                ref.Prec("f32"), w, cfg, want, toks, tl, bt, bl,
                traffic["beam"], lm_w, lm_cfg))
            if control is not None:
                p = ref.Prec(control)
                got = decode_check.reference_encode(p, w, cfg, wav, lens,
                                                    use_enh)
                got.update(decode_check.rescore_served(
                    p, w, cfg, got, toks, tl, bt, bl, traffic["beam"], lm_w,
                    lm_cfg))
            else:
                got = dict(got, beam_score=bs.cpu())
            for k, v in decode_check.numbers(got, want, use_enh,
                                             control is not None).items():
                worst[k] = widest(worst.get(k, 0.0), v)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    return worst
