"""Driver of the training cells: the joint adversarial step (one D-step,
then the G-step against the updated D) of ``train/steps.py``.

Set-up makes the weights from the seed on the device, a pool of host
batches from the seed, one ``TrainState`` and its step, and drives that
state through its first steps on the pool's first batches (rows that all
differ): the first ``checked_steps`` are recorded for the check (each
step's losses, the first gradient as Adam's first moment holds it, the
parameters after the last), a few more warm it. The window hands the same
state on: each step copies the pool's next batch to the device and calls
the step; a CUDA event after each step dates its end on the device. The
window runs from its start to the end of the last step begun before
``--seconds`` had passed, and every step in it counts. A traced run
synchronises after each step for its span and profiles a few steps after
the window.

After the window the program's state is freed and the plain reference
(``reference/train_check.py``) follows the same first steps from the same
weights and batches.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from asr_bench import core, flops, synth, trace, weights
from asr_bench.reference import model as ref
from asr_bench.reference import train_check


def program(cfg: dict, traffic: dict, wg, wd, dev):
    """(state, step) of the port, loaded with the benchmark's weights."""
    from robust_e2e_gan_torch.config import JointConfig, TrainConfig, from_dict
    from robust_e2e_gan_torch.models.enhancement import Discriminator
    from robust_e2e_gan_torch.pipeline import build_model
    from robust_e2e_gan_torch.train.steps import (
        init_train_state,
        make_joint_train_step,
    )

    jcfg = from_dict(JointConfig, cfg)
    model = build_model(jcfg).to(dev)
    model.load_state_dict(wg)
    disc = Discriminator(jcfg.discriminator, model.dtype).to(dev)
    disc.load_state_dict(wd)
    tcfg = TrainConfig(**traffic["optimizer"])
    state = init_train_state(model, disc, tcfg, seed=0)
    return state, make_joint_train_step(jcfg)


def task(cfg: dict, traffic: dict) -> synth.SyntheticConfig:
    vocab = cfg["e2e"]["decoder"]["vocab_size"]
    if traffic["synth"].get("task") == "hard_task":
        return synth.hard_task(vocab_size=vocab)
    return synth.SyntheticConfig(vocab_size=vocab, **traffic["synth"])


def pool(cfg: dict, traffic: dict, seed: int):
    """The host batches of a run, dicts of tensors."""
    rng = np.random.default_rng(weights.seed64(seed))
    scfg = task(cfg, traffic)
    return [{k: torch.from_numpy(v) for k, v in synth.make_batch(
        traffic["batch"], scfg, rng,
        pad_to_samples=traffic.get("pad_to_samples")).items()}
        for _ in range(traffic["pool_batches"])]


def first_moment_grads(opt, named) -> Dict[str, torch.Tensor]:
    """The gradient each parameter's first Adam update took, from the
    first moment after one step (m = (1 - beta1) g)."""
    inner = opt.opt
    beta1 = inner.param_groups[0]["betas"][0]
    return {name: (inner.state[p]["exp_avg"] / (1.0 - beta1)).detach().cpu()
            for name, p in named}


def run(ctx) -> dict:
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    b = traffic["batch"]

    # ---- set-up
    ctx.mark("imported")
    wg = weights.make(weights.generator_layout(cfg), ctx.seed, dev)
    wd = weights.make(weights.discriminator_layout(cfg), ctx.seed, dev,
                      "discriminator")
    ctx.mark("weights")
    state, step = ctx.program(cfg, traffic, wg, wd, dev)
    ctx.mark("program")
    host = pool(cfg, traffic, ctx.seed)
    ctx.mark("pool")
    if on_cuda:
        host = [{k: v.pin_memory() for k, v in h.items()} for h in host]
    # the benchmark's copies, on the host while the program runs
    wg0 = {k: v.cpu() for k, v in wg.items()}
    wd0 = {k: v.cpu() for k, v in wd.items()}
    del wg, wd

    def one(i: int):
        data = {k: v.to(dev, non_blocking=True)
                for k, v in host[i % len(host)].items()}
        return step(state, data)

    routes_before = ctx.routes()
    rec = {"losses": []}
    n_check = traffic["checked_steps"]
    for i in range(n_check + traffic["warmup_steps"]):
        metrics = one(i)
        if i < n_check:
            rec["losses"].append({k: float(metrics[k])
                                  for k in ("loss_g", "loss_d")})
        if i == 0:
            rec["grad_g"] = first_moment_grads(
                state.opt_g, state.model.named_parameters())
            rec["grad_d"] = first_moment_grads(
                state.opt_d, state.discriminator.named_parameters())
        if i == 0:
            ctx.mark("first step")
        if i == n_check - 1:
            rec["params_g"] = {k: v.detach().cpu().clone() for k, v in
                               state.model.state_dict().items()}
            rec["params_d"] = {k: v.detach().cpu().clone() for k, v in
                               state.discriminator.state_dict().items()}
    sync()
    ctx.setup_done()

    # ---- the window
    i = first = n_check + traffic["warmup_steps"]
    spans, ends = [], []
    if on_cuda:
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
    start = time.perf_counter()
    deadline = start + ctx.seconds
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        one(i)
        if on_cuda:  # the step's end on the device's clock
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        else:  # a CPU step has ended when the call returns
            ends.append(time.perf_counter() - start)
        if ctx.trace:
            sync()
            spans.append((time.perf_counter() - t0) * 1e3)
        i += 1
    sync()
    if on_cuda:
        ends = [start_ev.elapsed_time(ev) * 1e-3 for ev in ends]
    # the window ends with the last step begun before the deadline
    done, window_s = len(ends), ends[-1]
    out = {"attempted": done * b, "failed": 0,
           "e2e": {"train_utt_per_s": done * b / window_s},
           "spread": core.quartiles([(b2 - a2) * 1e3 for a2, b2 in
                                zip(ends, ends[1:])])}
    if ctx.trace:
        units = traffic["profile_steps"]
        at = [i]

        def next_step():
            one(at[0])
            at[0] += 1

        prof = trace.profile(next_step, units, sync) if on_cuda else None
        del next_step
        lens = [host[(i + u) % len(host)]["wav_lengths"].tolist()
                for u in range(units)]
        model_flops = sum(flops.train_step_flops(
            host[j % len(host)]["wav_lengths"].tolist(),
            (host[j % len(host)]["labels"] >= 0).sum(dim=1).tolist(), cfg)
            for j in range(first, first + done))
        out["layer"] = {"step_ms": spans,
                        "profile": prof, "profile_lengths": lens,
                        "model_flops": model_flops, "window_s": window_s,
                        "kind": "train"}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if on_cuda else 0)
    out["routes"] = ctx.routes(routes_before)

    # ---- the check, after the program's state is freed
    del state, step, one
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    batches = [host[k] for k in range(n_check)]
    numbers = check_numbers(ctx, wg0, wd0, batches, rec)
    out["checks"] = core.limited(numbers, ctx.limits)
    out["uncompared"] = {k: v for k, v in numbers.items()
                         if k not in ctx.limits}
    return out


def check_numbers(ctx, wg0, wd0, batches, rec, control: str = None,
                  fault: str = None, detail: dict = None
                  ) -> Dict[str, float]:
    """The numbers compared: the program's record ``rec`` against the
    reference's steps from the same weights and batches. With ``control``
    (a precision) or ``fault``, the reference so run stands in the
    program's place; ``detail`` gets the losses and the worst leaves."""
    dev = ctx.device
    old = ref.no_tf32()
    try:
        on = [{k: v.to(dev) for k, v in bt.items()} for bt in batches]
        want = train_check.reference_steps(
            ref.Prec("f32"), wg0, wd0, ctx.cfg, ctx.traffic, on, dev)
        if control is not None or fault is not None:
            rec = train_check.reference_steps(
                ref.Prec(control or "f32"), wg0, wd0, ctx.cfg, ctx.traffic,
                on, dev, fault=fault)
        return train_check.numbers(rec, want, wg0, wd0, detail)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
