#!/usr/bin/env python3
"""Drive the PyTorch port's serving decode once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA device must be present; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels of robust_e2e_gan_torch/csrc from the
   checkout (nvcc, sm_90a) and prints the seconds it took;
3. kernel parity: each kernel's wrapper against its plain PyTorch version
   on the card, at the shapes of the main path (B utterances of ~7 s, beam
   8, ~694 STFT frames, ~174 encoder frames, vocab 52), in float32 with
   TF32 off and in bfloat16, with the time of each;
4. main path: the flagship model in bfloat16 compute (random weights from
   seed 0) through ``make_beam_searcher(..., use_enhancer=True)`` on 3
   batches of 128 utterances; checks the results and that every kernel
   launched and no plain version ran; then times the same path with the
   plain versions;
5. slice parity: one batch of 16 at full width in float32 through the
   kernel path and the plain path; best-hypothesis scores must agree.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from robust_e2e_gan_torch.config import BeamSearchConfig
from robust_e2e_gan_torch.configs import flagship_config
from robust_e2e_gan_torch.convert import from_flax, init_params
from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
from robust_e2e_gan_torch.decode.beam import (
    beam_search_from_encoder,
    make_beam_searcher,
)
from robust_e2e_gan_torch.models.encoder import subsampled_frames
from robust_e2e_gan_torch.ops import att, blstm, ctc_prefix
from robust_e2e_gan_torch.ops.fbank import num_frames
from robust_e2e_gan_torch.pipeline import build_model
from robust_e2e_gan_torch.utils.build import build

VOCAB = 52
BATCH = 128
N_BATCHES = 3
BEAM = 8
STEPS = 48
SYNTH = SyntheticConfig(vocab_size=VOCAB, min_tokens=48, max_tokens=58)

KERNELS = {
    "blstm_recurrence": dict(
        wrapper=blstm.blstm_recurrence, plain=blstm.blstm_recurrence_plain,
        source="robust_e2e_gan_torch/csrc/blstm.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_pallas.py:332"),
    "att_loc_step": dict(
        wrapper=att.att_loc_step, plain=att.att_loc_step_plain,
        source="robust_e2e_gan_torch/csrc/att_loc.cu",
        replaces="robust_e2e_gan_tpu/ops/att_pallas.py:178"),
    "ctc_prefix_psi": dict(
        wrapper=ctc_prefix.prefix_psi,
        plain=ctc_prefix.prefix_psi_recursion_plain,
        source="robust_e2e_gan_torch/csrc/ctc_prefix.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py:116"),
    "ctc_prefix_state": dict(
        wrapper=ctc_prefix.prefix_state, plain=ctc_prefix.prefix_state_plain,
        source="robust_e2e_gan_torch/csrc/ctc_prefix.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py:237"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        k["plain"].calls = 0


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, rtol=0.0, atol=0.0, scale_atol=0.0):
    """Largest |got - want| and whether every element is within
    atol + rtol * |want| (+ scale_atol * max|want|)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        limit = atol + scale_atol * w.abs().max().item()
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        ok &= bool((diff <= limit + rtol * w.abs()).all())
    print(f"  {name}: max_abs_err {err:.3e}  limit atol {atol:g}"
          f"{f' + {scale_atol:g}*max|plain|' if scale_atol else ''}"
          f"{f' + rtol {rtol:g}*|plain|' if rtol else ''}  "
          f"{'ok' if ok else 'FAIL'}")
    return err, ok


# ---------------------------------------------------------------------------
# phase 3: kernel parity at main-path shapes
# ---------------------------------------------------------------------------


def blstm_inputs(gen, b, t, h, dtype, dev):
    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    wh = torch.randn((2, h, 4 * h), generator=gen, device=dev) / h ** 0.5
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = t
    return gx, wh.to(dtype).contiguous(), lengths


def att_inputs(gen, b, k, t, c, a, e, dtype, dev):
    def rnd(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * scale).to(dtype)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[None] < lens[:, None]).to(dtype)
    return (rnd(b, k, t, c, scale=0.05), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a, scale=0.3), rnd(a, scale=0.1), mask)


def ctc_inputs(gen, b, k, t, v, dev):
    """Masked log-probs and parent states two tokens deep, built with the
    plain version."""
    lpz = torch.log_softmax(3 * torch.randn((b, t, v), generator=gen,
                                            device=dev), -1)
    hl = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    pad = torch.full((v,), ctc_prefix.LOG_ZERO, device=dev)
    pad[0] = 0.0
    valid = torch.arange(t, device=dev)[None] < hl[:, None]
    lpz = torch.where(valid[..., None], lpz, pad).contiguous()
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for _ in range(2):
        tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        r_n, r_b = ctc_prefix.prefix_state_plain(lpz, tok, last, lens, r_n,
                                                 r_b, 0)
        last, lens = tok, lens + 1
    tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                        dtype=torch.int32)
    tok[:, 0] = last[:, 0]  # repeated tokens take the r_b branch
    return lpz, tok, last, lens, r_n, r_b


def kernel_parity(b: int, t_enh: int, t_enc: int, jcfg, dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    acfg = jcfg.e2e.attention
    h_enh, h_enc = jcfg.enhancer.hidden_dim, jcfg.e2e.encoder.hidden_dim
    e_dim = jcfg.e2e.encoder.proj_dim
    f32, bf16 = torch.float32, torch.bfloat16
    res = {}
    ok_all = True

    # BLSTM recurrence: enhancer and encoder layer shapes
    for tag, t, h in (("enhancer", t_enh, h_enh), ("encoder", t_enc, h_enc)):
        for dt in (f32, bf16):
            gx, wh, lengths = blstm_inputs(gen, b, t, h, dt, dev)
            got = blstm.blstm_recurrence(gx, wh, lengths)
            want = blstm.blstm_recurrence_plain(gx, wh, lengths)
            tol = dict(rtol=1e-4, atol=1e-5) if dt == f32 else dict(
                scale_atol=2e-2)
            err, ok = compare(f"blstm_recurrence {tag} T={t} H={h} {dt}",
                              [got], [want], **tol)
            ok_all &= ok
            if tag == "enhancer" and dt == bf16:
                res["blstm_recurrence"] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: blstm.blstm_recurrence(
                        gx, wh, lengths), 5),
                    plain_ms=cuda_ms(lambda: blstm.blstm_recurrence_plain(
                        gx, wh, lengths), 2))
            print(f"    (B={b} valid frames {int(lengths.sum())})")

    # attention step
    for dt in (f32, bf16):
        args = att_inputs(gen, b, BEAM, t_enc, acfg.conv_channels, acfg.dim,
                          e_dim, dt, dev)
        got = att.att_loc_step(*args, acfg.sharpening)
        want = att.att_loc_step_plain(*args, acfg.sharpening)
        tol = (dict(rtol=1e-4, atol=1e-5) if dt == f32
               else dict(scale_atol=2e-2))
        err, ok = compare(f"att_loc_step B={b} K={BEAM} T={t_enc} {dt}",
                          got, want, **tol)
        ok_all &= ok
        if dt == bf16:
            sharp = acfg.sharpening
            res["att_loc_step"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: att.att_loc_step(*args, sharp), 20),
                plain_ms=cuda_ms(
                    lambda: att.att_loc_step_plain(*args, sharp), 20))

    # CTC prefix psi and state (float32 only, as in the JAX package)
    lpz, tok, last, lens, r_n, r_b = ctc_inputs(gen, b, BEAM, t_enc, VOCAB,
                                                dev)

    def psi_kernel():
        return ctc_prefix.prefix_psi(lpz, last, lens, r_n, r_b, 0, 1)

    def psi_plain():
        return ctc_prefix.prefix_psi_plain(lpz, last, lens, r_n, r_b, 0, 1)

    err, ok = compare(f"ctc_prefix_psi B={b} K={BEAM} T={t_enc} V={VOCAB}",
                      [psi_kernel()], [psi_plain()], atol=1e-3)
    ok_all &= ok
    res["ctc_prefix_psi"] = dict(max_abs_err=err, ms=cuda_ms(psi_kernel, 20),
                                 plain_ms=cuda_ms(psi_plain, 5))

    def state_kernel():
        return ctc_prefix.prefix_state(lpz, tok, last, lens, r_n, r_b, 0)

    def state_plain():
        return ctc_prefix.prefix_state_plain(lpz, tok, last, lens, r_n, r_b, 0)

    err, ok = compare(f"ctc_prefix_state B={b} K={BEAM} T={t_enc}",
                      state_kernel(), state_plain(), atol=1e-3)
    ok_all &= ok
    res["ctc_prefix_state"] = dict(max_abs_err=err,
                                   ms=cuda_ms(state_kernel, 20),
                                   plain_ms=cuda_ms(state_plain, 5))
    require(ok_all, "a kernel disagrees with its plain version")
    return res


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------


def with_impls(jcfg, lstm: str, score: str, dtype: str):
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg, compute_dtype=dtype,
        e2e=dataclasses.replace(
            e2e,
            encoder=dataclasses.replace(e2e.encoder, lstm_impl=lstm),
            attention=dataclasses.replace(e2e.attention, score_impl=score)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl=lstm),
    )


def load(jcfg, state, dev):
    model = build_model(jcfg)
    model.load_state_dict(state)
    return model.to(dev).eval()


def batch_tensors(b, seed, dev):
    data = make_batch(b, SYNTH, np.random.default_rng(seed))
    return (torch.from_numpy(data["noisy_wav"]).to(dev),
            torch.from_numpy(data["wav_lengths"]).to(dev))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_result(res, b):
    require(res.scores.shape == (b,) and res.tokens.shape == (b, STEPS),
            f"result shapes {tuple(res.scores.shape)} "
            f"{tuple(res.tokens.shape)}")
    require(bool(torch.isfinite(res.scores).all()), "non-finite beam scores")
    require(bool(((res.lengths >= 0) & (res.lengths <= STEPS)).all()),
            "hypothesis lengths outside [0, max_steps]")


def split_ms(model, jcfg, bcfg, wav, lens):
    """(encode ms, search ms) of one batch, each ending in a synchronize."""
    with torch.inference_mode():
        enc, enc_ms = timed(lambda: model.encode_for_decode(wav, lens, True))
        hs, hmask, hlens, ctc_logits, enc_proj = enc
        _, search_ms = timed(lambda: beam_search_from_encoder(
            model.decoder_step, model.decoder_initial_carry, hs, hmask, hlens,
            enc_proj, ctc_logits, jcfg.e2e, bcfg))
    return enc_ms, search_ms


def mean(xs):
    return sum(xs) / len(xs)


def main_path(b, n_batches, state, dev):
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    kcfg = with_impls(flagship_config(VOCAB), "auto", "auto", "bfloat16")
    model = load(kcfg, state, dev)
    searcher = make_beam_searcher(model, kcfg.e2e, bcfg, use_enhancer=True)
    batches = [batch_tensors(b, seed, dev) for seed in range(n_batches)]
    print(f"  batch: B={b} samples={batches[0][0].shape[1]} "
          f"mean length {batches[0][1].float().mean().item() / 16000:.2f} s")

    reset_counts()
    first = []
    for wav, lens in batches:
        res, ms = timed(lambda: searcher(wav, lens))
        check_result(res, b)
        first.append(ms)
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    plain_calls = {n: k["plain"].calls for n, k in KERNELS.items()}
    print(f"  kernel path, first pass: ms per batch "
          f"{['%.1f' % x for x in first]} (the first includes warm-up)")
    print(f"  launches {launches}  plain calls {plain_calls}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on the main path: {plain_calls}")

    def steady(search, model_, cfg, bc):
        """Warm per-batch ms of the whole search, then its two halves."""
        whole = [timed(lambda: search(w, n))[1] for w, n in batches]
        halves = [split_ms(model_, cfg, bc, w, n) for w, n in batches]
        print(f"  warm ms per batch {['%.1f' % x for x in whole]}")
        return (mean(whole), mean([h[0] for h in halves]),
                mean([h[1] for h in halves]))

    k_ms, k_enc, k_search = steady(searcher, model, kcfg, bcfg)
    print(f"  kernel path: {b * 1e3 / k_ms:.2f} utt/s, {k_ms:.1f} ms/batch "
          f"(encode {k_enc:.1f} ms + search {k_search:.1f} ms when timed "
          f"apart; means over {n_batches} warm batches)")

    pcfg = with_impls(kcfg, "scan", "xla", "bfloat16")
    plain_model = load(pcfg, state, dev)
    pbcfg = dataclasses.replace(bcfg, prefix_impl="twopass")
    plain_search = make_beam_searcher(plain_model, pcfg.e2e, pbcfg)
    check_result(plain_search(*batches[0]), b)  # warm-up
    p_ms, p_enc, p_search = steady(plain_search, plain_model, pcfg, pbcfg)
    print(f"  plain path: {b * 1e3 / p_ms:.2f} utt/s, {p_ms:.1f} ms/batch "
          f"(encode {p_enc:.1f} ms + search {p_search:.1f} ms)")
    return launches


def slice_parity(state, dev):
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    base = flagship_config(VOCAB)
    wav, lens = batch_tensors(16, 100, dev)
    out = {}
    for tag, lstm_impl, score, prefix in (("kernel", "auto", "auto", "auto"),
                                          ("plain", "scan", "xla", "twopass")):
        cfg = with_impls(base, lstm_impl, score, "float32")
        model = load(cfg, state, dev)
        search = make_beam_searcher(
            model, cfg.e2e, dataclasses.replace(bcfg, prefix_impl=prefix))
        out[tag] = search(wav, lens)
        check_result(out[tag], 16)
    k, p = out["kernel"], out["plain"]
    rel = ((k.scores - p.scores).abs() / p.scores.abs().clamp_min(1e-6)).max()
    same = sum(bool(torch.equal(a, c)) for a, c in zip(k.tokens, p.tokens))
    print(f"  float32 B=16: best-score max rel diff {rel.item():.3e} "
          f"(limit 1e-3); best hypotheses token-identical {same}/16")
    require(rel.item() <= 1e-3, "kernel and plain paths disagree on scores")


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip() != "",
            f"nvidia-smi failed: {smi.stdout}")
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    print(f"build: {build():.1f} s")

    jcfg = flagship_config(VOCAB)
    # make_batch pads every batch to SYNTH.max_samples
    t_enh = num_frames(SYNTH.max_samples, jcfg.e2e.frontend)
    t_enc = subsampled_frames(t_enh)

    # 3. kernel parity
    print("kernel parity (kernel vs plain version on the card):")
    timings = kernel_parity(BATCH, t_enh, t_enc, jcfg, dev)

    # 4. main path
    state = from_flax(init_params(jcfg, seed=0))
    print("main path (flagship, bfloat16 compute, beam 8, 48 steps):")
    launches = main_path(BATCH, N_BATCHES, state, dev)

    # 5. slice parity
    print("slice parity (kernel path vs plain path):")
    slice_parity(state, dev)

    kernels = [
        dict(name=n, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launches[n], **timings[n])
        for n, k in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
