"""Cycles in each phase of the per-utterance CTC prefix kernels.

    python -m robust_e2e_gan_torch.tools.ctc_prefix_phases [--baseline FILE]

Needs the card and nvcc. It builds ``csrc/ctc_prefix.cu`` and
``csrc/ctc_prefix_utt.cu`` into a library of its own with the ``PHASE``
marks defined as ``clock64()`` reads of thread 0, without barriers of
their own, so the state kernel's chain warp and copy warps keep
overlapping as in the library build. Thread 0 of block 0 is the state
kernel's chain thread of hypothesis 0 and the psi kernels' lane (0, 0) of
frame split 0; a phase that ends at a block barrier counts the slowest
warp's time. The kernels run through their C entry points on inputs made
as ``chip_smoke.py`` makes them, at the flagship decode's shape (B=128,
K=8, T=174, V=52; PERF.md §6 rows 3, 4 and 12), with the plans of
``ops/ctc_prefix.py``, and the tool prints the device clock's cycles of
each phase beside the marked launch's time by CUDA events. Then it times
the unmarked per-utterance psi kernel (row 12) at other chunk sizes and
stage counts than its plan's, and in turns (A, B, B, A, with the host
ahead) against row 3's ``ctc_prefix_psi_utt`` and, with ``--baseline``,
against the ``ctc_prefix_utt`` entry of another source file (e.g. an
earlier commit's ``csrc/ctc_prefix_utt.cu``, whose entry takes B, K, T,
V, blank and eos), built the same way; last, both psi kernels in turns at
T = 1,200 frames.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from robust_e2e_gan_torch.ops import ctc_prefix
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)

SHAPE = (128, 8, 174, 52)  # B, K, T, V
LONG_T = 1200  # frames of the long utterance timed through the ring
SMEM_OPTIN = 232_448
# PHASE(n) closes phase n; the state's 2 and 3, psi's 1 and 2 and utt's
# 2-4 are summed over the chunks
PHASES = {
    "state": [(0, "set-up: the hypotheses' parents and tokens"),
              (1, "stage chunk 0 (lpz rows, phi)"),
              (2, "chain (warp 0) while warps 1-7 copy"),
              (3, "wait at the chunk barrier"),
              (4, "write the last chunk")],
    "psi": [(0, "set-up"),
            (1, "stage a chunk (lpz rows, phi tables), barriers"),
            (2, "online log-sum-exp over the thread's frames"),
            (3, "combine the splits, write psi")],
    "utt": [(0, "set-up: mbarriers, first copies and loads, block barrier"),
            (1, "phi0, eos, last tokens, the consumers' barrier, table 0"),
            (2, "the next chunk's phi table, the parents two chunks on"),
            (3, "wait: the chunk's table formed, its lpz rows landed"),
            (4, "online log-sum-exp over the units' frames"),
            (5, "the pairs, the block barrier, the combine, psi")],
}

PRELUDE = r'''
__device__ unsigned long long g_cycles[3][8];
#define PHASE_BEGIN long long cyc_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long t0_ = clock64();
#define PHASE(n) if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); cyc_[n] += t1_ - t0_; t0_ = t1_; }
#define PHASE_END(kernel) if (threadIdx.x == 0 && blockIdx.x == 0) { \
  _Pragma("unroll") for (int i = 0; i < 8; ++i) g_cycles[kernel][i] = cyc_[i]; }
#include "ctc_prefix.cu"
#include "ctc_prefix_utt.cu"
extern "C" int ctc_prefix_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
'''


def _compile(name: str, source: str) -> ctypes.CDLL:
    """``source`` (C++ text) built with the library's flags into
    ``_build/<name>.so`` and loaded."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, name + ".cu")
    lib = os.path.join(BUILD_DIR, name + ".so")
    with open(cu, "w") as f:
        f.write(source)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    return ctypes.CDLL(lib)


def build() -> ctypes.CDLL:
    dll = _compile("ctc_prefix_phases", PRELUDE)
    for name in ("ctc_prefix_state_utt", "ctc_prefix_psi_utt",
                 "ctc_prefix_utt"):
        fn = getattr(dll, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    dll.ctc_prefix_cycles.argtypes = [ctypes.c_void_p]
    dll.ctc_prefix_cycles.restype = ctypes.c_int
    return dll


def build_baseline(path: str) -> ctypes.CDLL:
    """The ``ctc_prefix_utt`` entry of the source file at ``path``, with
    the earlier signature (six pointers, B, K, T, V, blank, eos,
    stream)."""
    with open(path) as f:
        dll = _compile("ctc_prefix_utt_baseline", f.read())
    dll.ctc_prefix_utt.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                   + [ctypes.c_void_p])
    dll.ctc_prefix_utt.restype = ctypes.c_int
    return dll


def ms_in_turns(calls: dict, reps: int = 20) -> dict:
    """Mean device ms per call of each of ``calls`` (name -> function
    returning the C entry's code), by CUDA events over ``reps`` calls with
    a sleep kernel holding the stream while the host enqueues them, taken
    twice in turns (A, B, ..., B, A) and averaged."""
    names = list(calls)
    out = {n: [] for n in names}
    for name in names + names[::-1]:
        fn = calls[name]
        if fn():
            sys.exit(f"{name} failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out[name].append(start.elapsed_time(end) / reps)
    return {n: sum(v) / len(v) for n, v in out.items()}


def inputs(b, k, t, v, dev):
    """Masked log-probs and parent states two tokens deep, as
    ``chip_smoke.py::ctc_inputs`` makes them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lpz = torch.log_softmax(3 * torch.randn((b, t, v), generator=gen,
                                            device=dev), -1)
    hl = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    hl[0] = t
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
    return lpz, tok, last, lens, r_n, r_b


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", help="a source file whose "
                        "ctc_prefix_utt entry is timed in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ctc_prefix_phases needs a CUDA device")
    dll = build()
    b, k, t, v = SHAPE
    dev = torch.device("cuda")
    lpz, tok, last, lens, r_n, r_b = inputs(b, k, t, v, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rn_out, rb_out = torch.empty_like(r_n), torch.empty_like(r_b)
    psi = torch.empty((b, k, v), device=dev)
    chunk = ctc_prefix.state_plan(k, t, v, SMEM_OPTIN)
    splits, psi_chunk = ctc_prefix.psi_plan(k, t, v, SMEM_OPTIN)
    u_splits, u_chunk, u_stages = ctc_prefix.utt_psi_plan(k, t, v, SMEM_OPTIN)
    psi_ptrs = (lpz.data_ptr(), last.data_ptr(), lens.data_ptr(),
                r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr())

    def utt(lib, f, ns):
        smem = ctc_prefix.utt_psi_smem(k, v, u_splits, f, ns)
        return lambda: lib.ctc_prefix_utt(*psi_ptrs, b, k, t, v, 0, 1,
                                          u_splits, f, ns, smem, stream)

    calls = {
        "state": (f"chunk {chunk} frames, "
                  f"{ctc_prefix.state_smem(k, v, chunk)} shared bytes",
                  lambda: dll.ctc_prefix_state_utt(
                      lpz.data_ptr(), None, tok.data_ptr(), None,
                      last.data_ptr(), lens.data_ptr(), r_n.data_ptr(),
                      r_b.data_ptr(), rn_out.data_ptr(), rb_out.data_ptr(),
                      b, k, t, v, 0, chunk, stream)),
        "psi": (f"{splits} frame splits, chunk {psi_chunk} frames, "
                f"{ctc_prefix.psi_smem(k, v, splits, psi_chunk)} shared "
                "bytes",
                lambda: dll.ctc_prefix_psi_utt(
                    *psi_ptrs, b, k, t, v, 0, 1, splits, psi_chunk, stream)),
        "utt": (f"{u_splits} frame splits, chunk {u_chunk} frames, "
                f"{u_stages} stages, "
                f"{ctc_prefix.utt_psi_smem(k, v, u_splits, u_chunk, u_stages)}"
                " shared bytes", utt(dll, u_chunk, u_stages)),
        "utt one chunk": (f"{u_splits} frame splits, one chunk of "
                          f"{-(-t // 4) * 4} frames",
                          utt(dll, -(-t // 4) * 4, 2)),
    }
    cycles = (ctypes.c_ulonglong * 24)()
    for name, (plan, call) in calls.items():
        index = ("state", "psi", "utt").index(name.split()[0])
        if call():
            sys.exit(f"ctc_prefix {name} failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        dll.ctc_prefix_cycles(cycles)
        row = cycles[8 * index:8 * index + 8]
        total = sum(row[n] for n, _ in PHASES[name.split()[0]])
        print(f"{name} B={b} K={k} T={t} V={v}: {plan}; marked launch "
              f"{start.elapsed_time(end):.4f} ms; block 0 {total} cycles")
        for n, label in PHASES[name.split()[0]]:
            print(f"  {n} {label}: {row[n]} ({row[n] / total:.1%})")

    # the per-utterance kernel unmarked (the library's build), at its plan
    # and at other chunks, stages and frame splits
    from robust_e2e_gan_torch.utils.build import kernels
    lib = kernels()

    def utt_at(s, f, ns):
        smem = ctc_prefix.utt_psi_smem(k, v, s, f, ns)
        return lambda: lib.ctc_prefix_utt(*psi_ptrs, b, k, t, v, 0, 1, s, f,
                                          ns, smem, stream)

    variants = {f"S={u_splits} F={f} NS={ns}": utt_at(u_splits, f, ns)
                for f in (32, 64, 96, 128, 176) for ns in (2, 3)}
    # fewer splits, at 96-frame chunks where their phi items fit
    variants.update({f"S={s} F=96 NS=2": utt_at(s, 96, 2)
                     for s in range(1, u_splits + 1)
                     if k * 96 <= ctc_prefix.UTT_AHEAD
                     * ctc_prefix.utt_consumers(k, v, s)})
    ms = ms_in_turns(variants)
    print(f"utt, unmarked, ms by frame splits S, chunk frames F and stages "
          f"NS (plan S={u_splits} F={u_chunk} NS={u_stages}): "
          + ", ".join(f"{n} {x:.4f}" for n, x in ms.items()))
    turns = {"row 12 ctc_prefix_utt": utt(lib, u_chunk, u_stages),
             "row 3 ctc_prefix_psi_utt": lambda: lib.ctc_prefix_psi_utt(
                 *psi_ptrs, b, k, t, v, 0, 1, splits, psi_chunk, stream)}
    if args.baseline:
        old = build_baseline(args.baseline)
        turns["baseline ctc_prefix_utt"] = lambda: old.ctc_prefix_utt(
            *psi_ptrs, b, k, t, v, 0, 1, stream)
    ms = ms_in_turns(turns)
    print("in turns, host ahead: "
          + ", ".join(f"{n} {x:.4f} ms" for n, x in ms.items()))

    # a long utterance through the ring, against row 3 on the same inputs
    long_t = LONG_T
    lpz, _, last, lens, r_n, r_b = inputs(b, k, long_t, v, dev)
    psi = torch.empty((b, k, v), device=dev)
    ptrs = (lpz.data_ptr(), last.data_ptr(), lens.data_ptr(),
            r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr())
    plan = ctc_prefix.utt_psi_plan(k, long_t, v, SMEM_OPTIN)
    row3 = ctc_prefix.psi_plan(k, long_t, v, SMEM_OPTIN)
    smem = ctc_prefix.utt_psi_smem(k, v, *plan)
    ms = ms_in_turns({
        "row 12 ctc_prefix_utt": lambda: lib.ctc_prefix_utt(
            *ptrs, b, k, long_t, v, 0, 1, *plan, smem, stream),
        "row 3 ctc_prefix_psi_utt": lambda: lib.ctc_prefix_psi_utt(
            *ptrs, b, k, long_t, v, 0, 1, *row3, stream)})
    print(f"T={long_t}, plan (frame splits, chunk frames, stages) {plan}, "
          "in turns, host ahead: "
          + ", ".join(f"{n} {x:.4f} ms" for n, x in ms.items()))


if __name__ == "__main__":
    main()
