"""CTC prefix scores of the beam search: kernel wrappers and plain versions.

Counterparts of ``robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py``
(``prefix_psi_tiled``, ``prefix_state_tiled``) and of
``ops/ctc_prefix_pallas.py::prefix_scores_psi_pallas`` (``prefix_psi_utt``),
same contracts. The plain versions are the JAX package's twopass forms,
``decode/beam.py::batched_prefix_psi`` and ``prefix_state_for_token``,
with the frame loop written out. The kernels are ``csrc/ctc_prefix.cu``
and ``csrc/ctc_prefix_utt.cu``. Everything is float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    SMEM_LIMIT,
    check,
    check_no_grad,
    on_cuda,
)

LOG_ZERO = -1e10
UTT_THREADS = 1024  # one thread per (k, v) lane in ctc_prefix_utt's block


def _phi_prev(r_n, r_b, is_last, lengths):
    """(B, K, T[, V]) transition scores into frame t from the parent:
    phi0 at t=0, then r_b[t-1] where the token repeats the last one, else
    logaddexp(r_n, r_b)[t-1]."""
    r_sum = torch.logaddexp(r_n, r_b)
    if is_last.dim() == 3:  # (B, K, V): one lane per vocab extension
        log_phi = torch.where(is_last[:, :, None, :], r_b[..., None],
                              r_sum[..., None])
    else:
        log_phi = torch.where(is_last[..., None], r_b, r_sum)
    phi0 = torch.where(lengths == 0, 0.0, LOG_ZERO).to(r_n.dtype)
    phi0 = phi0.view(phi0.shape + (1,) * (log_phi.dim() - 2))
    phi0 = phi0.expand(log_phi[:, :, :1].shape)
    return torch.cat([phi0, log_phi[:, :, :-1]], dim=2)


def _patch_psi(psi, r_n, r_b, blank: int, eos: int):
    """eos candidate = full-sequence CTC score of the prefix itself; blank
    is never a label."""
    psi[..., eos] = torch.logaddexp(r_n[:, :, -1], r_b[:, :, -1])
    psi[..., blank] = LOG_ZERO
    return psi


def prefix_psi_recursion_plain(lpz, last_tok, lengths, r_n, r_b):
    """psi (B, K, V) of every vocab extension, before the eos/blank
    patches: the frame loop of ``batched_prefix_psi``.

    lpz (B, T, V) masked CTC log-probs; last_tok, lengths (B, K); r_n, r_b
    (B, K, T) forward variables of the current prefixes.
    """
    prefix_psi_recursion_plain.calls += 1
    b, t, v = lpz.shape
    k = last_tok.shape[1]
    vocab = torch.arange(v, device=lpz.device)
    is_last = ((vocab[None, None, :] == last_tok[..., None])
               & (lengths[..., None] > 0))
    phi = _phi_prev(r_n, r_b, is_last, lengths)  # (B, K, T, V)
    psi = torch.full((b, k, v), LOG_ZERO, device=lpz.device)
    for i in range(t):
        psi = torch.logaddexp(psi, phi[:, :, i] + lpz[:, None, i])
    return psi


prefix_psi_recursion_plain.calls = 0


def prefix_psi_plain(lpz, last_tok, lengths, r_n, r_b, blank: int,
                     eos: int) -> torch.Tensor:
    """psi (B, K, V) with the eos/blank columns set
    (``batched_prefix_psi``)."""
    psi = prefix_psi_recursion_plain(lpz, last_tok, lengths, r_n, r_b)
    return _patch_psi(psi, r_n, r_b, blank, eos)


def prefix_state_plain(lpz, tok, last_tok, lengths, r_n, r_b,
                       blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_n, r_b) (B, K, T) of the parents extended by ``tok``
    (``prefix_state_for_token``); last_tok/lengths/r_n/r_b describe the
    parents."""
    prefix_state_plain.calls += 1
    t = lpz.shape[1]
    is_last = (tok == last_tok) & (lengths > 0)
    phi = _phi_prev(r_n, r_b, is_last, lengths)  # (B, K, T)
    # lpz at the chosen tokens: (B, T, K) -> (B, K, T)
    x_tok = torch.gather(lpz, 2, tok.long()[:, None, :].expand(-1, t, -1))
    x_tok = x_tok.transpose(1, 2)
    x_blank = lpz[:, :, blank]  # (B, T)
    rn = torch.full(tok.shape, LOG_ZERO, device=lpz.device)
    rb = torch.full(tok.shape, LOG_ZERO, device=lpz.device)
    rns, rbs = [], []
    for i in range(t):
        rn_new = x_tok[:, :, i] + torch.logaddexp(rn, phi[:, :, i])
        rb = x_blank[:, i, None] + torch.logaddexp(rn, rb)
        rn = rn_new
        rns.append(rn)
        rbs.append(rb)
    return torch.stack(rns, dim=2), torch.stack(rbs, dim=2)


prefix_state_plain.calls = 0


def _check_common(lpz, r_n, r_b, ints):
    b, t, v = lpz.shape
    k = r_n.shape[1]
    check(lpz.dtype == torch.float32, f"lpz dtype {lpz.dtype}")
    for name, x in (("r_n", r_n), ("r_b", r_b)):
        check(tuple(x.shape) == (b, k, t) and x.dtype == torch.float32,
              f"{name} must be (B, K, T) float32, got {tuple(x.shape)} "
              f"{x.dtype}")
    for name, x in ints.items():
        check(tuple(x.shape) == (b, k), f"{name} shape {tuple(x.shape)}")
    return b, k, t, v


def prefix_psi(lpz, last_tok, lengths, r_n, r_b, blank: int,
               eos: int) -> torch.Tensor:
    """Kernel wrapper, same contract as ``prefix_psi_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/ctc_prefix.cu::ctc_prefix_psi`` or raise.
    """
    check_no_grad("prefix_psi", lpz, r_n, r_b)
    if not on_cuda(lpz, last_tok, lengths, r_n, r_b):
        return prefix_psi_plain(lpz, last_tok, lengths, r_n, r_b, blank, eos)
    b, k, t, v = _check_common(lpz, r_n, r_b,
                               {"last_tok": last_tok, "lengths": lengths})
    lpz, r_n, r_b = lpz.contiguous(), r_n.contiguous(), r_b.contiguous()
    last_tok = last_tok.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    psi = torch.empty((b, k, v), dtype=torch.float32, device=lpz.device)
    launch(
        "ctc_prefix_psi", lpz.data_ptr(), last_tok.data_ptr(),
        lengths.data_ptr(), r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr(),
        b, k, t, v, torch.cuda.current_stream(lpz.device).cuda_stream,
    )
    prefix_psi.launches += 1
    return _patch_psi(psi, r_n, r_b, blank, eos)


prefix_psi.launches = 0


def prefix_psi_utt(lpz, last_tok, lengths, r_n, r_b, blank: int,
                   eos: int) -> torch.Tensor:
    """The per-utterance kernel's wrapper: the contract of
    ``robust_e2e_gan_tpu/ops/ctc_prefix_pallas.py::prefix_scores_psi_pallas``,
    which is ``prefix_psi``'s, so its plain version is ``prefix_psi_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/ctc_prefix_utt.cu`` (one block per utterance, the eos and blank
    columns set in the kernel) or raise.
    """
    check_no_grad("prefix_psi_utt", lpz, r_n, r_b)
    if not on_cuda(lpz, last_tok, lengths, r_n, r_b):
        return prefix_psi_plain(lpz, last_tok, lengths, r_n, r_b, blank, eos)
    b, k, t, v = _check_common(lpz, r_n, r_b,
                               {"last_tok": last_tok, "lengths": lengths})
    check(k * v <= UTT_THREADS,
          f"K*V={k * v} lanes, more than a block's {UTT_THREADS} threads")
    need = 4 * (t * v + 2 * k * t)
    check(need <= SMEM_LIMIT,
          f"T={t}, V={v}, K={k} stage {need} bytes, more than a block's "
          f"{SMEM_LIMIT} of shared memory")
    lpz, r_n, r_b = lpz.contiguous(), r_n.contiguous(), r_b.contiguous()
    last_tok = last_tok.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    psi = torch.empty((b, k, v), dtype=torch.float32, device=lpz.device)
    launch(
        "ctc_prefix_utt", lpz.data_ptr(), last_tok.data_ptr(),
        lengths.data_ptr(), r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr(),
        b, k, t, v, blank, eos,
        torch.cuda.current_stream(lpz.device).cuda_stream,
    )
    prefix_psi_utt.launches += 1
    return psi


prefix_psi_utt.launches = 0


def prefix_state(lpz, tok, last_tok, lengths, r_n, r_b,
                 blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``prefix_state_plain`` (``tok``
    must lie in [0, V)).

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/ctc_prefix.cu::ctc_prefix_state`` or raise.
    """
    check_no_grad("prefix_state", lpz, r_n, r_b)
    if not on_cuda(lpz, tok, last_tok, lengths, r_n, r_b):
        return prefix_state_plain(lpz, tok, last_tok, lengths, r_n, r_b, blank)
    b, k, t, v = _check_common(
        lpz, r_n, r_b, {"tok": tok, "last_tok": last_tok, "lengths": lengths})
    check(0 <= blank < v, f"blank={blank} outside [0, {v})")
    lpz, r_n, r_b = lpz.contiguous(), r_n.contiguous(), r_b.contiguous()
    tok, last_tok, lengths = (x.to(torch.int32).contiguous()
                              for x in (tok, last_tok, lengths))
    rn_out = torch.empty((b, k, t), dtype=torch.float32, device=lpz.device)
    rb_out = torch.empty_like(rn_out)
    launch(
        "ctc_prefix_state", lpz.data_ptr(), tok.data_ptr(),
        last_tok.data_ptr(), lengths.data_ptr(), r_n.data_ptr(),
        r_b.data_ptr(), rn_out.data_ptr(), rb_out.data_ptr(), b, k, t, v,
        blank, torch.cuda.current_stream(lpz.device).cuda_stream,
    )
    prefix_state.launches += 1
    return rn_out, rb_out


prefix_state.launches = 0
