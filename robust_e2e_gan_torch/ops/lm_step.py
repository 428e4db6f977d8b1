"""RNNLM beam step (shallow fusion): the kernel's wrapper and its plain
PyTorch version.

Counterpart of ``robust_e2e_gan_tpu/ops/lm_step_pallas.py::lm_step_fused``:
embedding row, L stacked LSTM cells and the vocabulary readout of N
hypothesis lanes in one launch (``csrc/lm_step.cu``). Numerics are the TPU
kernel's: float32 carries and sums, ``h`` rounded to the compute dtype for
the recurrent product, each layer's output rounded to the compute dtype as
the next input, float32 logits. There is no fit rule: the kernel streams
the weights from device memory and takes any V, E and L; H is bounded by
the threads of one block.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from robust_e2e_gan_torch.models.layers import mm_f32
from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    SMEM_LIMIT,
    check,
    check_no_grad,
    on_cuda,
)

MAX_HIDDEN = 1024  # one thread per hidden unit in a block
ROWS = 8  # lanes per block (csrc/lm_step.cu)


def lm_step_plain(tok: torch.Tensor, emb: torch.Tensor,
                  wxs: Sequence[torch.Tensor], whs: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], out_w: torch.Tensor,
                  out_b: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LM step on token ids ``tok`` (N,), already >= 0.

    emb (V, E); wxs[0] (E, 4H), deeper layers (H, 4H); whs (H, 4H);
    biases (4H,); out_w (H, V); out_b (V,); h, c (L, N, H) float32.
    Returns (h_new, c_new (L, N, H) float32, logits (N, V) float32).
    """
    lm_step_plain.calls += 1
    inp = emb.to(dtype)[tok.long()]
    hs, cs = [], []
    for li, (wx, wh, b) in enumerate(zip(wxs, whs, biases)):
        gates = (mm_f32(inp, wx.to(dtype))
                 + mm_f32(h[li].to(dtype), wh.to(dtype)) + b.float())
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c[li] + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new.to(dtype)
    logits = mm_f32(inp, out_w.to(dtype)) + out_b.float()
    return torch.stack(hs), torch.stack(cs), logits


lm_step_plain.calls = 0


def smem_bytes(e: int, h: int) -> int:
    """Shared memory of one block of ``csrc/lm_step.cu``."""
    ks = max(1, min(4, MAX_HIDDEN // h))
    return 4 * (ROWS * (max(e, h) + h) + (ks - 1) * ROWS * 4 * h)


def lm_step(tok: torch.Tensor, emb: torch.Tensor,
            wxs: Sequence[torch.Tensor], whs: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], out_w: torch.Tensor,
            out_b: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
            dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``lm_step_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/lm_step.cu`` or raise. Inference only: it raises under autograd.
    """
    check_no_grad("lm_step", emb, *wxs, *whs, *biases, out_w, out_b, h, c)
    if not on_cuda(tok, emb, out_w, h, c):
        return lm_step_plain(tok, emb, wxs, whs, biases, out_w, out_b, h, c,
                             dtype)
    layers, n, h_dim = h.shape
    v, e = emb.shape
    check(dtype in (torch.float32, torch.bfloat16), f"dtype {dtype}")
    check(len(wxs) == len(whs) == len(biases) == layers,
          f"{len(wxs)} layers of weights for a state of {layers}")
    check(tok.shape == (n,), f"tok shape {tuple(tok.shape)} for N={n}")
    check(c.shape == h.shape, f"c shape {tuple(c.shape)}")
    check(wxs[0].shape == (e, 4 * h_dim), f"wx0 shape {tuple(wxs[0].shape)}")
    check(all(w.shape == (h_dim, 4 * h_dim) for w in (*wxs[1:], *whs)),
          "deeper wx and every wh must be (H, 4H)")
    check(out_w.shape == (h_dim, v) and out_b.shape == (v,),
          f"readout shapes {tuple(out_w.shape)} {tuple(out_b.shape)}")
    check(1 <= h_dim <= MAX_HIDDEN, f"H={h_dim} outside [1, {MAX_HIDDEN}]")
    check(smem_bytes(e, h_dim) <= SMEM_LIMIT,
          f"E={e}, H={h_dim} need {smem_bytes(e, h_dim)} bytes of shared "
          f"memory, more than a block's {SMEM_LIMIT}")

    def cast(w):
        return w.to(dtype).contiguous()

    wx0 = cast(wxs[0])
    wx_rest = (torch.stack([cast(w) for w in wxs[1:]]) if layers > 1
               else wx0)  # not read for one layer
    wh = (cast(whs[0]) if layers == 1
          else torch.stack([cast(w) for w in whs]))
    bias = (biases[0].float().contiguous() if layers == 1
            else torch.stack([b.float() for b in biases]))
    emb_c, out_w_c = cast(emb), cast(out_w)
    out_b_c = out_b.float().contiguous()
    h_in, c_in = h.float().contiguous(), c.float().contiguous()
    tok_c = tok.to(torch.int32).contiguous()
    h_out, c_out = torch.empty_like(h_in), torch.empty_like(c_in)
    logits = torch.empty((n, v), dtype=torch.float32, device=h.device)
    launch(
        "lm_step", tok_c.data_ptr(), emb_c.data_ptr(), wx0.data_ptr(),
        wx_rest.data_ptr(), wh.data_ptr(), bias.data_ptr(), out_w_c.data_ptr(),
        out_b_c.data_ptr(), h_in.data_ptr(), c_in.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), logits.data_ptr(), n, v, e, h_dim, layers,
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    lm_step.launches += 1
    return h_out, c_out, logits


lm_step.launches = 0
