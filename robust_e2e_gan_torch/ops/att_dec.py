"""The whole beam step of the attention decoder: kernel wrapper and plain
version.

Counterpart of ``robust_e2e_gan_tpu/ops/att_pallas.py::att_dec_step_fused``,
same arguments: location-aware attention (as ``ops/att.py``), then the
token embedding, the single-layer LSTM cell and the vocabulary readout, in
one launch (``csrc/att_dec.cu``). The rounding points are the TPU
kernel's (``att_pallas.py:341-388``), which differ from the unfused step's
in bfloat16: the context is rounded to the compute dtype, the embedding
rows are exact, ``gx = emb @ Wx[:EMB] + ctx @ Wx[EMB:]`` and
``gh = T(z) @ Wh`` are products of compute-dtype operands with float32
sums, the gates plus bias are float32 in the order i, f, g, o, and
``logits = T(z') @ Wout[:H] + ctx @ Wout[H:] + b``, where the unfused cell
promotes ``Wh`` to float32 against the float32 state instead. In float32
the two compute the same values.

The JAX package falls back to the attention kernel and the XLA cell where
the fused step does not fit its VMEM plan; the wrapper here raises beyond
the kernel's shared-memory plan instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from robust_e2e_gan_torch.models.layers import mm_f32
from robust_e2e_gan_torch.ops.att import MAX_CHANNELS, location_attention
from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    SMEM_LIMIT,
    check,
    check_no_grad,
    on_cuda,
)

MAX_HIDDEN = 1024  # one thread per hidden unit in a block
ROWS = 8  # lanes per pass of the cell (csrc/att_dec.cu)

Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def att_dec_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                       sharpening: float, tok, emb_table, cell_wx, cell_wh,
                       cell_bias, out_w, out_b, z_prev, c_prev) -> Step:
    """feat (B, K, T, C), enc_proj (B, T, A), enc (B, T, E), dec (B, K, A),
    wloc (C, A), g (A,), emb_table (V, EMB), cell_wx (EMB + E, 4H),
    cell_wh (H, 4H), out_w (H + E, V) in the compute dtype; mask (B, T);
    tok (B, K) token ids, already >= 0; cell_bias (4H,), out_b (V,),
    z_prev, c_prev (B, K, H) float32.

    Returns (logits (B, K, V), att (B, K, T), z_new, c_new (B, K, H)), all
    float32.
    """
    att_dec_step_plain.calls += 1
    b, k = tok.shape
    n = b * k
    dt = enc.dtype
    embd, h = emb_table.shape[1], cell_wh.shape[0]
    ctx, att = location_attention(feat, enc_proj, enc, dec, wloc, g, mask,
                                  sharpening)
    ctxc = ctx.to(dt).reshape(n, -1)
    emb = emb_table[tok.reshape(n).long()]  # exact table rows
    gx = mm_f32(emb, cell_wx[:embd]) + mm_f32(ctxc, cell_wx[embd:])
    gh = mm_f32(z_prev.reshape(n, h).to(dt), cell_wh)
    gates = (gx + gh) + cell_bias.float()
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c_new = (torch.sigmoid(gf) * c_prev.reshape(n, h).float()
             + torch.sigmoid(gi) * torch.tanh(gg))
    z_new = torch.sigmoid(go) * torch.tanh(c_new)
    logits = (mm_f32(z_new.to(dt), out_w[:h]) + mm_f32(ctxc, out_w[h:])
              + out_b.float())
    return (logits.reshape(b, k, -1), att, z_new.reshape(b, k, h),
            c_new.reshape(b, k, h))


att_dec_step_plain.calls = 0


def smem_bytes(k: int, t: int, c: int, a: int, e: int, embd: int,
               h: int) -> int:
    """Shared memory of one block of ``csrc/att_dec.cu``."""
    ks = max(1, min(4, MAX_HIDDEN // h))
    warps = -(-ks * h // 32)
    return 4 * (c * a + 2 * a + t + warps * MAX_CHANNELS + 32
                + k * (embd + e) + k * h + (ks - 1) * ROWS * 4 * h)


def att_dec_step(feat, enc_proj, enc, dec, wloc, g, mask, sharpening: float,
                 tok, emb_table, cell_wx, cell_wh, cell_bias, out_w, out_b,
                 z_prev, c_prev) -> Step:
    """Kernel wrapper, same contract as ``att_dec_step_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/att_dec.cu`` or raise. Inference only: it raises under autograd.
    """
    floats = (feat, enc_proj, enc, dec, wloc, g, mask, emb_table, cell_wx,
              cell_wh, cell_bias, out_w, out_b, z_prev, c_prev)
    check_no_grad("att_dec_step", *floats)
    if not on_cuda(tok, *floats):
        return att_dec_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                                  sharpening, tok, emb_table, cell_wx,
                                  cell_wh, cell_bias, out_w, out_b, z_prev,
                                  c_prev)
    b, k, t, c = feat.shape
    a, e = enc_proj.shape[-1], enc.shape[-1]
    v, embd = emb_table.shape
    h = cell_wh.shape[0]
    dt = enc.dtype
    check(dt in (torch.float32, torch.bfloat16), f"compute dtype {dt}")
    check(1 <= c <= MAX_CHANNELS, f"C={c} outside [1, {MAX_CHANNELS}]")
    check(1 <= h <= MAX_HIDDEN, f"H={h} outside [1, {MAX_HIDDEN}]")
    typed = {"feat": (feat, (b, k, t, c)), "enc_proj": (enc_proj, (b, t, a)),
             "enc": (enc, (b, t, e)), "dec": (dec, (b, k, a)),
             "wloc": (wloc, (c, a)), "g": (g, (a,)),
             "emb_table": (emb_table, (v, embd)),
             "cell_wx": (cell_wx, (embd + e, 4 * h)),
             "cell_wh": (cell_wh, (h, 4 * h)), "out_w": (out_w, (h + e, v))}
    for name, (x, shape) in typed.items():
        check(tuple(x.shape) == shape,
              f"{name} shape {tuple(x.shape)} != {shape}")
        check(x.dtype == dt, f"{name} dtype {x.dtype} != {dt}")
    for name, x, shape in (("mask", mask, (b, t)), ("tok", tok, (b, k)),
                           ("cell_bias", cell_bias, (4 * h,)),
                           ("out_b", out_b, (v,)),
                           ("z_prev", z_prev, (b, k, h)),
                           ("c_prev", c_prev, (b, k, h))):
        check(tuple(x.shape) == shape,
              f"{name} shape {tuple(x.shape)} != {shape}")
    need = smem_bytes(k, t, c, a, e, embd, h)
    check(need <= SMEM_LIMIT,
          f"K={k}, T={t}, EMB+E={embd + e}, H={h} need {need} bytes of "
          f"shared memory, more than a block's {SMEM_LIMIT}")
    ins = [x.contiguous() for x in (feat, enc_proj, enc, dec, wloc, g)]
    ins.append(mask.float().contiguous())
    ins.append(tok.to(torch.int32).contiguous())
    ins += [x.contiguous() for x in (emb_table, cell_wx, cell_wh)]
    ins.append(cell_bias.float().contiguous())
    ins.append(out_w.contiguous())
    ins += [x.float().contiguous() for x in (out_b, z_prev, c_prev)]
    dev = enc.device
    logits = torch.empty((b, k, v), dtype=torch.float32, device=dev)
    att = torch.empty((b, k, t), dtype=torch.float32, device=dev)
    z_new = torch.empty((b, k, h), dtype=torch.float32, device=dev)
    c_new = torch.empty_like(z_new)
    launch(
        "att_dec_step", *(x.data_ptr() for x in ins), logits.data_ptr(),
        att.data_ptr(), z_new.data_ptr(), c_new.data_ptr(), b, k, t, c, a, e,
        v, embd, h, float(sharpening), int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    att_dec_step.launches += 1
    return logits, att, z_new, c_new


att_dec_step.launches = 0
