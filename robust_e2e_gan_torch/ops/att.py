"""One beam step of location-aware attention: kernel wrapper and plain
version.

Counterpart of ``robust_e2e_gan_tpu/ops/att_pallas.py::att_loc_fused``,
same arguments and layouts. The kernel is ``csrc/att_loc.cu``; the plain
version is the XLA beam branch of ``models/attention.py::AttLoc``
(``models/attention.py:185-192`` then ``_finish``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, on_cuda

MASK_MIN = -1e9
MAX_CHANNELS = 32  # location-conv channels a warp keeps in shared memory


def att_loc_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                       sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat (B, K, T, C), enc_proj (B, T, A), enc (B, T, E), dec (B, K, A),
    wloc (C, A), g (A,) in the compute dtype; mask (B, T) -> (ctx (B, K, E)
    f32, att (B, K, T) f32).

    Rounding points: the location projection, the two adds and the tanh
    are in the compute dtype; the score, softmax and context are float32.
    """
    att_loc_step_plain.calls += 1
    loc = feat @ wloc  # (B, K, T, A)
    pre = enc_proj[:, None] + loc + dec[:, :, None, :]
    e = (torch.tanh(pre).float() * g.float()).sum(dim=-1)
    return finish(e, mask[:, None, :], enc, sharpening)


att_loc_step_plain.calls = 0


def finish(e: torch.Tensor, m: torch.Tensor, enc: torch.Tensor,
           sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharpened masked softmax over T and the float32 context
    (``AttLoc._finish``): scores (B, K, T), mask broadcastable to them."""
    e = sharpening * e
    e = torch.where(m > 0, e, MASK_MIN)
    att = torch.softmax(e, dim=-1)
    att = att * m
    att = att / torch.clamp_min(att.sum(dim=-1, keepdim=True), 1e-8)
    ctx = torch.einsum("bkt,bte->bke", att, enc.float())
    return ctx, att


def att_loc_step(feat, enc_proj, enc, dec, wloc, g, mask,
                 sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``att_loc_step_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/att_loc.cu`` or raise.
    """
    if not on_cuda(feat, enc_proj, enc, dec, wloc, g, mask):
        return att_loc_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                                  sharpening)
    b, k, t, c = feat.shape
    a, e = enc_proj.shape[-1], enc.shape[-1]
    dt = enc.dtype
    check(dt in (torch.float32, torch.bfloat16), f"compute dtype {dt}")
    check(1 <= c <= MAX_CHANNELS, f"C={c} outside [1, {MAX_CHANNELS}]")
    expect = {"feat": (feat, (b, k, t, c)), "enc_proj": (enc_proj, (b, t, a)),
              "enc": (enc, (b, t, e)), "dec": (dec, (b, k, a)),
              "wloc": (wloc, (c, a)), "g": (g, (a,))}
    for name, (x, shape) in expect.items():
        check(tuple(x.shape) == shape,
              f"{name} shape {tuple(x.shape)} != {shape}")
        check(x.dtype == dt, f"{name} dtype {x.dtype} != {dt}")
    check(tuple(mask.shape) == (b, t), f"mask shape {tuple(mask.shape)}")
    args = [x.contiguous() for x in (feat, enc_proj, enc, dec, wloc, g)]
    maskf = mask.float().contiguous()
    ctx = torch.empty((b, k, e), dtype=torch.float32, device=enc.device)
    att = torch.empty((b, k, t), dtype=torch.float32, device=enc.device)
    launch(
        "att_loc_step", *(x.data_ptr() for x in args), maskf.data_ptr(),
        ctx.data_ptr(), att.data_ptr(), b, k, t, c, a, e, float(sharpening),
        int(dt == torch.bfloat16),
        torch.cuda.current_stream(enc.device).cuda_stream,
    )
    att_loc_step.launches += 1
    return ctx, att


att_loc_step.launches = 0
