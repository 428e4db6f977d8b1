"""The training cells' comparison with the plain reference.

The reference follows the program's first joint steps from the same
weights and batches: the D-step on the generator's output without a
graph, then the G-step (L_ASR + lambda_adv L_adv + mu_enh L_enh) against
the updated D, each optimizer clipping its gradient to a global norm of 5
(scaled only at or over it) and applying Adam with a linear warm-up of its
rate, with autograd for the gradients. Read, each by its worst case (the
cell's limits file names those compared):

* ``loss_rel``: each step's G loss, relative to the reference's (the D
  loss, a sum of squares of discriminator outputs near 0 and 1, cancels:
  the program's bfloat16 outputs put 3-4% on it where it is small);
* ``grad_rel``: per generator leaf, the gap between the norms of the
  program's and the reference's first (clipped) gradient, relative to
  the reference's norm of that leaf or of the median leaf, whichever is
  larger (the discriminator's whole gradient is clipped to the same
  norm on both sides, so only its change is read);
* ``grad_med_rel``: the median over the generator's leaves of the gap
  ``grad_rel`` takes the worst of (the worst is a bias that sums
  bfloat16 rounding, which the float8 control reads no higher). It would
  see a gradient scaled or summed wrong in most leaves, which Adam's first
  updates, about the rate times the gradient's sign, hide from the change
  and the losses; on the chip the control reads it under three times the
  program's largest, so no limit holds it yet;
* ``change_rel``: the same of each leaf's change over the checked steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (those under it move under Adam by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

from asr_bench.reference import model as ref


class _Adam:
    """Global-norm clip, then ``torch.optim.Adam`` at the warm-up's rate."""

    def __init__(self, params: List[torch.Tensor], ocfg: dict):
        self.params = params
        self.ocfg = ocfg
        self.opt = torch.optim.Adam(params, lr=self.lr(0))
        self.count = 0

    def lr(self, count: int) -> float:
        lr, w = self.ocfg["learning_rate"], self.ocfg.get("warmup_steps", 0)
        if w <= 0:
            return lr
        return (lr / w - lr) * (1.0 - min(count, w) / w) + lr

    def step(self, grads) -> List[torch.Tensor]:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        clip = self.ocfg.get("grad_clip", 5.0)
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        clipped = [g * scale for g in grads]
        for p, g in zip(self.params, clipped):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.count)
        self.opt.step()
        self.count += 1
        for p in self.params:
            p.grad = None
        return clipped


def reference_steps(p: ref.Prec, wg0: Dict[str, torch.Tensor],
                    wd0: Dict[str, torch.Tensor], cfg: dict, traffic: dict,
                    batches: List[dict], dev, fault: Optional[str] = None
                    ) -> dict:
    """The record of the checked steps: losses, first gradients, the
    parameters after them. ``fault``: "half" takes the first half of each
    batch's rows; "unchanged" applies no update."""
    wg = {k: v.to(dev).clone().requires_grad_(True) for k, v in wg0.items()}
    wd = {k: v.to(dev).clone().requires_grad_(True) for k, v in wd0.items()}
    names_g, names_d = list(wg), list(wd)
    ocfg = traffic["optimizer"]
    opt_g = _Adam([wg[k] for k in names_g], ocfg)
    opt_d = _Adam([wd[k] for k in names_d], ocfg)
    kind = cfg["discriminator"]["loss_type"]
    rec = {"losses": []}
    for i, bt in enumerate(batches):
        if fault == "half":
            half = bt["noisy_wav"].shape[0] // 2
            bt = {k: v[:half] for k, v in bt.items()}
        args = (bt["noisy_wav"], bt["clean_wav"], bt["wav_lengths"])
        hg, hd = p.held(wg), p.held(wd)
        with torch.no_grad():
            fixed = ref.joint_terms(p, hg, cfg, *args, with_asr=False)
        d_real = ref.discriminator(p, hd, cfg, fixed["clean_logmel"],
                                   fixed["fmask"])
        d_fake = ref.discriminator(p, hd, cfg, fixed["enhanced_logmel"],
                                   fixed["fmask"])
        loss_d, _ = ref.gan_losses(d_real, d_fake, kind)
        grads_d = torch.autograd.grad(loss_d, [wd[k] for k in names_d],
                                      allow_unused=True)
        out = ref.joint_terms(p, hg, cfg, *args, with_asr=True,
                              ys=bt["labels"].long())
        if fault != "unchanged":
            clipped_d = opt_d.step(grads_d)
        hd = p.held(wd)  # the G-step meets the updated D
        d_fake = ref.discriminator(p, hd, cfg, out["enhanced_logmel"],
                                   out["fmask"])
        d_real = ref.discriminator(p, hd, cfg, out["clean_logmel"],
                                   out["fmask"])
        _, loss_adv = ref.gan_losses(d_real, d_fake, kind)
        loss_enh = ref.enhancement_loss(out["enhanced"], out["clean"],
                                        out["fmask"], cfg["enh_loss"])
        loss_g = (out["loss_asr"] + cfg["lambda_adv"] * loss_adv
                  + cfg["mu_enh"] * loss_enh)
        grads_g = torch.autograd.grad(loss_g, [wg[k] for k in names_g],
                                      allow_unused=True)
        if fault != "unchanged":
            clipped_g = opt_g.step(grads_g)
        else:
            clipped_g = [g if g is not None else torch.zeros_like(wg[k])
                         for k, g in zip(names_g, grads_g)]
            clipped_d = [g if g is not None else torch.zeros_like(wd[k])
                         for k, g in zip(names_d, grads_d)]
        rec["losses"].append({"loss_g": float(loss_g.detach()),
                              "loss_d": float(loss_d.detach())})
        if i == 0:
            rec["grad_g"] = {k: g.detach().cpu()
                             for k, g in zip(names_g, clipped_g)}
            rec["grad_d"] = {k: g.detach().cpu()
                             for k, g in zip(names_d, clipped_d)}
    rec["params_g"] = {k: v.detach().cpu() for k, v in wg.items()}
    rec["params_d"] = {k: v.detach().cpu() for k, v in wd.items()}
    return rec


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """|‖got‖ - ‖want‖| of each leaf against the larger of that leaf's
    ‖want‖ and the median leaf's (inf for a leaf ``got`` lacks)."""
    wn = {k: float(want[k].double().norm()) for k in want}
    if not wn:
        return {}
    med = statistics.median(wn.values())
    return {k: (abs(float(got[k].double().norm()) - wn[k])
                / max(wn[k], med, 1e-30) if k in got else float("inf"))
            for k in want}


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """(the widest gap, its leaf); a NaN wins."""
    worst, name = 0.0, ""
    for k, gap in gaps.items():
        if not gap <= worst:
            worst, name = gap, k
    return worst, name


def numbers(got: dict, want: dict, wg0: dict, wd0: dict,
            detail: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared; ``detail``, when given, gets each step's
    losses on both sides and the worst leaves."""
    out = {}
    loss = 0.0
    for g, w in zip(got["losses"], want["losses"]):
        gap = abs(g["loss_g"] - w["loss_g"]) / max(abs(w["loss_g"]), 1e-30)
        loss = gap if not gap <= loss else loss
    out["loss_rel"] = loss
    gaps = _leaf_gaps(got["grad_g"], want["grad_g"])
    grads = _worst(gaps)
    out["grad_rel"] = grads[0]
    out["grad_med_rel"] = statistics.median(gaps.values())
    changes = []
    for side, w0 in (("g", wg0), ("d", wd0)):
        norms = {k: float(v.double().norm())
                 for k, v in want[f"grad_{side}"].items()}
        med = float(torch.tensor(sorted(norms.values())).median())
        moved = [k for k, n in norms.items() if n >= 1e-3 * med]
        d_got = {k: got[f"params_{side}"][k].double() - w0[k].double()
                 for k in moved if k in got[f"params_{side}"]}
        d_want = {k: want[f"params_{side}"][k].double() - w0[k].double()
                  for k in moved}
        changes.append(_worst(_leaf_gaps(d_got, d_want)))
    out["change_rel"] = max(c for c, _ in changes)
    if detail is not None:
        detail["losses"] = [[g, w] for g, w in zip(got["losses"],
                                                   want["losses"])]
        detail["grad_leaf"] = grads
        detail["change_leaf"] = max(changes)
    return out
