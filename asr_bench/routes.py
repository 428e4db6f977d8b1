"""The port's own launch counters, read to show which route each kernel
took and that no plain version ran: the wrappers' ``.launches``, the
route tallies of ``ops/*`` and the plain versions' ``.calls``.
"""

from __future__ import annotations

from typing import Dict, Optional


def _modules():
    from robust_e2e_gan_torch.ops import (
        att,
        att_dec,
        blstm,
        blstm_train,
        ctc,
        ctc_prefix,
        fbank_fused,
        lm_step,
    )
    return att, att_dec, blstm, blstm_train, ctc, ctc_prefix, fbank_fused, \
        lm_step


def read() -> Dict[str, int]:
    """Every counter, flat: ``route.<module>.<route>``, ``launch.<name>``,
    ``plain.<name>``."""
    att, att_dec, blstm, blstm_train, ctc, ctc_prefix, fbank_fused, \
        lm_step = _modules()
    out: Dict[str, int] = {}
    tallies = {
        "blstm_infer": blstm.INFER_ROUTE_LAUNCHES,
        "blstm_recurrence": blstm.GX_ROUTE_LAUNCHES,
        "blstm_train": blstm_train.ROUTE_LAUNCHES,
        "gemm": blstm_train.GEMM_ROUTE_LAUNCHES,
        "att_loc_step": att.ATT_ROUTE_LAUNCHES,
        "att_dec_step": att_dec.DEC_ROUTE_LAUNCHES,
        "ctc_prefix_psi": ctc_prefix.PREFIX_ROUTE_LAUNCHES["psi"],
        "ctc_prefix_state": ctc_prefix.PREFIX_ROUTE_LAUNCHES["state"],
        "fbank_fused": fbank_fused.FBANK_ROUTE_LAUNCHES,
        "fbank_fused_bwd": fbank_fused.FBANK_BWD_ROUTE_LAUNCHES,
        "lm_step": lm_step.LM_ROUTE_LAUNCHES,
    }
    for name, routes in tallies.items():
        for route, n in routes.items():
            out[f"route.{name}.{route}"] = int(n)
    wrappers = {
        "blstm_infer": blstm.blstm_infer,
        "blstm_recurrence": blstm.blstm_recurrence,
        "blstm_train": blstm_train.blstm_train,
        "blstm_train_gx": blstm_train.blstm_train_gx,
        "gemm": blstm_train.gemm,
        "att_loc_step": att.att_loc_step,
        "att_dec_step": att_dec.att_dec_step,
        "ctc_nll": ctc.ctc_nll,
        "ctc_alpha": ctc.ctc_alpha,
        "prefix_psi": ctc_prefix.prefix_psi,
        "prefix_psi_utt": ctc_prefix.prefix_psi_utt,
        "prefix_state_step": ctc_prefix.prefix_state_step,
        "fbank_fused": fbank_fused.fbank_fused,
        "fbank_fused_bwd": fbank_fused.fbank_fused_bwd,
        "lm_step": lm_step.lm_step,
    }
    for name, fn in wrappers.items():
        out[f"launch.{name}"] = int(fn.launches)
    plains = {
        "blstm_infer": blstm.blstm_infer_plain,
        "blstm_recurrence": blstm.blstm_recurrence_plain,
        "blstm_train": blstm_train.blstm_train_plain,
        "blstm_train_gx": blstm_train.blstm_train_gx_plain,
        "gemm": blstm_train.gemm_plain,
        "att_loc_step": att.att_loc_step_plain,
        "att_dec_step": att_dec.att_dec_step_plain,
        "ctc_nll": ctc.ctc_nll_plain,
        "ctc_alpha": ctc.ctc_alpha_fwd_plain,
        "prefix_psi": ctc_prefix.prefix_psi_recursion_plain,
        "prefix_state": ctc_prefix.prefix_state_plain,
        "fbank_fused": fbank_fused.fbank_fused_plain,
        "fbank_fused_bwd": fbank_fused.fbank_fused_bwd_plain,
        "lm_step": lm_step.lm_step_plain,
    }
    for name, fn in plains.items():
        out[f"plain.{name}"] = int(fn.calls)
    return out


def since(before: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The counters' growth since ``before`` (all of them without it),
    leaving out those that did not move."""
    now = read()
    before = before or {}
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}
