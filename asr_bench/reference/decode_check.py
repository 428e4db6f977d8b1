"""The decode cells' comparison with the plain reference.

The reference works out again, from the benchmark's own waveforms and
weights, what the timed searcher produced for the checked utterances: the
enhancer's mask logits (before the sigmoid), the encoder's input
features, the encoder's outputs, the CTC logits, and the joint scores of
the served best hypothesis and of the K final ones. The searcher's score
of a hypothesis telescopes to

    (1 - ctc_weight) * sum log p_att(y_i | y_<i)  (y_{L+1} = eos)
    + ctc_weight * log p_ctc(y) + lm_weight * sum log p_lm(y_i | y_<i)
    + penalty * (L + 1),

so the reference rescores the served tokens, and each of the searcher's K
final hypotheses, by teacher forcing, with the CTC likelihood from
``F.ctc_loss`` in float64. Each number is the widest gap over the checked
utterances, but ``margin_mean_rel``. The margins hold the K hypotheses'
scores against the served one's, as the searcher and the reference each
give them: a rounding of the weights shifts every hypothesis of an
utterance alike, so the margins keep what the precision does to the
search and drop what it does to all of them (``score_rel``, the served
score's own gap, is such a shift under random weights). ``margin_rel`` is
the widest margin gap, ``margin_mean_rel`` the mean over utterances of
each one's widest, steady from seed to seed where the widest swings.
The margins cannot see a search that serves a hypothesis other than its
best while scoring each rightly: ``select_rel`` is how far any of the K
final hypotheses beats the served one where the searcher's scores and the
reference's both say so, relative to the served score (the control's
choice is the hypothesis its own scores put first). A sound search reads
0; the comparison is exact. A best expansion pruned before the end is
among no final hypothesis, and no rescoring of them sees it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from asr_bench.reference import model as ref


def rel_gap(got: torch.Tensor, want: torch.Tensor,
            mask: torch.Tensor) -> float:
    """max over utterances of ||got - want|| / ||want|| on the valid
    frames; (B, T, ...) tensors, (B, T) mask."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return float("inf")
    m = mask.float().reshape(mask.shape + (1,) * (want.dim() - 2))
    diff = ((got.float() - want.float()) * m).flatten(1).norm(dim=1)
    base = (want.float() * m).flatten(1).norm(dim=1)
    return float((diff / torch.clamp_min(base, 1e-30)).max())


@torch.no_grad()
def reference_encode(p: ref.Prec, w: Dict[str, torch.Tensor], cfg: dict,
                     wav, wav_lengths, use_enhancer: bool) -> dict:
    w = p.held(w)
    feats, fmask, logits = ref.features(p, w, cfg, wav, wav_lengths,
                                        use_enhancer)
    hs, hmask, hlens = ref.encode(p, w, cfg, feats, fmask)
    return {"feats": feats, "fmask": fmask, "enh_logits": logits, "hs": hs,
            "hmask": hmask, "hlens": hlens, "ctc": ref.ctc_logits(p, w, hs)}


@torch.no_grad()
def rescore(p: ref.Prec, w, cfg: dict, enc: dict, tokens: torch.Tensor,
            lengths: torch.Tensor, beam: dict,
            lm_w: Optional[Dict[str, torch.Tensor]] = None,
            lm_cfg: Optional[dict] = None) -> torch.Tensor:
    """The joint score (B,) float64 of each hypothesis ``tokens`` (B, L),
    -1 padded, of ``lengths`` (B,) tokens, followed by eos."""
    w, lm_w = p.held(w), p.held(lm_w)
    e2e = cfg["e2e"]
    sos, eos = e2e["sos_id"], e2e["eos_id"]
    b = tokens.shape[0]
    dev = tokens.device
    tokens, lengths = tokens.long(), lengths.long()
    s = int(lengths.max()) + 1
    pos = torch.arange(s, device=dev)[None, :]
    body = torch.cat([tokens, tokens.new_full((b, 1), -1)], dim=1)[:, :s]
    ys_out = torch.where(pos < lengths[:, None], body, -1)
    ys_out = torch.where(pos == lengths[:, None], eos, ys_out)
    ys_in = torch.cat([tokens.new_full((b, 1), sos),
                       torch.clamp_min(ys_out[:, :-1], 0)], dim=1)
    valid = (pos <= lengths[:, None]).double()
    tgt = torch.clamp_min(ys_out, 0)

    def teacher_sum(logits):
        lp = torch.log_softmax(logits.double(), dim=-1)
        return (torch.gather(lp, -1, tgt[..., None])[..., 0] * valid).sum(1)

    cw = beam["ctc_weight"]
    att = teacher_sum(ref.decoder_teacher_forced(p, w, cfg, enc["hs"],
                                                 enc["hmask"], ys_in))
    lpz = torch.log_softmax(enc["ctc"].double(), dim=-1).transpose(0, 1)
    ctc = -F.ctc_loss(lpz, torch.clamp_min(tokens, 0), enc["hlens"],
                      lengths, blank=e2e["blank_id"], reduction="none",
                      zero_infinity=False)
    score = (1.0 - cw) * att + cw * ctc
    score = score + beam.get("penalty", 0.0) * (lengths.double() + 1.0)
    if lm_w is not None and beam.get("lm_weight", 0.0) != 0.0:
        score = score + beam["lm_weight"] * teacher_sum(
            ref.lm_teacher_forced(p, lm_w, lm_cfg, ys_in))
    return score


def expand(enc: dict, k: int) -> dict:
    """The encoder's outputs repeated for K hypotheses an utterance."""
    return {name: enc[name].repeat_interleave(k, dim=0)
            for name in ("hs", "hmask", "hlens", "ctc")}


def rescore_served(p: ref.Prec, w, cfg: dict, enc: dict, tokens, lengths,
                   beam_tokens, beam_lengths, beam: dict, lm_w=None,
                   lm_cfg=None) -> dict:
    """``score`` (B,) of the served hypotheses and ``beam_score`` (B, K)
    of the K final ones (``beam_tokens`` (B, K, L)), on the host."""
    b, k, n = beam_tokens.shape
    each = rescore(p, w, cfg, expand(enc, k), beam_tokens.reshape(b * k, n),
                   beam_lengths.reshape(-1), beam, lm_w, lm_cfg)
    return {"score": rescore(p, w, cfg, enc, tokens, lengths, beam, lm_w,
                             lm_cfg).cpu(),
            "beam_score": each.view(b, k).cpu()}


def numbers(got: dict, want: dict, use_enhancer: bool,
            control: bool = False) -> Dict[str, float]:
    """The numbers compared, each a widest gap over the utterances:
    ``got`` the searcher's (or, with ``control``, the control's) enh_logits,
    feats, hs, ctc, score and beam_score; ``want`` the reference's."""
    out = {}
    if use_enhancer:
        out["enh_logit_rel"] = rel_gap(got["enh_logits"], want["enh_logits"],
                                       want["fmask"])
    out["feats_rel"] = rel_gap(got["feats"], want["feats"], want["fmask"])
    out["enc_rel"] = rel_gap(got["hs"], want["hs"], want["hmask"])
    out["ctc_rel"] = rel_gap(got["ctc"], want["ctc"], want["hmask"])
    s_got, s_want = got["score"].double(), want["score"].double()
    b_got, b_want = got["beam_score"].double(), want["beam_score"].double()
    if s_got.shape != s_want.shape or b_got.shape != b_want.shape:
        out["score_rel"] = out["margin_rel"] = float("inf")
        out["margin_mean_rel"] = out["select_rel"] = float("inf")
        return out
    base = torch.clamp_min(s_want.abs(), 1e-30)
    out["score_rel"] = float(((s_got - s_want).abs() / base).max())
    margin = (b_got - s_got[:, None]) - (b_want - s_want[:, None])
    per = (margin.abs() / base[:, None]).amax(dim=1)
    out["margin_rel"] = float(per.max())
    # the mean over utterances of each one's widest: steady from seed to
    # seed where the widest over all of them swings
    out["margin_mean_rel"] = float(per.mean())
    # the search's choice: how far a final hypothesis beats the one served
    # (for the control, the one its own scores put first) where the
    # searcher's scores and the reference's both say it does, relative to
    # the served score; 0 for a search that serves its best (a near-tie the
    # reference orders the other way is rounding, not a wrong choice)
    g_cand = torch.cat([s_got[:, None], b_got], dim=1)
    r_cand = torch.cat([s_want[:, None], b_want], dim=1)
    pick = (g_cand.argmax(dim=1, keepdim=True) if control
            else torch.zeros_like(g_cand[:, :1], dtype=torch.long))
    beat = torch.minimum(g_cand - torch.gather(g_cand, 1, pick),
                         r_cand - torch.gather(r_cand, 1, pick))
    out["select_rel"] = float((torch.clamp_min(beat, 0.0).amax(dim=1)
                               / base).max())
    return out
