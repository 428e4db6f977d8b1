"""Batched joint CTC/attention beam search.

Port of ``robust_e2e_gan_tpu/decode/beam.py``: ``BeamResult``,
``beam_search_from_encoder`` in its psi-only two-pass form (with
per-utterance length bounds, end detection and early exit) and
``make_beam_searcher``. Hypotheses are dense (B, K) tensors and every step
scores all B*K lanes at once; pruning takes the top K of the K*V
candidates, with ties going to the lowest index as ``jax.lax.top_k``
breaks them.

With ``early_exit=False`` the loop runs ``max_steps`` steps and the host
never waits for the device inside it; ``early_exit=True`` reads
``finished.all()`` on the host once per step. RNNLM shallow fusion adds
``lm_weight * log p_LM`` to every candidate when an LM is given and
``lm_weight`` is not 0. The CTC prefix scores take the kernels of
``ops/ctc_prefix.py``: ``prefix_psi`` (``prefix_impl`` "auto" or "tiled")
or the per-utterance ``prefix_psi_utt`` ("pallas"), and in every kernel
mode ``prefix_state_step``, which computes the ``prefix_state_for_token``
that JAX pairs with both, with the gathers by parent and the selects
around it; "twopass" runs the plain versions. The scan and parallel
prefix forms and the pipelined searchers are not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from robust_e2e_gan_torch.config import BeamSearchConfig, E2EConfig
from robust_e2e_gan_torch.ops.ctc_prefix import (
    gather_beam,
    prefix_psi,
    prefix_psi_plain,
    prefix_psi_utt,
    prefix_state_step,
    prefix_state_step_plain,
)
from robust_e2e_gan_torch.utils.impl import kernel_enabled

LOG_ZERO = -1e10


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # (B, L) best hypothesis, -1 padded
    lengths: torch.Tensor  # (B,)
    scores: torch.Tensor  # (B,)
    beam_tokens: torch.Tensor  # (B, K, L)
    beam_lengths: torch.Tensor  # (B, K)
    beam_scores: torch.Tensor  # (B, K)


def _permute_carry(x: torch.Tensor, k_idx: torch.Tensor) -> torch.Tensor:
    """Reorder a decoder-carry leaf by the surviving parents: (B*K, ...)
    lanes, or (layers, B*K, D) stacked LSTM state."""
    b, k = k_idx.shape
    if x.shape[0] == b * k:
        return gather_beam(x.reshape((b, k) + x.shape[1:]), k_idx).reshape(
            x.shape)
    xs = x.reshape(x.shape[0], b, k, x.shape[-1])
    idx = k_idx[None, :, :, None].expand(xs.shape)
    return torch.gather(xs, 2, idx).reshape(x.shape)


def beam_search_from_encoder(
    step_fn: Callable,
    init_carry_fn: Callable,
    enc: torch.Tensor,
    enc_mask: torch.Tensor,
    hlens: torch.Tensor,
    enc_proj: torch.Tensor,
    ctc_logits: torch.Tensor,
    ecfg: E2EConfig,
    bcfg: BeamSearchConfig,
    lm_step_fn: Optional[Callable] = None,
    lm_init_fn: Optional[Callable] = None,
) -> BeamResult:
    """Core search given encoder outputs.

    step_fn: (carry, tokens (N,), enc, enc_proj, enc_mask) ->
      (new_carry, (logits (N, V), att (N, T))), N = B*K lanes.
    init_carry_fn: (n, enc_mask (N, T)) -> initial decoder carry.
    lm_step_fn/lm_init_fn: optional RNNLM step (carry, tokens (N,)) ->
      (new_carry, logits (N, V)) and its initial carry (n) -> carry, for
      shallow fusion (score += lm_weight * log p_LM); the carry is permuted
      with the surviving parents like the decoder's.
    """
    if bcfg.prefix_impl not in ("auto", "tiled", "pallas", "twopass"):
        raise NotImplementedError(
            f"prefix_impl={bcfg.prefix_impl!r} is not ported; use auto, "
            "tiled, pallas (the kernels) or twopass (the plain version)")
    if bcfg.prefix_impl == "pallas":
        psi_fn, state_fn = prefix_psi_utt, prefix_state_step
    elif kernel_enabled(bcfg.prefix_impl):
        psi_fn, state_fn = prefix_psi, prefix_state_step
    else:
        psi_fn, state_fn = prefix_psi_plain, prefix_state_step_plain

    dev = enc.device
    b, t, _ = enc.shape
    v = ctc_logits.shape[-1]
    k, l = bcfg.beam_size, bcfg.max_steps
    blank, eos = ecfg.blank_id, ecfg.eos_id
    cw = bcfg.ctc_weight

    # masked CTC log-probs: frames past each length emit blank with
    # probability 1, which leaves prefix scores untouched
    lpz = torch.log_softmax(ctc_logits.float(), dim=-1)
    frame_valid = torch.arange(t, device=dev)[None, :] < hlens[:, None]
    pad_row = torch.full((v,), LOG_ZERO, device=dev)
    pad_row[blank] = 0.0
    lpz = torch.where(frame_valid[..., None], lpz, pad_row).contiguous()

    dec_carry = init_carry_fn(b * k, enc_mask.repeat_interleave(k, dim=0))
    use_lm = lm_step_fn is not None and bcfg.lm_weight != 0.0
    lm_carry = lm_init_fn(b * k) if use_lm else None

    # CTC prefix state of the empty prefix: all-blank paths
    r_b = torch.cumsum(lpz[:, :, blank], dim=1)[:, None].expand(b, k, t)
    r_b = r_b.contiguous()
    r_n = torch.full((b, k, t), LOG_ZERO, device=dev)

    scores = torch.full((b, k), LOG_ZERO, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((b, k, l), -1, dtype=torch.int32, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.int32, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    last_tok = torch.full((b, k), ecfg.sos_id, dtype=torch.int32, device=dev)
    psi_g = torch.zeros((b, k), device=dev)

    hl = hlens.float()
    min_len_b = torch.full((b, 1), bcfg.min_len, dtype=torch.int32, device=dev)
    if bcfg.minlen_ratio > 0.0:
        min_len_b = torch.maximum(
            min_len_b,
            torch.ceil(bcfg.minlen_ratio * hl).to(torch.int32)[:, None])
    if bcfg.maxlen_ratio > 0.0:
        # at least 1, at most l - 1 (clamp gives max when min > max)
        max_len_b = torch.clamp(
            torch.floor(bcfg.maxlen_ratio * hl).to(torch.int32), 1, l - 1
        )[:, None]
    else:
        max_len_b = torch.full((b, 1), l - 1, dtype=torch.int32, device=dev)

    vocab_ids = torch.arange(v, device=dev)
    ended_best = torch.full((b,), LOG_ZERO, device=dev)
    stall = torch.zeros((b,), dtype=torch.int32, device=dev)
    neg = 2.0 * LOG_ZERO

    for i in range(l):
        if bcfg.early_exit and bool(finished.all()):
            break  # post-finish steps are no-ops: frozen eos self-loops

        new_dec_carry, (logits, _) = step_fn(
            dec_carry, last_tok.reshape(b * k), enc, enc_proj, enc_mask)
        att_lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        if use_lm:  # RNNLM shallow fusion on the same B*K lanes
            new_lm_carry, lm_logits = lm_step_fn(lm_carry,
                                                 last_tok.reshape(b * k))
            lm_lp = torch.log_softmax(lm_logits.float(), dim=-1).reshape(
                b, k, v)
        psi = psi_fn(lpz, last_tok, lengths, r_n, r_b, blank, eos)

        # joint candidate scores
        cand = (scores[..., None] + (1.0 - cw) * att_lp
                + cw * (psi - psi_g[..., None]) + bcfg.penalty)
        if use_lm:
            cand = cand + bcfg.lm_weight * lm_lp
        cand[..., blank] = neg
        cand[..., eos] = torch.where(lengths < min_len_b, neg, cand[..., eos])
        # finished hypotheses: frozen, eos-only continuation
        cand_fin = torch.full((b, k, v), neg, device=dev)
        cand_fin[..., eos] = scores
        cand = torch.where(finished[..., None], cand_fin, cand)
        # force eos at each utterance's length limit and at the last step
        at_limit = lengths >= max_len_b
        if i == l - 1:
            at_limit = torch.ones_like(at_limit)
        if bcfg.end_detect:
            at_limit = at_limit | (stall >= bcfg.end_detect_window)[:, None]
        force_eos = at_limit[..., None] & (vocab_ids != eos)
        cand = torch.where(force_eos & ~finished[..., None], neg, cand)

        # prune to K over all K*V candidates (stable: lowest index first)
        top_scores, top_idx = torch.sort(cand.reshape(b, k * v), dim=1,
                                         descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        k_idx = torch.div(top_idx, v, rounding_mode="floor")
        tok = (top_idx % v).to(torch.int32)

        tokens = gather_beam(tokens, k_idx)
        prev_lengths = lengths
        lengths = gather_beam(lengths, k_idx)
        fin_old = gather_beam(finished, k_idx)
        psi_old = gather_beam(psi_g, k_idx)
        psi_sel = torch.gather(gather_beam(psi, k_idx), 2,
                               tok.long()[..., None])[..., 0]

        append = ~fin_old & (tok != eos)
        tokens[:, :, i] = torch.where(append, tok, -1)
        lengths = lengths + append.to(torch.int32)
        finished = fin_old | (tok == eos)
        psi_g = torch.where(append, psi_sel, psi_old)

        if bcfg.end_detect:
            # streaming ESPnet end detection: end_detect_window consecutive
            # steps whose newly ended hypotheses all score more than the
            # margin below the best ended score end the utterance
            just_ended = finished & ~fin_old
            ended_now = torch.where(just_ended, top_scores, neg).amax(dim=1)
            any_ended = just_ended.any(dim=1)
            below = ended_now < ended_best - bcfg.end_detect_margin
            stall = torch.where(any_ended & below, stall + 1, 0)
            ended_best = torch.maximum(ended_best, ended_now)

        # CTC forward state of the survivors: the selected extensions, and
        # the parents' rows where nothing was appended
        r_n, r_b = state_fn(lpz, k_idx, tok, append, last_tok, prev_lengths,
                            r_n, r_b, blank)

        dec_carry = tuple(_permute_carry(x, k_idx) for x in new_dec_carry)
        if use_lm:
            lm_carry = tuple(_permute_carry(x, k_idx) for x in new_lm_carry)
        last_tok = tok
        scores = top_scores

    rank = scores
    if bcfg.length_normalize:
        rank = scores / torch.clamp_min(lengths.float(), 1.0)
    best = torch.argmax(rank, dim=1)
    return BeamResult(
        tokens[torch.arange(b, device=dev), best],
        lengths.gather(1, best[:, None])[:, 0],
        scores.gather(1, best[:, None])[:, 0],
        tokens, lengths, scores,
    )


def make_beam_searcher(model, ecfg: E2EConfig, bcfg: BeamSearchConfig,
                       use_enhancer: bool = True, lm=None,
                       input_kind: str = "wav",
                       log_domain: bool = False) -> Callable:
    """Bind a ``RobustE2E`` into ``search(wav, wav_lengths, cmvn_batch=None)
    -> BeamResult``: enhancer -> fbank -> encoder -> batched joint
    CTC/attention beam search for a batch of utterances, on the model's
    device. ``input_kind``: "wav" (waveforms), "feats" (precomputed
    log-mel: ``wav`` is (B, T, D) features and ``wav_lengths`` their frame
    counts) or "spec" (precomputed power spectra, through the enhancer when
    ``use_enhancer``; ``log_domain``: Kaldi's log power). ``cmvn_batch``:
    the per-utterance speaker-CMVN (mean, inv_std). ``lm``: an ``RNNLM``
    (``models/lm.py``) with its weights on the same device, fused with
    ``bcfg.lm_weight``. ``search.encode(wav, wav_lengths, cmvn_batch)``
    is its encoder pass alone (the greedy decode and the attention maps
    read it). There is no batch padding: the TPU lane-packing rule of the
    JAX package does not apply."""
    lm_step_fn = lm_init_fn = None
    if lm is not None and bcfg.lm_weight != 0.0:
        lm_step_fn, lm_init_fn = lm.step, lm.initial_carry

    def encode(wav, wav_lengths, cmvn_batch):
        if input_kind == "feats":
            return model.encode_for_decode_feats(wav, wav_lengths,
                                                 cmvn_batch=cmvn_batch)
        if input_kind == "spec":
            return model.encode_for_decode_spec(
                wav, wav_lengths, use_enhancer, cmvn_batch=cmvn_batch,
                log_domain=log_domain)
        return model.encode_for_decode(wav, wav_lengths, use_enhancer,
                                       cmvn_batch=cmvn_batch)

    @torch.inference_mode()
    def search(wav, wav_lengths, cmvn_batch=None) -> BeamResult:
        hs, hmask, hlens, ctc_logits, enc_proj = encode(wav, wav_lengths,
                                                        cmvn_batch)
        return beam_search_from_encoder(
            model.decoder_step, model.decoder_initial_carry, hs, hmask,
            hlens, enc_proj, ctc_logits, ecfg, bcfg, lm_step_fn, lm_init_fn)

    search.encode = encode
    return search
