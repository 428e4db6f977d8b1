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
around it; "twopass" runs the plain versions.
``make_pipelined_beam_searcher`` is the cross-batch staged schedule: the
next batch's encode on a side CUDA stream under this batch's beam loop.
The scan and parallel prefix forms and the chunked schedule are not
ported.
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
from robust_e2e_gan_torch.parallel import sharding
from robust_e2e_gan_torch.utils.impl import kernel_enabled
from robust_e2e_gan_torch.utils.trace import span

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
    with span("rg.beam"):
        return _beam_search(step_fn, init_carry_fn, enc, enc_mask, hlens,
                            enc_proj, ctc_logits, ecfg, bcfg, lm_step_fn,
                            lm_init_fn)


def _beam_search(step_fn, init_carry_fn, enc, enc_mask, hlens, enc_proj,
                 ctc_logits, ecfg, bcfg, lm_step_fn, lm_init_fn
                 ) -> BeamResult:
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
        with span("rg.beam.step"):
            if bcfg.early_exit and bool(finished.all()):
                break  # post-finish steps are no-ops: frozen eos self-loops

            with span("rg.beam.step.decoder"):
                new_dec_carry, (logits, _) = step_fn(
                    dec_carry, last_tok.reshape(b * k), enc, enc_proj,
                    enc_mask)
                att_lp = torch.log_softmax(logits.float(), dim=-1).reshape(
                    b, k, v)
                if use_lm:  # RNNLM shallow fusion on the same B*K lanes
                    new_lm_carry, lm_logits = lm_step_fn(
                        lm_carry, last_tok.reshape(b * k))
                    lm_lp = torch.log_softmax(lm_logits.float(),
                                              dim=-1).reshape(b, k, v)
            with span("rg.beam.step.psi"):
                psi = psi_fn(lpz, last_tok, lengths, r_n, r_b, blank, eos)

            with span("rg.beam.step.prune"):
                # joint candidate scores
                cand = (scores[..., None] + (1.0 - cw) * att_lp
                        + cw * (psi - psi_g[..., None]) + bcfg.penalty)
                if use_lm:
                    cand = cand + bcfg.lm_weight * lm_lp
                cand[..., blank] = neg
                cand[..., eos] = torch.where(lengths < min_len_b, neg,
                                             cand[..., eos])
                # finished hypotheses: frozen, eos-only continuation
                cand_fin = torch.full((b, k, v), neg, device=dev)
                cand_fin[..., eos] = scores
                cand = torch.where(finished[..., None], cand_fin, cand)
                # force eos at each utterance's length limit and at the
                # last step
                at_limit = lengths >= max_len_b
                if i == l - 1:
                    at_limit = torch.ones_like(at_limit)
                if bcfg.end_detect:
                    at_limit = at_limit | (
                        stall >= bcfg.end_detect_window)[:, None]
                force_eos = at_limit[..., None] & (vocab_ids != eos)
                cand = torch.where(force_eos & ~finished[..., None], neg,
                                   cand)

                # prune to K over all K*V candidates (stable: lowest index
                # first)
                top_scores, top_idx = torch.sort(
                    cand.reshape(b, k * v), dim=1, descending=True,
                    stable=True)
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
                    # streaming ESPnet end detection: end_detect_window
                    # consecutive steps whose newly ended hypotheses all
                    # score more than the margin below the best ended score
                    # end the utterance
                    just_ended = finished & ~fin_old
                    ended_now = torch.where(just_ended, top_scores,
                                            neg).amax(dim=1)
                    any_ended = just_ended.any(dim=1)
                    below = ended_now < ended_best - bcfg.end_detect_margin
                    stall = torch.where(any_ended & below, stall + 1, 0)
                    ended_best = torch.maximum(ended_best, ended_now)

            with span("rg.beam.step.state"):
                # CTC forward state of the survivors: the selected
                # extensions, and the parents' rows where nothing was
                # appended
                r_n, r_b = state_fn(lpz, k_idx, tok, append, last_tok,
                                    prev_lengths, r_n, r_b, blank)

                dec_carry = tuple(_permute_carry(x, k_idx)
                                  for x in new_dec_carry)
                if use_lm:
                    lm_carry = tuple(_permute_carry(x, k_idx)
                                     for x in new_lm_carry)
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


def _search_parts(model, ecfg: E2EConfig, bcfg: BeamSearchConfig,
                  use_enhancer: bool, lm, input_kind: str, log_domain: bool):
    """(encode, decode), the two halves of the serving search (JAX
    ``_bind_search_parts``): ``encode(wav, wav_lengths, cmvn_batch=None)
    -> (hs, hmask, hlens, ctc_logits, enc_proj)`` and ``decode(enc) ->
    BeamResult``. ``make_beam_searcher`` runs them one after the other;
    ``make_pipelined_beam_searcher`` staggers them across batches."""
    lm_step_fn = lm_init_fn = None
    if lm is not None and bcfg.lm_weight != 0.0:
        lm_step_fn, lm_init_fn = lm.step, lm.initial_carry

    def encode(wav, wav_lengths, cmvn_batch=None):
        if input_kind == "feats":
            return model.encode_for_decode_feats(wav, wav_lengths,
                                                 cmvn_batch=cmvn_batch)
        if input_kind == "spec":
            return model.encode_for_decode_spec(
                wav, wav_lengths, use_enhancer, cmvn_batch=cmvn_batch,
                log_domain=log_domain)
        return model.encode_for_decode(wav, wav_lengths, use_enhancer,
                                       cmvn_batch=cmvn_batch)

    def decode(enc) -> BeamResult:
        hs, hmask, hlens, ctc_logits, enc_proj = enc
        return beam_search_from_encoder(
            model.decoder_step, model.decoder_initial_carry, hs, hmask,
            hlens, enc_proj, ctc_logits, ecfg, bcfg, lm_step_fn, lm_init_fn)

    return encode, decode


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
    JAX package does not apply. A model sharded on a mesh's model axis
    (``parallel.shard_params``) is gathered once a search, and the search
    runs on the full weights; every rank of its model group searches."""
    encode, decode = _search_parts(model, ecfg, bcfg, use_enhancer, lm,
                                   input_kind, log_domain)

    @torch.inference_mode()
    def search(wav, wav_lengths, cmvn_batch=None) -> BeamResult:
        with span("rg.search", wav.shape[0]), sharding.gathered(model):
            return decode(encode(wav, wav_lengths, cmvn_batch))

    search.encode = encode
    return search


def _leaves(batch) -> list:
    """The arrays of a (wav, wav_lengths[, cmvn_batch]) tuple."""
    out = []
    for x in batch:
        if isinstance(x, (tuple, list)):
            out.extend(x)
        elif x is not None:
            out.append(x)
    return out


def make_pipelined_beam_searcher(model, ecfg: E2EConfig,
                                 bcfg: BeamSearchConfig,
                                 use_enhancer: bool = True, lm=None,
                                 input_kind: str = "wav",
                                 log_domain: bool = False) -> Callable:
    """Cross-batch staged serving (JAX ``make_pipelined_beam_searcher``):
    batch i+1's copy to the device and its encode are issued before batch
    i's beam loop, so the card can run them while the loop's host waits.

    Returns ``run(batches)``: ``batches`` iterates (wav, wav_lengths[,
    cmvn_batch]) tuples, host arrays or tensors, with the arguments of
    ``make_beam_searcher``'s ``search``; it yields one ``BeamResult`` a
    batch, in order, each the sequential searcher's. A change of any
    input's shape flushes the staged batch before the new one is staged,
    as the JAX ``run`` does. An empty stream yields nothing.

    On a CUDA model the copy and the encode run on a side stream of its
    device and each beam loop on the current stream: the side stream waits
    for the current one before each encode, so memory freed there is never
    reused under it; an event recorded after the encode holds the current
    stream until it is done; every encode output is marked in use by the
    current stream (``record_stream``). A host input is copied from pinned
    memory, so the host does not wait for the copy. Each stream keeps its
    own grid-barrier counters for the cooperative kernels
    (``utils/impl.py::grid_barrier``). On the CPU the same calls run in
    the same order, without streams."""
    encode, decode = _search_parts(model, ecfg, bcfg, use_enhancer, lm,
                                   input_kind, log_domain)
    dev = next(model.parameters()).device
    # one side stream for every run: its cuBLAS workspace and grid-barrier
    # counters are made once
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def to_device(x, side):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return tuple(to_device(y, side) for y in x)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(x)
        if x.device == dev:
            if side is not None:
                x.record_stream(side)
            return x
        if side is not None:
            x = x.pin_memory()
        return x.to(dev, non_blocking=True)

    @torch.inference_mode()
    def stage(batch, side):
        """Issue one batch's copy and encode: (enc, the encode's event)."""
        if side is None:
            return encode(*(to_device(x, None) for x in batch)), None
        cur = torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            side.wait_stream(cur)
            enc = encode(*(to_device(x, side) for x in batch))
            done = torch.cuda.Event()
            done.record(side)
        return enc, done

    @torch.inference_mode()
    def finish(enc, done) -> BeamResult:
        """The beam loop of one staged batch, on the current stream."""
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for t in enc:
                t.record_stream(cur)
        return decode(enc)

    def run(batches):
        staged, staged_shape = None, None
        try:
            for batch in batches:
                shape = [tuple(x.shape) for x in _leaves(batch)]
                if staged is not None and shape != staged_shape:
                    yield finish(*staged)
                    staged = None
                nxt = stage(batch, side)
                if staged is not None:
                    yield finish(*staged)
                staged, staged_shape = nxt, shape
            if staged is not None:
                yield finish(*staged)
        finally:
            # a stream abandoned with a batch staged leaves the side
            # stream's work (and what it cached) ordered before what the
            # current stream runs next
            if side is not None:
                torch.cuda.current_stream(dev).wait_stream(side)

    return run
