"""Top-level pipeline: waveform -> enhancer -> fbank -> hybrid CTC/att ASR.

Port of ``robust_e2e_gan_tpu/pipeline.py``: the feature paths
(``noisy_power``, ``enhance``, ``features_from_power``, ``normalize_feats``
with utterance, global, per-speaker or no CMVN, ``logmel_no_cmvn``), the
training forwards on waveforms (``asr_forward``, ``joint_forward``), on
precomputed log-mel features (``asr_forward_feats``, the Kaldi feats.scp
input: no frontend, no enhancer) and on precomputed power spectra
(``joint_forward_spec``, ``asr_forward_spec``: spectrum -> enhancer -> mel
-> ASR, linear or, with ``log_domain``, Kaldi's log power), and the decode
entry points of the three inputs (``encode_for_decode``,
``encode_for_decode_feats``, ``encode_for_decode_spec``). Speaker CMVN
takes its per-utterance stats with the batch (``cmvn_batch``, from
``data/cmvn.py::SpeakerCmvn``). With ``FrontendConfig.fused`` the
enhancer-free waveform paths with utterance CMVN take the fused frontend
(``ops/fbank_fused.py``): the trainable form in ``asr_forward``, the
inference kernel in ``encode_for_decode``.
The discriminator lives outside this module, as in the JAX package.
Parameters are float32 masters; ``dtype`` is the compute dtype. Load
weights with ``load_state_dict(convert.from_flax(...))`` and move the model
to its device once.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from robust_e2e_gan_torch.config import FrontendConfig, JointConfig
from robust_e2e_gan_torch.models.e2e import E2E
from robust_e2e_gan_torch.models.enhancement import EnhanceNet
from robust_e2e_gan_torch.ops import fbank as fbank_ops
from robust_e2e_gan_torch.ops.fbank_fused import (
    fbank_fused,
    fbank_fused_trainable,
)
from robust_e2e_gan_torch.utils.trace import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(jcfg: JointConfig) -> torch.dtype:
    """JointConfig.compute_dtype as a torch dtype."""
    return _DTYPES[jcfg.compute_dtype]


def build_model(jcfg: JointConfig, cmvn_stats=None) -> "RobustE2E":
    """The model in the configured compute dtype (weights not loaded)."""
    return RobustE2E(jcfg, dtype=compute_dtype(jcfg), cmvn_stats=cmvn_stats)


def length_mask(t: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, t) float mask of each row's first ``lengths`` frames."""
    frames = torch.arange(t, device=lengths.device)
    return (frames[None, :] < lengths[:, None]).float()


def frame_mask_from_wav_lengths(
    wav: torch.Tensor, wav_lengths: Optional[torch.Tensor],
    cfg: FrontendConfig,
) -> Optional[torch.Tensor]:
    """(B, T) float mask of the valid STFT frames, or None."""
    if wav_lengths is None:
        return None
    return length_mask(fbank_ops.num_frames(wav.shape[-1], cfg),
                       fbank_ops.frame_lengths_from_wav_lengths(wav_lengths,
                                                                cfg))


class RobustE2E(nn.Module):
    """Enhancement generator + E2E ASR over raw waveforms.

    ``cmvn_stats``: (mean, inv_std) for FrontendConfig.cmvn="global".
    """

    def __init__(self, cfg: JointConfig, dtype: torch.dtype = torch.float32,
                 cmvn_stats=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.cmvn_stats = cmvn_stats
        self.enhancer = EnhanceNet(cfg.enhancer, dtype)
        self.asr = E2E(cfg.e2e, dtype)

    # ---------- feature paths ----------

    def noisy_power(self, wav, wav_lengths):
        fcfg = self.cfg.e2e.frontend
        power = fbank_ops.stft_power(wav, fcfg)
        fmask = frame_mask_from_wav_lengths(wav, wav_lengths, fcfg)
        if fmask is not None:
            power = power * fmask[..., None]
        return power, fmask

    def enhance(self, wav, wav_lengths=None):
        """(enhanced_power, tf_mask, frame_mask)."""
        power, fmask = self.noisy_power(wav, wav_lengths)
        enhanced, tf_mask = self.enhancer(power, fmask)
        return enhanced, tf_mask, fmask

    def features_from_power(self, power, fmask, cmvn_batch=None):
        feats = fbank_ops.log_mel(power, self.cfg.e2e.frontend)
        return self.normalize_feats(feats, fmask, cmvn_batch)

    def normalize_feats(self, feats, fmask, cmvn_batch=None):
        """CMVN per FrontendConfig.cmvn on (B, T, D) log-mel features,
        shared by the frontend and the precomputed-feature input.
        ``cmvn_batch``: the (B, D) (mean, inv_std) of each utterance's
        speaker, for cmvn "speaker"."""
        mode = self.cfg.e2e.frontend.cmvn
        if mode == "utterance":
            return fbank_ops.utterance_cmvn(feats, fmask)
        if mode == "global":
            if self.cmvn_stats is None:
                raise ValueError(
                    'FrontendConfig.cmvn="global" requires cmvn_stats='
                    "(mean, inv_std) on RobustE2E (see data/cmvn.py)"
                )
            mean, inv_std = (torch.as_tensor(x, dtype=feats.dtype,
                                             device=feats.device)
                             for x in self.cmvn_stats)
            feats = fbank_ops.apply_cmvn(feats, mean, inv_std)
        elif mode == "speaker":
            if cmvn_batch is None:
                raise ValueError(
                    'FrontendConfig.cmvn="speaker" needs per-batch '
                    "(cmvn_mean, cmvn_inv_std) arrays (BucketBatcher with "
                    "speaker_cmvn=...)")
            mean, inv_std = cmvn_batch
            feats = (feats - mean[:, None, :]) * inv_std[:, None, :]
        elif mode != "none":
            raise ValueError(f"unknown cmvn mode {mode!r}")
        if fmask is not None:
            feats = feats * fmask[..., None].to(feats.dtype)
        return feats

    def logmel_no_cmvn(self, power):
        """Un-normalised log-mel: the discriminator's input domain."""
        return fbank_ops.log_mel(power, self.cfg.e2e.frontend)

    # ---------- training forwards ----------

    def _use_fused_frontend(self, use_enhancer: bool) -> bool:
        """The fused frontend applies only where the chain is unsplit: no
        enhancer between STFT and mel, utterance CMVN."""
        fcfg = self.cfg.e2e.frontend
        return fcfg.fused and not use_enhancer and fcfg.cmvn == "utterance"

    def asr_forward(self, wav, wav_lengths, ys_pad,
                    use_enhancer: bool = False, deterministic: bool = True,
                    rngs: Optional[Dict[str, torch.Generator]] = None,
                    cmvn_batch=None):
        """ASR losses of waveforms (clean-ASR pretraining, dev eval)."""
        if self._use_fused_frontend(use_enhancer):
            feats, fmask = fbank_fused_trainable(
                wav, self.cfg.e2e.frontend, wav_lengths=wav_lengths)
        else:
            power, fmask = self.noisy_power(wav, wav_lengths)
            if use_enhancer:
                power, _ = self.enhancer(power, fmask)
            feats = self.features_from_power(power, fmask, cmvn_batch)
        flens = None if fmask is None else fmask.sum(dim=-1).to(torch.int32)
        return self.asr(feats, flens, ys_pad, deterministic, rngs)

    def joint_forward(self, noisy_wav, clean_wav, wav_lengths, ys_pad,
                      deterministic: bool = True,
                      rngs: Optional[Dict[str, torch.Generator]] = None,
                      with_asr: bool = True, cmvn_batch=None):
        """Everything the G- and D-steps need in one forward: the ASR
        losses of the enhanced noisy speech (skipped with
        ``with_asr=False``, where no caller reads them), and the spectra
        and log-mel maps of the GAN terms."""
        noisy_power, fmask = self.noisy_power(noisy_wav, wav_lengths)
        clean_power, _ = self.noisy_power(clean_wav, wav_lengths)
        flens = None if fmask is None else fmask.sum(dim=-1).to(torch.int32)
        return self._joint_terms(noisy_power, clean_power, fmask, flens,
                                 ys_pad, deterministic, rngs, with_asr,
                                 cmvn_batch)

    def _joint_terms(self, noisy_power, clean_power, fmask, flens, ys_pad,
                     deterministic, rngs, with_asr, cmvn_batch):
        enhanced_power, tf_mask = self.enhancer(noisy_power, fmask)
        out = {}
        if with_asr:
            feats = self.features_from_power(enhanced_power, fmask,
                                             cmvn_batch)
            out = self.asr(feats, flens, ys_pad, deterministic, rngs)
        return {
            **out,
            "enhanced_power": enhanced_power,
            "clean_power": clean_power,
            "noisy_power": noisy_power,
            "enhanced_logmel": self.logmel_no_cmvn(enhanced_power),
            "clean_logmel": self.logmel_no_cmvn(clean_power),
            "frame_mask": fmask,
            "tf_mask": tf_mask,
        }

    # ---------- precomputed-features path (Kaldi feats.scp) ----------

    def asr_forward_feats(self, feats, feat_lengths, ys_pad,
                          deterministic: bool = True,
                          rngs: Optional[Dict[str, torch.Generator]] = None,
                          cmvn_batch=None):
        """ASR losses of precomputed log-mel features (Kaldi feats.scp):
        no frontend and no enhancer, whose linear spectrum offline fbank
        discarded."""
        fmask = length_mask(feats.shape[1], feat_lengths)
        x = self.normalize_feats(feats, fmask, cmvn_batch)
        return self.asr(x, feat_lengths, ys_pad, deterministic, rngs)

    def encode_for_decode_feats(self, feats, feat_lengths, cmvn_batch=None):
        """The decode-time encoder pass on precomputed features."""
        with span("rg.encode"):
            with span("rg.encode.frontend"):
                fmask = length_mask(feats.shape[1], feat_lengths)
                x = self.normalize_feats(feats, fmask, cmvn_batch)
            return self._encode(x, feat_lengths)

    # ---------- precomputed-spectrogram path (Kaldi spectrogram feats) ----

    def _spec_mask(self, spec, feat_lengths, log_domain: bool = False):
        """(power with pad frames zeroed, frame mask) of (B, T, n_freqs)
        spectra; ``log_domain``: the spectra are Kaldi's log power."""
        fcfg = self.cfg.e2e.frontend
        if spec.shape[-1] != fcfg.n_freqs:
            raise ValueError(
                f"spectrogram feats have dim {spec.shape[-1]}, expected "
                f"n_fft//2+1 = {fcfg.n_freqs} (FrontendConfig.n_fft)")
        if log_domain:
            spec = torch.exp(spec)
        fmask = length_mask(spec.shape[1], feat_lengths)
        return spec * fmask[..., None], fmask

    def joint_forward_spec(self, noisy_spec, clean_spec, feat_lengths,
                           ys_pad, deterministic: bool = True,
                           rngs: Optional[Dict[str, torch.Generator]] = None,
                           with_asr: bool = True, cmvn_batch=None,
                           log_domain: bool = False):
        """``joint_forward`` on precomputed power spectra at n_fft//2+1
        dims: spectrum -> enhancer -> mel -> ASR, the joint objective on
        precomputed inputs (offline log-mel has lost the linear spectrum
        the enhancer masks)."""
        noisy_power, fmask = self._spec_mask(noisy_spec, feat_lengths,
                                             log_domain)
        clean_power, _ = self._spec_mask(clean_spec, feat_lengths,
                                         log_domain)
        return self._joint_terms(noisy_power, clean_power, fmask,
                                 feat_lengths, ys_pad, deterministic, rngs,
                                 with_asr, cmvn_batch)

    def asr_forward_spec(self, spec, feat_lengths, ys_pad,
                         use_enhancer: bool = False,
                         deterministic: bool = True,
                         rngs: Optional[Dict[str, torch.Generator]] = None,
                         cmvn_batch=None, log_domain: bool = False):
        """ASR losses of precomputed spectra, through the enhancer when
        ``use_enhancer``."""
        power, fmask = self._spec_mask(spec, feat_lengths, log_domain)
        if use_enhancer:
            power, _ = self.enhancer(power, fmask)
        feats = self.features_from_power(power, fmask, cmvn_batch)
        return self.asr(feats, feat_lengths, ys_pad, deterministic, rngs)

    def encode_for_decode_spec(self, spec, feat_lengths,
                               use_enhancer: bool = True, cmvn_batch=None,
                               log_domain: bool = False):
        """The decode-time encoder pass on precomputed spectra, with the
        contract of ``encode_for_decode``."""
        with span("rg.encode"):
            with span("rg.encode.frontend"):
                power, fmask = self._spec_mask(spec, feat_lengths,
                                               log_domain)
            if use_enhancer:
                with span("rg.encode.enhancer"):
                    power, _ = self.enhancer(power, fmask)
            with span("rg.encode.frontend"):
                feats = self.features_from_power(power, fmask, cmvn_batch)
            return self._encode(feats, feat_lengths)

    # ---------- decode-time entry points ----------

    def encode_for_decode(self, wav, wav_lengths, use_enhancer: bool = True,
                          cmvn_batch=None):
        """wav -> (hs, hmask, hlens, ctc_logits, enc_proj): everything the
        batched beam search needs."""
        with span("rg.encode"):
            if self._use_fused_frontend(use_enhancer):
                with span("rg.encode.frontend"):
                    feats, fmask = fbank_fused(wav, self.cfg.e2e.frontend,
                                               wav_lengths=wav_lengths)
            else:
                with span("rg.encode.frontend"):
                    power, fmask = self.noisy_power(wav, wav_lengths)
                if use_enhancer:
                    with span("rg.encode.enhancer"):
                        power, _ = self.enhancer(power, fmask)
                with span("rg.encode.frontend"):
                    feats = self.features_from_power(power, fmask,
                                                     cmvn_batch)
            flens = (None if fmask is None
                     else fmask.sum(dim=-1).to(torch.int32))
            return self._encode(feats, flens)

    def _encode(self, feats, flens):
        hs, hmask, hlens = self.asr.encode(feats, flens)
        with span("rg.encode.heads"):
            ctc_logits = self.asr.ctc_logits(hs)
            enc_proj = self.asr.decoder_project_encoder(hs)
        return hs, hmask, hlens, ctc_logits, enc_proj

    def decoder_step(self, carry, tokens, enc, enc_proj, enc_mask):
        return self.asr.decoder_step(carry, tokens, enc, enc_proj, enc_mask)

    def decoder_initial_carry(self, batch: int, enc_mask):
        return self.asr.decoder_initial_carry(batch, enc_mask)
