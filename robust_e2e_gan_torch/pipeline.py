"""Top-level pipeline: waveform -> enhancer -> fbank -> hybrid CTC/att ASR.

Port of ``robust_e2e_gan_tpu/pipeline.py``: the feature paths
(``noisy_power``, ``enhance``, ``features_from_power``, ``normalize_feats``
with utterance, global or no CMVN, ``logmel_no_cmvn``), the training
forwards on waveforms (``asr_forward``, ``joint_forward``) and the decode
entry points. With ``FrontendConfig.fused`` the enhancer-free paths with
utterance CMVN take the fused frontend (``ops/fbank_fused.py``): the
trainable form in ``asr_forward``, the inference kernel in
``encode_for_decode``. Speaker CMVN and the precomputed-feature inputs are
not ported yet (ROADMAP queue 1, Kaldi and precomputed-feature inputs).
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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(jcfg: JointConfig) -> torch.dtype:
    """JointConfig.compute_dtype as a torch dtype."""
    return _DTYPES[jcfg.compute_dtype]


def build_model(jcfg: JointConfig, cmvn_stats=None) -> "RobustE2E":
    """The model in the configured compute dtype (weights not loaded)."""
    return RobustE2E(jcfg, dtype=compute_dtype(jcfg), cmvn_stats=cmvn_stats)


def frame_mask_from_wav_lengths(
    wav: torch.Tensor, wav_lengths: Optional[torch.Tensor],
    cfg: FrontendConfig,
) -> Optional[torch.Tensor]:
    """(B, T) float mask of the valid STFT frames, or None."""
    if wav_lengths is None:
        return None
    n_valid = fbank_ops.frame_lengths_from_wav_lengths(wav_lengths, cfg)
    frames = torch.arange(fbank_ops.num_frames(wav.shape[-1], cfg),
                          device=wav.device)
    return (frames[None, :] < n_valid[:, None]).float()


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

    def features_from_power(self, power, fmask):
        feats = fbank_ops.log_mel(power, self.cfg.e2e.frontend)
        return self.normalize_feats(feats, fmask)

    def normalize_feats(self, feats, fmask):
        """CMVN per FrontendConfig.cmvn on (B, T, D) log-mel features."""
        mode = self.cfg.e2e.frontend.cmvn
        if mode == "utterance":
            return fbank_ops.utterance_cmvn(feats, fmask)
        if mode == "global":
            if self.cmvn_stats is None:
                raise ValueError(
                    'FrontendConfig.cmvn="global" requires cmvn_stats='
                    "(mean, inv_std) on RobustE2E"
                )
            mean, inv_std = (torch.as_tensor(x, dtype=feats.dtype,
                                             device=feats.device)
                             for x in self.cmvn_stats)
            feats = fbank_ops.apply_cmvn(feats, mean, inv_std)
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
                    rngs: Optional[Dict[str, torch.Generator]] = None):
        """ASR losses of waveforms (clean-ASR pretraining, dev eval)."""
        if self._use_fused_frontend(use_enhancer):
            feats, fmask = fbank_fused_trainable(
                wav, self.cfg.e2e.frontend, wav_lengths=wav_lengths)
        else:
            power, fmask = self.noisy_power(wav, wav_lengths)
            if use_enhancer:
                power, _ = self.enhancer(power, fmask)
            feats = self.features_from_power(power, fmask)
        flens = None if fmask is None else fmask.sum(dim=-1).to(torch.int32)
        return self.asr(feats, flens, ys_pad, deterministic, rngs)

    def joint_forward(self, noisy_wav, clean_wav, wav_lengths, ys_pad,
                      deterministic: bool = True,
                      rngs: Optional[Dict[str, torch.Generator]] = None,
                      with_asr: bool = True):
        """Everything the G- and D-steps need in one forward: the ASR
        losses of the enhanced noisy speech (skipped with
        ``with_asr=False``, where no caller reads them), and the spectra
        and log-mel maps of the GAN terms."""
        noisy_power, fmask = self.noisy_power(noisy_wav, wav_lengths)
        clean_power, _ = self.noisy_power(clean_wav, wav_lengths)
        enhanced_power, tf_mask = self.enhancer(noisy_power, fmask)
        out = {}
        if with_asr:
            feats = self.features_from_power(enhanced_power, fmask)
            flens = (None if fmask is None
                     else fmask.sum(dim=-1).to(torch.int32))
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

    # ---------- decode-time entry points ----------

    def encode_for_decode(self, wav, wav_lengths, use_enhancer: bool = True):
        """wav -> (hs, hmask, hlens, ctc_logits, enc_proj): everything the
        batched beam search needs."""
        if self._use_fused_frontend(use_enhancer):
            feats, fmask = fbank_fused(wav, self.cfg.e2e.frontend,
                                       wav_lengths=wav_lengths)
        else:
            power, fmask = self.noisy_power(wav, wav_lengths)
            if use_enhancer:
                power, _ = self.enhancer(power, fmask)
            feats = self.features_from_power(power, fmask)
        flens = None if fmask is None else fmask.sum(dim=-1).to(torch.int32)
        hs, hmask, hlens = self.asr.encode(feats, flens)
        ctc_logits = self.asr.ctc_logits(hs)
        enc_proj = self.asr.decoder_project_encoder(hs)
        return hs, hmask, hlens, ctc_logits, enc_proj

    def decoder_step(self, carry, tokens, enc, enc_proj, enc_mask):
        return self.asr.decoder_step(carry, tokens, enc, enc_proj, enc_mask)

    def decoder_initial_carry(self, batch: int, enc_mask):
        return self.asr.decoder_initial_carry(batch, enc_mask)
