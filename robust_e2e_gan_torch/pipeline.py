"""Top-level pipeline: waveform -> enhancer -> fbank -> hybrid CTC/att ASR.

Port of the serving half of ``robust_e2e_gan_tpu/pipeline.py``: the
feature paths (``noisy_power``, ``enhance``, ``features_from_power``,
``normalize_feats`` with utterance, global or no CMVN) and the decode entry
points. Speaker CMVN and the precomputed-feature inputs are not ported
yet. Parameters are float32 masters; ``dtype`` is the
compute dtype. Load weights with ``load_state_dict(convert.from_flax(...))``
and move the model to its device once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from robust_e2e_gan_torch.config import FrontendConfig, JointConfig
from robust_e2e_gan_torch.models.e2e import E2E
from robust_e2e_gan_torch.models.enhancement import EnhanceNet
from robust_e2e_gan_torch.ops import fbank as fbank_ops

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

    # ---------- decode-time entry points ----------

    def encode_for_decode(self, wav, wav_lengths, use_enhancer: bool = True):
        """wav -> (hs, hmask, hlens, ctc_logits, enc_proj): everything the
        batched beam search needs."""
        fcfg = self.cfg.e2e.frontend
        if fcfg.fused and not use_enhancer and fcfg.cmvn == "utterance":
            raise NotImplementedError(
                "the fused fbank kernel (FrontendConfig.fused) is not ported "
                "yet; use fused=False"
            )
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
