"""Configuration dataclasses of the port.

Counterpart of ``robust_e2e_gan_tpu/config.py``: the serving and training
fields. Names, defaults and meanings are the JAX package's, so
``from_dict(JointConfig, dataclasses.asdict(jax_config))`` carries a JAX
configuration over; the fields left out (remat, scan unrolls) are XLA
scheduling knobs that do not change what is computed. ``gate_storage`` is
kept: "compute" rounds the plain BLSTM frame loop's gate projections to
the compute dtype, as it rounds the JAX scan's.
``DecoderConfig.step_impl`` is kept: the fused decoder step it selects
rounds where the unfused step does not in bfloat16, and runs one launch
where the unfused step runs several. ``AttentionConfig.variant`` is kept
so that the variants the port does not have yet raise. The kernel-impl
fields take the JAX values; ``utils/impl.py`` says what each selects.
``LMConfig`` is the JAX package's ``models/lm.py::LMConfig``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """Framing -> STFT power -> log-mel -> CMVN, with Kaldi fbank defaults
    (dither 0, snip edges, povey window, pre-emphasis 0.97)."""

    sample_rate: int = 16000
    frame_length: int = 400  # 25 ms
    frame_shift: int = 160  # 10 ms
    n_fft: int = 512
    n_mels: int = 80
    f_min: float = 20.0
    f_max: Optional[float] = None  # None -> Nyquist
    preemphasis: float = 0.97
    remove_dc: bool = True
    window: str = "povey"  # povey | hann | hamming
    log_floor: float = 1.1920928955078125e-07  # FLT_EPSILON, Kaldi log floor
    use_power: bool = True  # power spectrum (Kaldi default) vs magnitude
    cmvn: str = "utterance"  # utterance | global | speaker | none
    # the fused fbank kernel (ops/fbank_fused.py) on enhancer-free paths
    # with utterance CMVN
    fused: bool = False

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class EncoderConfig:
    """VGG2L conv frontend + projected BLSTM stack (ESPnet VGG2L+BLSTMP)."""

    input_dim: int = 80
    vgg_channels: Tuple[int, int] = (64, 128)
    num_layers: int = 3  # BLSTM layers
    hidden_dim: int = 512  # per direction
    proj_dim: int = 512  # projection after each BLSTM layer
    dropout_rate: float = 0.0  # after each projection, in training
    lstm_impl: str = "scan"  # BLSTM frame loop: scan (plain) | auto (kernel)
    # storage of the scan path's hoisted gate projections: "f32" exact,
    # "compute" rounded to the compute dtype; the kernels ignore it
    gate_storage: str = "f32"


@dataclass(frozen=True)
class AttentionConfig:
    """Location-aware attention (ESPnet AttLoc)."""

    dim: int = 512  # attention inner dim
    conv_channels: int = 10
    conv_kernel: int = 201  # odd
    sharpening: float = 2.0  # scaling of pre-softmax scores
    variant: str = "location"  # only location is ported; add | dot raise
    score_impl: str = "auto"  # beam-mode step: xla (plain) | auto (kernel)
    enc_proj_bias: bool = False  # bias of mlp_enc (imported checkpoints)


@dataclass(frozen=True)
class DecoderConfig:
    """LSTM attention decoder (ESPnet Decoder)."""

    vocab_size: int = 52
    embed_dim: int = 512
    num_layers: int = 1
    hidden_dim: int = 512
    # read nowhere in the JAX package's decoder, so the port applies none
    dropout_rate: float = 0.0
    label_smoothing: float = 0.0
    sampling_probability: float = 0.0  # scheduled sampling
    # beam-mode step: "fused" runs attention, embedding, cell and readout in
    # one kernel (ops/att_dec.py; one layer, location attention, a kernel
    # score_impl); "auto" and "xla" run the unfused step, as in the JAX
    # package, where "auto" resolves to the unfused step by a TPU A/B
    step_impl: str = "auto"


@dataclass(frozen=True)
class EnhancerConfig:
    """Mask-estimating BLSTM enhancement generator."""

    input_dim: int = 257  # n_fft//2 + 1
    num_layers: int = 2
    hidden_dim: int = 512
    mask_floor: float = 0.0  # optional lower bound on the mask
    compression: str = "log1p"  # input compression: log1p | log | none
    lstm_impl: str = "scan"  # see EncoderConfig.lstm_impl
    gate_storage: str = "f32"  # see EncoderConfig.gate_storage


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Conv discriminator D over log-mel feature maps."""

    input_dim: int = 80
    channels: Tuple[int, ...] = (32, 64, 128)
    kernel: Tuple[int, int] = (3, 3)
    loss_type: str = "lsgan"  # lsgan | bce


@dataclass(frozen=True)
class E2EConfig:
    """Hybrid CTC/attention E2E model."""

    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mtlalpha: float = 0.5  # loss = mtlalpha * ctc + (1 - mtlalpha) * att
    blank_id: int = 0
    sos_id: int = 1  # shared <sos>/<eos> per ESPnet convention
    eos_id: int = 1
    ignore_id: int = -1  # label padding
    ctc_impl: str = "auto"  # CTC alpha recursion: scan (plain) | auto (kernel)


@dataclass(frozen=True)
class JointConfig:
    """Enhancer + E2E ASR, and the joint adversarial objective
    loss_G = L_ASR + lambda_adv * L_adv + mu_enh * L_enh."""

    e2e: E2EConfig = field(default_factory=E2EConfig)
    enhancer: EnhancerConfig = field(default_factory=EnhancerConfig)
    discriminator: DiscriminatorConfig = field(
        default_factory=DiscriminatorConfig)
    lambda_adv: float = 1.0
    mu_enh: float = 1.0
    enh_loss: str = "l2"  # l2 | l1 on log1p spectra
    # "float32" | "bfloat16"; parameters stay float32
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class BeamSearchConfig:
    """Joint CTC/attention one-pass beam search (ESPnet recognize_beam +
    CTCPrefixScore)."""

    beam_size: int = 8
    ctc_weight: float = 0.3
    penalty: float = 0.0  # per-token insertion bonus
    max_steps: int = 64  # decode steps (>= longest transcript)
    min_len: int = 1  # eos masked below this output length
    # per-utterance length bounds as ratios of the encoded length; 0
    # disables. min_len and minlen_ratio compose (the max applies).
    maxlen_ratio: float = 0.0
    minlen_ratio: float = 0.0
    length_normalize: bool = False  # normalize final scores by length
    # CTC prefix recursion: twopass (plain) | auto, tiled (the tiled
    # kernels) | pallas (the per-utterance psi kernel)
    prefix_impl: str = "auto"
    # stop once every hypothesis has ended: one host sync per step
    early_exit: bool = True
    # streaming ESPnet end detection
    end_detect: bool = False
    end_detect_window: int = 3
    end_detect_margin: float = 10.0
    lm_weight: float = 0.0  # RNNLM shallow fusion weight (0 = no LM)


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation and loop settings: Adadelta or Adam, grad clip 5,
    Adadelta eps decay on a dev plateau."""

    optimizer: str = "adadelta"  # adadelta | adam
    learning_rate: float = 1.0
    warmup_steps: int = 0  # linear LR warmup (adam only; 0 = constant)
    adadelta_rho: float = 0.95
    adadelta_eps: float = 1e-8
    eps_decay: float = 0.01  # multiply eps on dev-accuracy plateau
    grad_clip: float = 5.0
    batch_size: int = 16
    num_epochs: int = 15
    seed: int = 1
    length_buckets: Tuple[int, ...] = (256, 512, 1024, 1600)
    max_label_len: int = 128
    checkpoint_dir: str = "checkpoints/default"
    log_every: int = 10


@dataclass(frozen=True)
class LMConfig:
    """LSTM language model over the ASR token vocabulary (shallow fusion)."""

    vocab_size: int = 52
    embed_dim: int = 128
    hidden_dim: int = 256
    num_layers: int = 1
    sos_id: int = 1  # shared <sos>/<eos>, as E2EConfig
    eos_id: int = 1
    ignore_id: int = -1
    # beam-step implementation: "xla" (plain cells) | "auto", "fused" (the
    # kernel, ops/lm_step.py); training always runs the plain cells
    step_impl: str = "auto"


_NESTED = {
    "frontend": FrontendConfig,
    "encoder": EncoderConfig,
    "attention": AttentionConfig,
    "decoder": DecoderConfig,
    "e2e": E2EConfig,
    "enhancer": EnhancerConfig,
    "discriminator": DiscriminatorConfig,
}


def from_dict(cls, data: Dict[str, Any]):
    """Build a config dataclass tree from a plain dict (a saved JAX
    configuration, or ``dataclasses.asdict`` of one). Keys the port has no
    field for are ignored; lists become tuples."""
    kwargs = {}
    for fld in dataclasses.fields(cls):
        if fld.name not in data:
            continue
        v = data[fld.name]
        if fld.name in _NESTED and isinstance(v, dict):
            kwargs[fld.name] = from_dict(_NESTED[fld.name], v)
        elif isinstance(v, list):
            kwargs[fld.name] = tuple(v)
        else:
            kwargs[fld.name] = v
    return cls(**kwargs)
