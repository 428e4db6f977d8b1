"""Model configurations of the port.

The serving fields of ``__graft_entry__.py``'s configurations, copied by
value: that file imports JAX. ``tests/test_torch_guards.py`` holds the two
equal.
"""

from __future__ import annotations

from robust_e2e_gan_torch.config import (
    AttentionConfig,
    DecoderConfig,
    E2EConfig,
    EncoderConfig,
    EnhancerConfig,
    FrontendConfig,
    JointConfig,
)


def flagship_config(vocab: int = 52) -> JointConfig:
    """The flagship model: 2-layer H=256 enhancer, VGG(64,128) + 2-layer
    BLSTMP encoder, AttLoc A=256, 1-layer H=256 decoder."""
    return JointConfig(
        e2e=E2EConfig(
            frontend=FrontendConfig(n_mels=80),
            encoder=EncoderConfig(
                input_dim=80, vgg_channels=(64, 128), num_layers=2,
                hidden_dim=256, proj_dim=256,
            ),
            attention=AttentionConfig(dim=256, conv_channels=10, conv_kernel=101),
            decoder=DecoderConfig(vocab_size=vocab, embed_dim=256, hidden_dim=256),
        ),
        enhancer=EnhancerConfig(input_dim=257, num_layers=2, hidden_dim=256),
    )


def tiny_config(vocab: int = 12) -> JointConfig:
    """A narrow, shallow model of the same structure, for CPU tests."""
    return JointConfig(
        e2e=E2EConfig(
            frontend=FrontendConfig(n_mels=24),
            encoder=EncoderConfig(
                input_dim=24, vgg_channels=(4, 8), num_layers=1,
                hidden_dim=32, proj_dim=32,
            ),
            attention=AttentionConfig(dim=24, conv_channels=4, conv_kernel=11),
            decoder=DecoderConfig(vocab_size=vocab, embed_dim=16, hidden_dim=32),
        ),
        enhancer=EnhancerConfig(input_dim=257, num_layers=1, hidden_dim=32),
    )
