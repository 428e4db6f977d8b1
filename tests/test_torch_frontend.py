"""The port's feature frontend and enhancer against the JAX package.

Same numpy inputs through ``robust_e2e_gan_tpu`` and
``robust_e2e_gan_torch`` on the CPU, float32 throughout.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models.enhancement import (  # noqa: E402
    EnhanceNet as JaxEnhanceNet,
)
from robust_e2e_gan_tpu.ops import fbank as jfb  # noqa: E402
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_torch.config import EnhancerConfig, FrontendConfig  # noqa: E402
from robust_e2e_gan_torch.configs import tiny_config  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params  # noqa: E402
from robust_e2e_gan_torch.models.enhancement import EnhanceNet  # noqa: E402
from robust_e2e_gan_torch.ops import fbank as tfb  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402

# float32 modules: the same arithmetic in another summation order, so a few
# ulps of the outputs' scale
RTOL, ATOL = 1e-4, 1e-5


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _wav(rng, b=3, n=6000):
    wav = rng.standard_normal((b, n)).astype(np.float32)
    lens = np.array([n, n - 1234, 2100][:b], np.int32)
    return wav, lens


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("window", ["povey", "hann", "hamming"])
def test_frame_and_stft_power_match_jax(window):
    cfg = FrontendConfig(n_mels=24, window=window)
    wav, _ = _wav(np.random.default_rng(0))
    n = wav.shape[1]
    assert tfb.num_frames(n, cfg) == jfb.num_frames(n, _jax(cfg))
    _close(tfb.frame_signal(torch.from_numpy(wav), cfg),
           jfb.frame_signal(jnp.asarray(wav), _jax(cfg)), rtol=0, atol=0)
    got = tfb.stft_power(torch.from_numpy(wav), cfg)
    want = jfb.stft_power(jnp.asarray(wav), _jax(cfg))
    # power sums ~400 products of O(1) frames: relative tolerance only
    _close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cmvn", ["utterance", "global", "none"])
def test_fbank_chain_matches_jax(cmvn):
    """noisy_power -> log_mel -> CMVN of the model against the JAX
    model's (``features_from_power``; pad frames are zeroed in every
    mode)."""
    jcfg = tiny_config()
    cfg = dataclasses.replace(jcfg.e2e.frontend, cmvn=cmvn)
    jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(jcfg.e2e,
                                                             frontend=cfg))
    wav, lens = _wav(np.random.default_rng(1))
    stats = None
    if cmvn == "global":
        rng = np.random.default_rng(2)
        stats = (rng.standard_normal(24).astype(np.float32),
                 rng.uniform(0.5, 2.0, 24).astype(np.float32))
    jmodel = JaxRobustE2E(_jax(jcfg), cmvn_stats=stats)
    power, wmask = jmodel.apply({}, jnp.asarray(wav), jnp.asarray(lens),
                                method=JaxRobustE2E.noisy_power)
    want = jmodel.apply({}, power, wmask,
                        method=JaxRobustE2E.features_from_power)
    model = build_model(jcfg, cmvn_stats=stats)
    power, gmask = model.noisy_power(torch.from_numpy(wav),
                                     torch.from_numpy(lens))
    got = model.features_from_power(power, gmask)
    _close(gmask, wmask, rtol=0, atol=0)
    # log-mel values are O(10); CMVN output O(1)
    _close(got, want, rtol=1e-4, atol=1e-4)


def test_log_mel_floor_and_frame_lengths_match_jax():
    cfg = FrontendConfig(n_mels=24)
    power = np.zeros((2, 5, cfg.n_freqs), np.float32)
    power[0, 1, 3] = 1e-3
    _close(tfb.log_mel(torch.from_numpy(power), cfg),
           jfb.log_mel(jnp.asarray(power), _jax(cfg)))
    lens = np.array([0, 399, 400, 401, 560, 6000], np.int32)
    _close(tfb.frame_lengths_from_wav_lengths(torch.from_numpy(lens), cfg),
           jfb.frame_lengths_from_wav_lengths(jnp.asarray(lens), _jax(cfg)),
           rtol=0, atol=0)


def test_utterance_cmvn_without_mask_matches_jax():
    feats = np.random.default_rng(3).standard_normal((2, 7, 5)).astype(
        np.float32)
    _close(tfb.utterance_cmvn(torch.from_numpy(feats)),
           jfb.utterance_cmvn(jnp.asarray(feats)))


@pytest.mark.parametrize("mask_floor", [0.0, 0.1])
def test_enhancenet_matches_jax(mask_floor):
    jcfg = tiny_config()
    ecfg = EnhancerConfig(input_dim=257, num_layers=2, hidden_dim=16,
                          mask_floor=mask_floor)
    params = init_params(dataclasses.replace(jcfg, enhancer=ecfg),
                         seed=4)["enhancer"]
    rng = np.random.default_rng(5)
    power = rng.uniform(0.0, 4.0, (3, 9, 257)).astype(np.float32)
    fmask = (np.arange(9)[None] < np.array([9, 5, 1])[:, None]).astype(
        np.float32)
    want_e, want_m = JaxEnhanceNet(_jax(ecfg)).apply(
        {"params": params}, jnp.asarray(power), jnp.asarray(fmask))

    net = EnhanceNet(ecfg)
    net.load_state_dict(from_flax(params))
    got_e, got_m = net(torch.from_numpy(power), torch.from_numpy(fmask))
    _close(got_m, want_m)
    _close(got_e, want_e, rtol=RTOL, atol=1e-4)  # power values are O(1-4)
