"""The port's AttLoc step and decoder step against the JAX package: the XLA
beam branch, the fused Pallas attention kernel (interpret mode) and the
non-beam form."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models.attention import AttLoc as JaxAttLoc  # noqa: E402
from robust_e2e_gan_tpu.models.attention import (  # noqa: E402
    initial_alignment as jax_initial_alignment,
)
from robust_e2e_gan_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from robust_e2e_gan_tpu.ops.att_pallas import att_loc_fused  # noqa: E402
from robust_e2e_gan_torch.configs import tiny_config  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params  # noqa: E402
from robust_e2e_gan_torch.models.attention import AttLoc  # noqa: E402
from robust_e2e_gan_torch.models.decoder import Decoder  # noqa: E402
from robust_e2e_gan_torch.ops import att as ops  # noqa: E402

# float32: the same arithmetic in another summation order; context and
# alignment values are O(1)
RTOL, ATOL = 1e-4, 1e-5
B, K, T, E = 2, 3, 10, 32


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _setup(seed):
    jcfg = tiny_config()
    params = init_params(jcfg, seed)["asr"]["decoder"]
    rng = np.random.default_rng(seed)
    hlens = np.array([T, 6])
    mask = (np.arange(T)[None] < hlens[:, None]).astype(np.float32)
    enc = (rng.standard_normal((B, T, E)) * mask[..., None]).astype(np.float32)
    enc_proj = rng.standard_normal((B, T, 24)).astype(np.float32)
    dec_z = rng.standard_normal((B, K, 32)).astype(np.float32)
    att_prev = rng.uniform(0, 1, (B, K, T)).astype(np.float32) * mask[:, None]
    att_prev /= att_prev.sum(-1, keepdims=True)
    return jcfg, params, dict(enc=enc, enc_proj=enc_proj, mask=mask,
                              dec_z=dec_z, att_prev=att_prev)


def _torch(x):
    return {n: torch.from_numpy(a) for n, a in x.items()}


def _port_att(jcfg, params, score_impl):
    acfg = dataclasses.replace(jcfg.e2e.attention, score_impl=score_impl)
    att = AttLoc(acfg, 32)
    att.load_state_dict(from_flax(params["step_mod"]["att"]))
    return att


@pytest.mark.parametrize("seed", [0, 1])
def test_attloc_beam_step_matches_jax_xla_and_fused_kernel(seed):
    jcfg, params, x = _setup(seed)
    p_att = {"params": params["step_mod"]["att"]}
    jx = {n: jnp.asarray(a) for n, a in x.items()}
    args = (jx["enc"], jx["enc_proj"], jx["mask"], jx["dec_z"], jx["att_prev"])
    want = {}
    for impl in ("xla", "fused"):
        acfg = dataclasses.replace(jcfg.e2e.attention, score_impl=impl)
        want[impl] = JaxAttLoc(_jax(acfg)).apply(p_att, *args)
    for impl in ("xla", "auto"):  # plain version, and the CPU wrapper
        tx = _torch(x)
        got = _port_att(jcfg, params, impl)(
            tx["enc"], tx["enc_proj"], tx["mask"], tx["dec_z"], tx["att_prev"])
        for w in want.values():
            for g, ww in zip(got, w):
                np.testing.assert_allclose(g.numpy(), np.asarray(ww),
                                           rtol=RTOL, atol=ATOL)
        assert not got[1][1, :, 6:].any()  # exact zeros on pad frames


def test_att_step_op_matches_pallas_kernel():
    """The op-level contract of att_loc_fused: conv features in, f32 ctx
    and alignment out."""
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((B, K, T, 4)).astype(np.float32)
    ep = rng.standard_normal((B, T, 24)).astype(np.float32)
    enc = rng.standard_normal((B, T, E)).astype(np.float32)
    dec = rng.standard_normal((B, K, 24)).astype(np.float32)
    wloc = rng.standard_normal((4, 24)).astype(np.float32)
    g = rng.standard_normal(24).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [3]])).astype(np.float32)
    arrays = (feat, ep, enc, dec, wloc, g, mask)
    want = att_loc_fused(*map(jnp.asarray, arrays), 2.0, interpret=True)
    launches = ops.att_loc_step.launches
    got = ops.att_loc_step(*map(torch.from_numpy, arrays), 2.0)
    assert ops.att_loc_step.launches == launches  # CPU: the plain version
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_attloc_non_beam_matches_jax():
    jcfg, params, x = _setup(3)
    jx = {n: jnp.asarray(a) for n, a in x.items()}
    want = JaxAttLoc(_jax(jcfg.e2e.attention)).apply(
        {"params": params["step_mod"]["att"]}, jx["enc"], jx["enc_proj"],
        jx["mask"], jx["dec_z"][:, 0], jx["att_prev"][:, 0])
    tx = _torch(x)
    got = _port_att(jcfg, params, "auto")(
        tx["enc"], tx["enc_proj"], tx["mask"], tx["dec_z"][:, 0],
        tx["att_prev"][:, 0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("beam", [True, False], ids=["beam", "no_beam"])
def test_decoder_step_matches_jax(beam):
    jcfg, params, x = _setup(4)
    dcfg, acfg = jcfg.e2e.decoder, jcfg.e2e.attention
    k = K if beam else 1
    n = B * k
    emask = np.repeat(x["mask"], k, axis=0)
    toks = np.random.default_rng(5).integers(-1, dcfg.vocab_size, n).astype(
        np.int32)
    jdec = JaxDecoder(_jax(dcfg), _jax(acfg))
    jvars = {"params": params}
    carry = jdec.apply(jvars, n, jnp.asarray(emask),
                       method=JaxDecoder.initial_carry)
    want_carry, (want_logits, _) = jdec.apply(
        jvars, carry, jnp.asarray(toks), jnp.asarray(x["enc"]),
        jnp.asarray(x["enc_proj"]), jnp.asarray(x["mask"]),
        method=JaxDecoder.step)
    # a second step from a non-trivial state
    want_carry2, (want_logits2, _) = jdec.apply(
        jvars, want_carry, jnp.asarray(toks[::-1].copy()),
        jnp.asarray(x["enc"]), jnp.asarray(x["enc_proj"]),
        jnp.asarray(x["mask"]), method=JaxDecoder.step)

    dec = Decoder(dcfg, acfg, E)
    dec.load_state_dict(from_flax(params))
    tx = _torch(x)
    carry = dec.initial_carry(n, torch.from_numpy(emask))
    np.testing.assert_allclose(carry[2].numpy(),
                               np.asarray(jax_initial_alignment(jnp.asarray(emask))),
                               rtol=0, atol=0)
    carry, (logits, _) = dec.step(carry, torch.from_numpy(toks), tx["enc"],
                                  tx["enc_proj"], tx["mask"])
    carry2, (logits2, _) = dec.step(carry, torch.from_numpy(toks[::-1].copy()),
                                    tx["enc"], tx["enc_proj"], tx["mask"])
    for got, want in ((logits, want_logits), (logits2, want_logits2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    for g, w in zip(carry2, want_carry2):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(
        dec.project_encoder(tx["enc"]).numpy(),
        np.asarray(jdec.apply(jvars, jnp.asarray(x["enc"]),
                              method=JaxDecoder.project_encoder)),
        rtol=RTOL, atol=ATOL)


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: parameters are trainable, and
    the inference-only kernel wrappers refuse inputs autograd records."""
    with torch.no_grad():
        yield
