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


@pytest.mark.parametrize("k,c,g_scale", [(K, 4, 1.0), (8, 10, 0.3)],
                         ids=["k3c4", "k8c10"])
def test_att_step_op_matches_pallas_kernel(k, c, g_scale):
    """The op-level contract of att_loc_fused: conv features in, f32 ctx
    and alignment out (K=8, C=10: the flagship's beam and channels at a
    narrow width). The Pallas kernel subtracts one max per utterance, not
    per hypothesis (``att_pallas.py:123``), so a hypothesis whose
    scores lie ~20 below another's falls under its 1e-8 floor; at K=8 the
    score vector is scaled so that the eight hypotheses' maxima stay
    within a few units, where both forms agree."""
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((B, k, T, c)).astype(np.float32)
    ep = rng.standard_normal((B, T, 24)).astype(np.float32)
    enc = rng.standard_normal((B, T, E)).astype(np.float32)
    dec = rng.standard_normal((B, k, 24)).astype(np.float32)
    wloc = rng.standard_normal((c, 24)).astype(np.float32)
    g = (rng.standard_normal(24) * g_scale).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [3]])).astype(np.float32)
    arrays = (feat, ep, enc, dec, wloc, g, mask)
    want = att_loc_fused(*map(jnp.asarray, arrays), 2.0, interpret=True)
    launches = ops.att_loc_step.launches
    got = ops.att_loc_step(*map(torch.from_numpy, arrays), 2.0)
    assert ops.att_loc_step.launches == launches  # CPU: the plain version
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# the shared memory one block of an H100 may opt into
SMEM_OPTIN = 232_448
# (B, K, T, C, A, E): the flagship decode at B=128 and at the parity
# phases' B=16, and the JAX toy config's attention
PLAN_SHAPES = {"flagship_b128": (128, 8, 174, 10, 256, 256),
               "flagship_b16": (16, 8, 174, 10, 256, 256),
               "toy": (2, 3, 10, 4, 24, 32)}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES), ids=list(PLAN_SHAPES))
def test_utt_plan_fits(shape, itemsize):
    """Every shape chip_smoke.py and the parity phases run through
    att_loc_step takes the per-utterance route: F = 16 x (warps / S)
    frames a chunk, S column splits, within the opt-in shared memory."""
    b, k, t, c, a, e = PLAN_SHAPES[shape]
    plan = ops.utt_plan(b, k, t, c, a, e, itemsize, SMEM_OPTIN)
    assert plan is not None
    chunk, splits, smem = plan
    warps = ops.UTT_WARPS[itemsize]
    assert warps % splits == 0 and chunk == 16 * (warps // splits)
    assert splits == (4 if a == 256 else 2)
    assert smem == ops.utt_smem(k, t, c, a, e, itemsize, chunk, splits)
    assert 0 < smem <= SMEM_OPTIN


@pytest.mark.parametrize("why,shape", [
    ("c33", (128, 8, 174, 33, 256, 256, 2)),
    ("k17", (128, ops.UTT_MAX_K + 1, 174, 10, 256, 256, 2)),
    ("scores", (128, 8, 8_000, 10, 256, 256, 2)),
    ("scores_f32", (1, 16, 700, 32, 256, 256, 4)),
    ("itemsize", (128, 8, 174, 10, 256, 256, 8)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_utt_plan_refusals(why, shape):
    """Past the route's limits the plan is None (the "hyp" kernel runs):
    C > 32, K > 16, K x T scores that do not fit beside the rest at the
    smallest chunk, a dtype the kernel does not take."""
    assert ops.utt_plan(*shape, SMEM_OPTIN) is None


def test_utt_smem_by_hand():
    """The flagship decode in bfloat16 (K=8, T=174, C=10 -> CP=16,
    A=E=256), F=64, S=4, part by part."""
    stage = 2 * (64 * 256 * 2 + 16)
    feat_raw = 2 * 8 * (64 * 10 * 2 + 16)
    feat_pad = 8 * 64 * (16 + 8) * 2
    wloc = 256 * (16 + 8) * 2
    g, dec = 256 * 4, 8 * 256 * 2
    part, scores, ctx = 4 * 8 * 64 * 4, 174 * 8 * 4, 8 * 256 * 4
    # the raw dec, wloc and g (9,776 bytes) share part's, scores' and
    # ctx's bytes (21,952)
    total = (stage + feat_raw + feat_pad + wloc + g + dec + part + scores
             + ctx)
    assert total == 150_240
    assert ops.utt_smem(8, 174, 10, 256, 256, 2, 64, 4) == total
    assert ops.utt_plan(128, 8, 174, 10, 256, 256, 2, SMEM_OPTIN) == (
        64, 4, total)


@pytest.mark.parametrize("itemsize,b,want", [
    (2, 128, True), (2, 16, True), (2, 8, False),
    (4, 128, True), (4, 99, True), (4, 98, False), (4, 16, False)])
def test_utt_preferred_on_an_h100(itemsize, b, want):
    """On 132 SMs the "utt" route is the default from B=14 in bfloat16 and
    from B=99 in float32 (where it fits); below, the "hyp" kernel's B x K
    blocks are faster."""
    assert ops.utt_preferred(b, itemsize, 132) is want


def test_force_att_route_refuses_unknown_route():
    with pytest.raises(ValueError, match="unknown route"):
        with ops._force_att_route("cluster"):
            pass


@pytest.mark.parametrize("route", ["utt", "hyp"])
def test_forced_route_on_cpu_runs_plain(route):
    """CPU tensors run the plain version under either forced route and
    leave every launch counter as it was."""
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, K, T, 4), (B, T, 24), (B, T, E), (B, K, 24),
                      (4, 24), (24,))]
    mask = torch.ones((B, T))
    launches = ops.att_loc_step.launches
    routes = dict(ops.ATT_ROUTE_LAUNCHES)
    calls = ops.att_loc_step_plain.calls
    with ops._force_att_route(route):
        got = ops.att_loc_step(*args, mask, 2.0)
    want = ops.location_attention(*args, mask, 2.0)
    assert ops.att_loc_step.launches == launches
    assert ops.ATT_ROUTE_LAUNCHES == routes
    assert ops.att_loc_step_plain.calls == calls + 1
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, rtol=0, atol=0)


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
