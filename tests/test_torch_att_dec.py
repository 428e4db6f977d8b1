"""The port's fused decoder step (``ops/att_dec.py``, through
``DecoderStep`` with ``step_impl="fused"``) against the JAX package's
``att_dec_step_fused`` in interpret mode, on the CPU, float32; and which
step each configuration takes."""

import dataclasses
import types

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models.attention import (  # noqa: E402
    EncoderProjection as JaxEncoderProjection,
)
from robust_e2e_gan_tpu.models.attention import (  # noqa: E402
    initial_alignment as jax_initial_alignment,
)
from robust_e2e_gan_tpu.models.decoder import DecoderStep as JaxDecoderStep  # noqa: E402
from robust_e2e_gan_tpu.ops.att_pallas import att_dec_step_fused  # noqa: E402
from robust_e2e_gan_torch.config import AttentionConfig, DecoderConfig  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax  # noqa: E402
from robust_e2e_gan_torch.models.decoder import DecoderStep  # noqa: E402
from robust_e2e_gan_torch.ops import att, att_dec  # noqa: E402

B, K, T, E = 4, 3, 20, 40
V, EMB, H, A = 12, 16, 24, 24
ACFG = AttentionConfig(dim=A, conv_channels=4, conv_kernel=11,
                       score_impl="auto")
DCFG = DecoderConfig(vocab_size=V, embed_dim=EMB, hidden_dim=H,
                     step_impl="fused")


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _inputs(seed):
    """Encoder rows on ragged masks, a non-trivial LSTM state and the
    uniform first alignment, from a numpy seed."""
    rng = np.random.default_rng(seed)
    lens = np.array([20, 13, 7, 16])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    n = B * K
    return dict(
        enc=rng.standard_normal((B, T, E)).astype(np.float32),
        mask=mask,
        tok=rng.integers(-1, V, size=(n,)).astype(np.int32),
        h0=(rng.standard_normal((1, n, H)) * 0.3).astype(np.float32),
        c0=(rng.standard_normal((1, n, H)) * 0.3).astype(np.float32),
        att0=np.repeat(np.asarray(jax_initial_alignment(jnp.asarray(mask))),
                       K, axis=0),
    )


def _jax_step(x, dcfg, acfg, seed):
    """(params, enc_proj, new carry, logits, att) of the JAX step."""
    enc, mask = jnp.asarray(x["enc"]), jnp.asarray(x["mask"])
    ep_mod = JaxEncoderProjection(_jax(acfg))
    enc_proj = ep_mod.apply(ep_mod.init(jax.random.PRNGKey(0), enc), enc)
    carry = (jnp.asarray(x["h0"]), jnp.asarray(x["c0"]),
             jnp.asarray(x["att0"]), jnp.full((B * K,), -1, jnp.int32))
    mod = JaxDecoderStep(_jax(dcfg), _jax(acfg))
    params = mod.init(jax.random.PRNGKey(seed), carry, jnp.asarray(x["tok"]),
                      enc, enc_proj, mask)
    new_carry, (logits, att_) = mod.apply(params, carry,
                                          jnp.asarray(x["tok"]), enc,
                                          enc_proj, mask)
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    return params, np.array(enc_proj), new_carry, logits, att_


def _port_step(x, params, enc_proj, dcfg, acfg):
    mod = DecoderStep(dcfg, acfg, E)
    mod.load_state_dict(from_flax(params))
    carry = (torch.from_numpy(x["h0"]), torch.from_numpy(x["c0"]),
             torch.from_numpy(x["att0"]),
             torch.full((B * K,), -1, dtype=torch.int32))
    return mod(carry, torch.from_numpy(x["tok"]), torch.from_numpy(x["enc"]),
               torch.from_numpy(enc_proj), torch.from_numpy(x["mask"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_decoder_step_matches_jax(seed):
    x = _inputs(seed)
    params, enc_proj, want_carry, want_logits, want_att = _jax_step(
        x, DCFG, dataclasses.replace(ACFG, score_impl="fused"), seed)
    calls = att_dec.att_dec_step_plain.calls
    carry, (logits, att_) = _port_step(x, params, enc_proj, DCFG, ACFG)
    # the CPU wrapper ran the fused step's plain version, once
    assert att_dec.att_dec_step_plain.calls == calls + 1
    # float32, the same arithmetic in another summation order
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(att_.numpy(), np.asarray(want_att), rtol=0,
                               atol=1e-6)
    for g, w in zip(carry[:2], want_carry[:2]):
        assert g.shape == (1, B * K, H)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(carry[3].numpy(),
                                  np.asarray(want_carry[3]))
    assert not att_[1 * K, 13:].any()  # exact zeros on pad frames


def _op_case(k, v, seed):
    """att_dec_step_fused in interpret mode against the port's wrapper on
    CPU tensors (its plain version) at B=4 ragged utterances of K lanes
    and a vocabulary of V."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    mask = (np.arange(T)[None] < np.array([[T], [3], [11], [0]])).astype(
        np.float32)
    arrays = (rnd(B, k, T, 4, scale=0.1), rnd(B, T, A), rnd(B, T, E),
              rnd(B, k, A), rnd(4, A), rnd(A, scale=0.3), mask)
    tok = rng.integers(0, v, size=(B, k)).astype(np.int32)
    rest = (rnd(v, EMB), rnd(EMB + E, 4 * H, scale=0.2),
            rnd(H, 4 * H, scale=0.2), rnd(4 * H, scale=0.3),
            rnd(H + E, v, scale=0.2), rnd(v, scale=0.3),
            rnd(B, k, H, scale=0.5), rnd(B, k, H, scale=0.5))
    want = att_dec_step_fused(*map(jnp.asarray, arrays), 2.0,
                              jnp.asarray(tok), *map(jnp.asarray, rest),
                              interpret=True)
    launches = att_dec.att_dec_step.launches
    got = att_dec.att_dec_step(*map(torch.from_numpy, arrays), 2.0,
                               torch.from_numpy(tok),
                               *map(torch.from_numpy, rest))
    assert att_dec.att_dec_step.launches == launches  # CPU: the plain version
    for g, w, atol in zip(got, want, (1e-5, 1e-6, 1e-5, 1e-5)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


def test_att_dec_op_matches_pallas_kernel():
    """The op-level contract of att_dec_step_fused: conv features, token
    ids, the cell and readout weights and the f32 state in; logits, the
    alignment and the new state out, all float32."""
    _op_case(K, V, 2)


def test_att_dec_op_matches_pallas_kernel_odd_beam_wide_vocab():
    """The same contract at K=5 lanes an utterance (not a multiple of the
    utt route's groups of 4 hypotheses) and V=200 (more than one 128-lane
    block of the JAX kernel's one-hot embedding and readout)."""
    _op_case(5, 200, 4)


@pytest.mark.parametrize("case", ["auto", "xla", "two_layers",
                                  "plain_score"])
def test_unfused_step_where_jax_takes_it(case):
    """``step_impl`` "auto" and "xla", two decoder layers, and a plain
    ``score_impl`` take the unfused step (the JAX gate); each still
    matches the JAX step."""
    dcfg, acfg = DCFG, ACFG
    if case in ("auto", "xla"):
        dcfg = dataclasses.replace(DCFG, step_impl=case)
    elif case == "two_layers":
        dcfg = dataclasses.replace(DCFG, num_layers=2)
    else:
        acfg = dataclasses.replace(ACFG, score_impl="xla")
    x = _inputs(3)
    if case == "two_layers":
        x["h0"] = np.concatenate([x["h0"], x["h0"][:, ::-1]], axis=0)
        x["c0"] = np.concatenate([x["c0"], -x["c0"]], axis=0)
    jax_acfg = (dataclasses.replace(acfg, score_impl="fused")
                if acfg.score_impl == "auto" else acfg)
    params, enc_proj, want_carry, want_logits, _ = _jax_step(
        x, dcfg, jax_acfg, 3)
    calls = (att_dec.att_dec_step_plain.calls, att.att_loc_step_plain.calls)
    carry, (logits, _) = _port_step(x, params, enc_proj, dcfg, acfg)
    assert att_dec.att_dec_step_plain.calls == calls[0]
    assert att.att_loc_step_plain.calls == calls[1] + 1
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(carry[0].numpy(), np.asarray(want_carry[0]),
                               rtol=1e-4, atol=1e-5)


def test_unknown_step_impl_raises():
    with pytest.raises(ValueError, match="unknown kernel impl"):
        DecoderStep(dataclasses.replace(DCFG, step_impl="fuse"), ACFG, E)


def test_shape_past_the_plan_raises_on_the_card_path(monkeypatch):
    """On CUDA tensors the wrapper raises beyond the kernel's shared-memory
    plan, where the JAX package falls back to the unfused step; it never
    reaches the launch."""
    def no_launch(*args):
        raise AssertionError("launched past the plan")

    monkeypatch.setattr(att_dec, "on_cuda", lambda *t: True)
    monkeypatch.setattr(att_dec, "launch", no_launch)
    k, t, e, embd, h = 64, 174, 512, 512, 256
    assert att_dec.smem_bytes(k, t, 10, 256, e, embd, h) > 232_448

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    with pytest.raises(ValueError, match="shared memory"):
        att_dec.att_dec_step(
            z(1, k, t, 10), z(1, t, 256), z(1, t, e), z(1, k, 256),
            z(10, 256), z(256), z(1, t), 2.0,
            z(1, k, dtype=torch.int32), z(V, embd), z(embd + e, 4 * h),
            z(h, 4 * h), z(4 * h), z(h + e, V), z(V), z(1, k, h), z(1, k, h))


# The decode shapes of the flagship (bf16) and of the decode CLI's model
# (f32): B, K, T, C, A, E, EMB, H, V, itemsize
PLAN_SHAPES = {"flagship-bf16-B128": (128, 8, 174, 10, 256, 256, 256, 256, 52, 2),
               "flagship-bf16-B16": (16, 8, 174, 10, 256, 256, 256, 256, 52, 2),
               "cli-f32-B128": (128, 8, 30, 10, 512, 512, 512, 512, 12, 4)}
H100_SMS, H100_SMEM = 132, 232_448


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_utt_plan_fits_the_decode_shapes(name):
    """The "utt" route's plan (integer arithmetic) fits the flagship's bf16
    decode at B=128 and B=16 and the CLI's f32 one on an H100: the whole
    vocabulary in one readout chunk, a grid of one block an utterance or a
    gate tile (at most one an SM), within the opt-in shared memory."""
    b, k, t, c, a, e, embd, h, v, isz = PLAN_SHAPES[name]
    plan = att_dec.utt_plan(b, k, t, c, a, e, embd, h, v, isz, H100_SMS,
                            H100_SMEM)
    assert plan is not None
    chunk, splits, vc, grid, smem = plan
    assert (chunk, splits) == att.utt_plan(b, k, t, c, a, e, isz,
                                           H100_SMEM)[:2]
    assert vc == v
    tiles = -(-b * k // 64) * -(-h // 32)
    assert grid == min(H100_SMS, max(b, tiles)) and grid <= H100_SMS
    assert smem == att_dec.utt_smem(k, t, c, a, e, h, isz, chunk, splits, vc)
    assert smem <= H100_SMEM


@pytest.mark.parametrize("change", ["k17", "c33", "h_not_8", "huge_readout"])
def test_utt_plan_none_past_its_limits(change):
    """None past K = 16 or C = 32 (the attention's plan), for an H that is
    not a multiple of 8, and where not one column of Wout fits beside the
    readout's lane rows."""
    b, k, t, c, a, e, embd, h, v, isz = PLAN_SHAPES["flagship-bf16-B128"]
    if change == "k17":
        k = 17
    elif change == "c33":
        c = 33
    elif change == "h_not_8":
        h = 252
    else:
        e = 8000
    assert att_dec.utt_plan(b, k, t, c, a, e, embd, h, v, isz, H100_SMS,
                            H100_SMEM) is None


def _kernel_constants():
    """TM, TU, the gates tile's row stride and KC (bf16, f32) as
    csrc/att_dec_utt.cu defines them."""
    import os
    import re

    path = os.path.join(os.path.dirname(att_dec.__file__), os.pardir,
                        "csrc", "att_dec_utt.cu")
    with open(path) as f:
        src = f.read()
    tm = int(re.search(r"constexpr int TM = (\d+);", src).group(1))
    tu = int(re.search(r"constexpr int TU = (\d+);", src).group(1))
    pad = int(re.search(r"constexpr int GS = TN \+ (\d+);", src).group(1))
    ns = int(re.search(r"constexpr int NS = (\d+);", src).group(1))
    kc = re.search(r"kChunk = std::is_same<T, bf16>::value \? (\d+) : (\d+);",
                   src)
    return (tm, tu, 4 * tu + pad, ns,
            {2: int(kc.group(1)), 4: int(kc.group(2))})


@pytest.mark.parametrize("shape", [(128, 8, 174, 10, 256, 256, 256, 52, 2),
                                   (3, 5, 37, 10, 64, 48, 40, 300, 4),
                                   (1, 1, 1, 1, 24, 48, 8, 9, 2),
                                   (128, 8, 30, 10, 512, 512, 512, 12, 4)])
def test_utt_smem_is_the_kernel_layout(shape):
    """``utt_smem`` is the largest of the kernel's three phases' layouts,
    with the tile constants read from the kernel's source: the attention's
    bytes, NS A and NS W buffers with rows 16 bytes longer than their data
    (or the float32 gates tile over them), and the readout's lane rows and
    chunk of Wout (rows padded to a multiple of 4, each part 16-byte
    aligned) then its partial sums: in bfloat16 in the tensor cores'
    layout, padded to 16 rows and columns."""
    b, k, t, c, a, e, h, v, isz = shape
    tm, tu, gs, ns, kc = _kernel_constants()
    assert (tm, tu, gs, ns, kc) == (
        att_dec.UTT_TILE_LANES, att_dec.UTT_TILE_UNITS,
        att_dec.UTT_GATE_STRIDE, att_dec.UTT_STAGES, att_dec.UTT_CHUNK)
    chunk, splits, _ = att.utt_plan(b, k, t, c, a, e, isz, H100_SMEM)
    piece = 16 // isz
    a_buf = tm * (kc[isz] + piece) * isz
    w_buf = kc[isz] * (4 * tu + piece) * isz
    hep = -(-(h + e) // 4) * 4

    def r16(x):
        return -(-x // 16) * 16

    for vc in (1, v):
        if isz == 2:  # bfloat16 lanes (16, KW + 8), Wout (KW, Vp + 8)
            kw, vp = r16(h) + r16(e), r16(vc)
            readout = (r16(16 * (kw + 8) * 2) + r16(kw * (vp + 8) * 2)
                       + 2 * k * 16 * max(16, vp // 16) * 4)
        else:  # float32 lanes (K, HEp), Wout (HEp, vc)
            readout = (r16(4 * k * hep) + r16(4 * hep * vc)
                       + 2 * k * max(256, vc) * 4)
        want = max(att.utt_smem(k, t, c, a, e, isz, chunk, splits),
                   ns * (a_buf + w_buf), tm * gs * 4, readout)
        assert att_dec.utt_smem(k, t, c, a, e, h, isz, chunk, splits,
                                vc) == want
    rows = att_dec.utt_row_width(40, e, h, isz)
    assert rows % kc[isz] == 0 and 0 <= rows - (40 + e + h) < kc[isz]


def test_force_dec_route_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="unknown route"):
        with att_dec._force_dec_route("lane"):
            pass
    assert att_dec._forced_dec_route is None


@pytest.mark.parametrize("k, h", [(17, 24), (3, 20)])
def test_forced_utt_route_past_the_plan_raises_on_the_card_path(
        monkeypatch, k, h):
    """On the card path, forcing route "utt" past its plan (K = 17, or H
    not a multiple of 8) raises before any launch; unforced, the same
    shapes go to the "hyp" kernel."""
    launched = []
    monkeypatch.setattr(att_dec, "on_cuda", lambda *t: True)
    monkeypatch.setattr(att_dec, "device_limits",
                        lambda index: (H100_SMS, H100_SMEM))
    monkeypatch.setattr(att_dec, "launch",
                        lambda name, *args: launched.append(name))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    att_dec._utt_plan_on.cache_clear()
    t, e, embd = 20, 40, 16

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    args = (z(2, k, t, 4), z(2, t, A), z(2, t, e), z(2, k, A), z(4, A),
            z(A), z(2, t), 2.0, z(2, k, dtype=torch.int32), z(V, embd),
            z(embd + e, 4 * h), z(h, 4 * h), z(4 * h), z(h + e, V), z(V),
            z(2, k, h), z(2, k, h))
    routes = dict(att_dec.DEC_ROUTE_LAUNCHES)
    with pytest.raises(ValueError, match="utt route does not fit"):
        with att_dec._force_dec_route("utt"):
            att_dec.att_dec_step(*args)
    assert launched == [] and att_dec.DEC_ROUTE_LAUNCHES == routes
    att_dec.att_dec_step(*args)
    assert launched == ["att_dec_step"]
    assert att_dec.DEC_ROUTE_LAUNCHES["hyp"] == routes["hyp"] + 1
    att_dec.DEC_ROUTE_LAUNCHES.update(routes)
    att_dec._utt_plan_on.cache_clear()


@pytest.fixture(autouse=True)
def _forward_only():
    """Forward values only: parameters are trainable, and the
    inference-only kernel wrappers refuse inputs autograd records."""
    with torch.no_grad():
        yield
