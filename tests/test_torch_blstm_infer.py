"""The port's inference BLSTM against the JAX package: the W_x-resident
``blstm_infer`` and the layer's kernel route against the Pallas
``blstm_infer`` (interpret mode) on both sides of its fit rule, the rule
itself, the ``scan`` route against the JAX scan, and ``gate_storage``;
and, without the card, the cluster route's plan, packing and reversed
input."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models.rnn import BLSTM as JaxBLSTM  # noqa: E402
from robust_e2e_gan_tpu.models.rnn import BLSTMP as JaxBLSTMP  # noqa: E402
from robust_e2e_gan_tpu.ops import blstm_pallas  # noqa: E402
from robust_e2e_gan_torch import config  # noqa: E402
from robust_e2e_gan_torch.convert import (  # noqa: E402
    blstm_params,
    dense_params,
    from_flax,
)
from robust_e2e_gan_torch.models.rnn import BLSTM, BLSTMP  # noqa: E402
from robust_e2e_gan_torch.ops import blstm as ops  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                         jnp.bfloat16)}
# float32: the same recurrence in another summation order, a few ulps of
# the O(1) hidden states; bfloat16: the same rounding points, so outputs
# differ by at most two bf16 ulps at O(1) (a float32 summation-order
# difference can flip a rounding, and the flip feeds the next frames)
TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=0, atol=4e-3)}
LENS = {"full": [11, 11, 11], "ragged": [11, 6, 0]}


def _inputs(seed, b, t, d, h):
    rng = np.random.default_rng(seed)
    params = {k: v.astype(np.float32)
              for k, v in blstm_params(rng, d, h).items()}
    params["bias"] += rng.uniform(-0.5, 0.5, (2, 4 * h)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return params, x


def _mask(lens, t):
    return (np.arange(t)[None] < np.asarray(lens)[:, None]).astype(np.float32)


def _jax_infer(x, lens, params, jdt):
    """The Pallas kernel, interpreted, on compute-dtype weights."""
    return np.asarray(blstm_pallas.blstm_infer(
        jnp.asarray(x), jnp.asarray(lens, jnp.int32),
        jnp.asarray(params["wx"]).astype(jdt),
        jnp.asarray(params["wh"]).astype(jdt), jnp.asarray(params["bias"]),
        interpret=True).astype(jnp.float32))


def _port_layer(params, d, h, dtype, impl, gate_storage="f32"):
    layer = BLSTM(d, h, dtype, impl, gate_storage)
    layer.load_state_dict(from_flax(params))
    return layer


@pytest.mark.parametrize("lens", list(LENS), ids=list(LENS))
@pytest.mark.parametrize("dt", list(DTYPES), ids=list(DTYPES))
def test_blstm_infer_matches_jax_kernel(dt, lens):
    """The plain version and the layer's ``auto`` route (the W_x-resident
    side of the fit rule) against the JAX kernel, pad frames exact
    zeros, a zero-length row all padding."""
    tdt, jdt = DTYPES[dt]
    b, t, d, h = 3, 11, 10, 8
    params, x = _inputs(0, b, t, d, h)
    assert ops.infer_kernel_for(b, t, d, h, tdt) == "fused"
    want = _jax_infer(x, LENS[lens], params, jdt)

    p = {k: torch.from_numpy(v) for k, v in params.items()}
    lengths = torch.tensor(LENS[lens], dtype=torch.int32)
    plain = ops.blstm_infer_plain(torch.from_numpy(x), lengths,
                                  p["wx"].to(tdt), p["wh"].to(tdt), p["bias"])
    calls = ops.blstm_infer_plain.calls
    launches = ops.blstm_infer.launches
    layer = _port_layer(params, d, h, tdt, "auto")
    got = layer(torch.from_numpy(x), torch.from_numpy(_mask(LENS[lens], t)))
    # on CPU tensors the wrapper takes the plain version
    assert ops.blstm_infer_plain.calls == calls + 1
    assert ops.blstm_infer.launches == launches
    assert got.dtype == plain.dtype == tdt
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dt])
    for bi, n in enumerate(LENS[lens]):
        assert not got[bi, n:].any()


def _einsum_in_a_cpu_layout(monkeypatch):
    """XLA's CPU backend refuses the bf16 x bf16 -> f32 product of
    ``blstm_infer``'s gate-stream branch in its (T, 2, B, 4H) output
    layout; compute the same products in the (2, B, T, 4H) layout and
    transpose."""
    einsum = jnp.einsum

    def patched(subscripts, *operands, **kw):
        if subscripts == "zbtd,zdg->tzbg":
            return jnp.transpose(
                einsum("zbtd,zdg->zbtg", *operands, **kw), (2, 0, 1, 3))
        return einsum(subscripts, *operands, **kw)

    monkeypatch.setattr(jnp, "einsum", patched)


@pytest.mark.parametrize("dt", list(DTYPES), ids=list(DTYPES))
def test_oversize_layer_takes_the_gate_stream_kernel(dt, monkeypatch):
    """Past the fit rule (W_x alone over the 64 MB budget) the layer's
    ``auto`` route is the gate-stream wrapper, which rounds h as the JAX
    ``_gx_kernel`` that ``blstm_infer`` takes there."""
    tdt, jdt = DTYPES[dt]
    b, t, d, h = 2, 5, 40_000, 8
    lens = [5, 3]
    params, x = _inputs(1, b, t, d, h)
    assert ops.infer_kernel_for(b, t, d, h, tdt) == "gx"
    assert _jax_variant(b, t, d, h, jdt) == "gx"
    if dt == "bf16":
        _einsum_in_a_cpu_layout(monkeypatch)
    want = _jax_infer(x, lens, params, jdt)

    counts = (ops.blstm_recurrence_plain.calls, ops.blstm_infer_plain.calls,
              ops.blstm_recurrence.launches, ops.blstm_infer.launches)
    layer = _port_layer(params, d, h, tdt, "auto")
    got = layer(torch.from_numpy(x), torch.from_numpy(_mask(lens, t)))
    assert (ops.blstm_recurrence_plain.calls, ops.blstm_infer_plain.calls,
            ops.blstm_recurrence.launches, ops.blstm_infer.launches) == (
        counts[0] + 1, counts[1], counts[2], counts[3])
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dt])
    assert not got[1, 3:].any()


def test_bf16_routes_round_as_their_jax_counterparts():
    """bf16, B=3, T=40, D=24, H=32, lengths [40, 25, 7]: ``scan`` equals
    the JAX scan bit for bit (h promoted to float32 for the recurrent
    product), and ``auto`` follows the JAX kernel (h rounded)."""
    b, t, d, h = 3, 40, 24, 32
    lens = [40, 25, 7]
    params, x = _inputs(2, b, t, d, h)
    mask = _mask(lens, t)
    want_scan = np.asarray(JaxBLSTM(h, dtype=jnp.bfloat16, impl="scan").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask)
    ).astype(jnp.float32))
    want_kernel = _jax_infer(x, lens, params, jnp.bfloat16)
    got = {impl: _port_layer(params, d, h, torch.bfloat16, impl)(
        torch.from_numpy(x), torch.from_numpy(mask)).float().numpy()
        for impl in ("scan", "auto")}
    np.testing.assert_array_equal(got["scan"], want_scan)
    np.testing.assert_allclose(got["auto"], want_kernel, **TOL["bf16"])
    assert np.abs(want_scan - want_kernel).max() > 0  # the two differ


def _find_pallas_call(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            return eqn
        for v in eqn.params.values():
            inner = getattr(v, "jaxpr", v)
            if hasattr(inner, "eqns"):
                found = _find_pallas_call(inner)
                if found is not None:
                    return found
    return None


def _jax_variant(b, t, d, h, jdt):
    """Which kernel the JAX ``blstm_infer`` builds at these shapes, read
    from its traced program: the W_x-resident call takes six operands
    (streams, W_x, W_h, bias, intervals), the gate-stream call four."""
    spec = jax.ShapeDtypeStruct
    closed = jax.make_jaxpr(
        lambda x, lens, wx, wh, bias: blstm_pallas.blstm_infer(
            x, lens, wx, wh, bias, interpret=True))(
        spec((b, t, d), jnp.float32), spec((b,), jnp.int32),
        spec((2, d, 4 * h), jdt), spec((2, h, 4 * h), jdt),
        spec((2, 4 * h), jnp.float32))
    eqn = _find_pallas_call(closed.jaxpr)
    return "fused" if len(eqn.invars) == 6 else "gx"


RULE_CASES = [
    # the flagship's layers at B=128: enhancer 0 and 1, encoder 0 (the VGG
    # output) and 1
    (128, 694, 257, 256, "bf16", "fused"),
    (128, 694, 512, 256, "bf16", "fused"),
    (128, 174, 2560, 256, "bf16", "fused"),
    (128, 174, 256, 256, "bf16", "fused"),
    # the train CLI's encoder layer 0
    (16, 72, 2560, 512, "f32", "fused"),
    # past the budget: a wide input, a wide hidden layer
    (128, 174, 16384, 256, "bf16", "gx"),
    (128, 174, 2560, 1024, "bf16", "gx"),
    (8, 20, 2560, 1024, "f32", "gx"),
]


@pytest.mark.parametrize("case", RULE_CASES,
                         ids=[f"B{c[0]}-D{c[2]}-H{c[3]}-{c[4]}"
                              for c in RULE_CASES])
def test_fit_rule_is_the_jax_rule(case):
    b, t, d, h, dt, want = case
    tdt, jdt = DTYPES[dt]
    assert ops.infer_kernel_for(b, t, d, h, tdt) == want
    itemsize = 2 if dt == "bf16" else 4
    assert ops.infer_fits(b, h, itemsize) == blstm_pallas.infer_fits(
        b, h, itemsize)
    jax_pick = (_jax_variant(b, t, d, h, jdt)
                if blstm_pallas.infer_fits(b, h, itemsize) else "gx")
    assert jax_pick == want


def test_fit_rule_where_jax_keeps_its_scan():
    """W_h and the carries over the budget: the JAX layer keeps its scan,
    the port takes the gate-stream kernel."""
    assert not blstm_pallas.infer_fits(1024, 1024, 2)
    assert ops.infer_kernel_for(1024, 10, 64, 1024, torch.bfloat16) == "gx"


def test_gate_storage_compute_matches_jax_scan():
    """``gate_storage="compute"`` rounds the bf16 scan's gate projections,
    as JAX ``rnn.py:243-248`` does; in float32 it is a no-op."""
    b, t, d, h = 3, 11, 10, 8
    lens = [11, 6, 9]
    params, x = _inputs(3, b, t, d, h)
    mask = _mask(lens, t)
    out = {}
    for storage in ("f32", "compute"):
        want = JaxBLSTM(h, dtype=jnp.bfloat16, impl="scan",
                        gate_storage=storage).apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(mask))
        got = _port_layer(params, d, h, torch.bfloat16, "scan", storage)(
            torch.from_numpy(x), torch.from_numpy(mask))
        out[storage] = got.float().numpy()
        np.testing.assert_array_equal(out[storage],
                                      np.asarray(want.astype(jnp.float32)))
    assert np.abs(out["f32"] - out["compute"]).max() > 0
    f32 = [_port_layer(params, d, h, torch.float32, "scan", s)(
        torch.from_numpy(x), torch.from_numpy(mask)) for s in ("f32",
                                                               "compute")]
    torch.testing.assert_close(f32[0], f32[1], rtol=0, atol=0)


def test_blstmp_gate_storage_compute_matches_jax():
    rng = np.random.default_rng(4)
    params = {"blstm0": blstm_params(rng, 10, 8),
              "proj0": dense_params(rng, 16, 6),
              "blstm1": blstm_params(rng, 6, 8),
              "proj1": dense_params(rng, 16, 6)}
    params = {k: {n: a.astype(np.float32) for n, a in v.items()}
              for k, v in params.items()}
    x = rng.standard_normal((3, 9, 10)).astype(np.float32)
    mask = _mask([9, 4, 7], 9)
    want = JaxBLSTMP(2, 8, 6, dtype=jnp.bfloat16,
                     gate_storage="compute").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask))
    stack = BLSTMP(10, 2, 8, 6, torch.bfloat16, gate_storage="compute")
    stack.load_state_dict(from_flax(params))
    got = stack(torch.from_numpy(x), torch.from_numpy(mask))
    # the bf16 projection and tanh between the layers may round apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=4e-3)


def test_gate_storage_reaches_the_configuration():
    """``from_dict`` of a JAX configuration keeps the field, the train CLI
    passes ``--gate-storage`` on, and the decode CLI forces "f32" as the
    JAX decode CLI does."""
    from robust_e2e_gan_torch.decode import cli as decode_cli
    from robust_e2e_gan_torch.train import cli as train_cli

    jcfg = jax_config.JointConfig(
        e2e=jax_config.E2EConfig(
            encoder=jax_config.EncoderConfig(gate_storage="compute")),
        enhancer=jax_config.EnhancerConfig(gate_storage="compute"))
    ours = config.from_dict(config.JointConfig, dataclasses.asdict(jcfg))
    assert ours.e2e.encoder.gate_storage == "compute"
    assert ours.enhancer.gate_storage == "compute"

    args = train_cli.build_parser().parse_args(
        ["--synthetic", "--ckpt-dir", "unused", "--gate-storage", "compute"])
    cli_cfg, _ = train_cli.configs_from_args(args, 12)
    assert cli_cfg.e2e.encoder.gate_storage == "compute"
    assert cli_cfg.enhancer.gate_storage == "compute"

    served = decode_cli.with_serving_impls(ours, "auto")
    assert served.e2e.encoder.gate_storage == "f32"
    assert served.enhancer.gate_storage == "f32"


# the flagship decode's four BLSTM layers (B=128: enhancer 0 and 1,
# encoder 0 and 1) and the D-step's two enhancer layers (B=32, T=286):
# (B, D, whether W_x's columns stay resident)
CLUSTER_LAYERS = [(128, 257, True), (128, 512, False), (128, 2560, False),
                  (128, 256, True), (32, 257, True), (32, 512, False)]
H100 = dict(n_sm=132, smem_optin=232_448)


@pytest.mark.parametrize("case", CLUSTER_LAYERS,
                         ids=[f"B{c[0]}-D{c[1]}" for c in CLUSTER_LAYERS])
def test_cluster_plan_fits_the_flagship_layers(case):
    """Every flagship layer takes the cluster route on an H100: clusters of
    8 blocks of 32 units; 32-row groups at B=128, where 16 clusters of
    16-row groups would exceed the 15 the card runs at once, 16-row ones
    at B=32; W_x resident where it fits (D=256, 257)."""
    b, d, resident = case
    plan = ops.cluster_plan(b, d, 256, 2, **H100, max_clusters=15)
    assert plan is not None
    c, r, f, res, smem = plan
    assert (c, r, f, res) == (8, 32 if b == 128 else 16,
                              4 if b == 128 else 8, resident)
    assert smem == ops.cluster_smem(256, c, r, ops._round_up(d, 16), res)
    assert smem <= H100["smem_optin"]
    # without the card's count, the plan takes n_sm // C = 16 clusters
    assert ops.cluster_plan(b, d, 256, 2, **H100)[1] == 16


# (itemsize, H, shared memory a block may take)
REFUSED = [
    (2, 200, 232_448),  # bf16 H not a multiple of 16
    (4, 256, 232_448),  # f32
    (4, 64, 232_448),  # f32, small H
    (2, 512, 232_448),  # bf16 H=512: 64 units a block at C=8
    (2, 80, 232_448),  # no cluster size gives a multiple of 8 units <= 32
    (2, 256, 100_000),  # the W_h slice's block over the budget
]


@pytest.mark.parametrize("case", REFUSED,
                         ids=["H200", "f32", "f32-H64", "H512", "H80",
                              "small-smem"])
def test_cluster_plan_refuses(case):
    itemsize, h, smem_optin = case
    assert ops.cluster_plan(128, 257, h, itemsize, 132, smem_optin) is None


def test_cluster_smem_is_the_hand_sum():
    """One block at the flagship's enhancer layer 0 (H=256, C=8, R=32,
    D=257 padded to 272, W_x resident), byte by byte."""
    x_stages = 2 * 128 * 64 * 2  # two (pairs, 64 columns) bf16 boxes
    wx_resident = 5 * 128 * 64 * 2  # ceil(272 / 64) slices of 128 columns
    h_buffers = 2 * 8 * 32 * (32 + 8) * 2  # (2, C, R, n_u + 8) bf16
    gx = 128 * 128 * 4  # (pairs, 4 n_u) float32
    rest = 1024 + 32 * 4 + 7 * 8  # alignment, lengths, mbarriers
    assert ops.cluster_smem(256, 8, 32, 272, True) == (
        x_stages + wx_resident + h_buffers + gx + rest)
    assert ops.cluster_smem(256, 8, 32, 272, False) == (
        x_stages + 2 * 128 * 64 * 2 + h_buffers + gx + rest)


@pytest.mark.parametrize("b, fit, rows, groups",
                         [(1, 15, 16, 1), (17, 15, 16, 2), (112, 15, 16, 7),
                          (113, 15, 32, 4), (150, 15, 32, 5),
                          (150, 20, 16, 10)])
def test_cluster_plan_row_groups(b, fit, rows, groups):
    """B not a multiple of R gives ceil(B / R) groups (the last one padded
    with rows the kernel reads as zeros); R doubles only where the 16-row
    groups' 2 ceil(B / 16) clusters exceed those the card runs at once."""
    plan = ops.cluster_plan(b, 257, 256, 2, **H100, max_clusters=fit)
    assert plan[1] == rows and -(-b // plan[1]) == groups
    assert plan[2] * plan[1] == ops.CLUSTER_PAIRS


@pytest.mark.parametrize("h, c", [(256, 8), (64, 2), (48, 2)])
def test_cluster_pack_orders_each_warps_gates(h, c):
    """Block j's packed columns: 16 per group of 4 units, (i f) of each
    unit, then (g o) of each unit, so lane t of an m16n8 tile pair holds
    i, f, g, o of unit t; W_x and W_h transposed (block, column, k)."""
    d, n_u = 5, h // c
    wx = torch.arange(4 * h).float().expand(2, d, 4 * h) * 10 + torch.arange(
        d).float()[None, :, None]
    wh = torch.arange(4 * h).float().expand(2, h, 4 * h).contiguous()
    bias = torch.arange(2 * 4 * h).float().view(2, 4 * h)
    wxp, whp, bp = ops._cluster_pack(wx, wh, bias, 16, c)
    assert wxp.shape == (2, c, 4 * n_u, 16) and whp.shape == (2, c, 4 * n_u, h)
    for j in range(c):
        for col in range(4 * n_u):
            grp, w = divmod(col, 16)
            unit = j * n_u + grp * 4 + (w % 8) // 2
            gate = (w // 8) * 2 + w % 2
            want = gate * h + unit
            assert whp[1, j, col, 3] == want
            assert bp[1, j * 4 * n_u + col] == 4 * h + want
            assert wxp[0, j, col, 2] == want * 10 + 2
    assert not wxp[..., d:].any()  # W_x's padded rows are zeros


def test_reversed_rows_reverses_each_row_to_its_length():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 6, 16)).astype(np.float32))
    lengths = torch.tensor([6, 2, 0])
    got = ops._reversed_rows(x, lengths)
    for b, n in enumerate(lengths.tolist()):
        torch.testing.assert_close(got[b, :n], x[b, :n].flip(0), rtol=0,
                                   atol=0)


def test_force_infer_route_names_a_route():
    with pytest.raises(ValueError, match="unknown route"):
        with ops._force_infer_route("cuDNN"):
            pass
    with ops._force_infer_route("cluster"):
        assert ops._forced_infer_route == "cluster"
    assert ops._forced_infer_route is None


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: parameters are trainable, and
    the inference-only kernel wrappers refuse inputs autograd records."""
    with torch.no_grad():
        yield
