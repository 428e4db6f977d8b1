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
# encoder 0 and 1) and the D-step's two enhancer layers (B=32, T=286), at
# H=256; the reference model's (``tools/adversarial_benefit.py::
# jcfg_for("reference")``) at H=512: the decode's five (B=64: enhancer 0
# and 1, encoder 0, 1 and 2) and the D-step's two (B=32): (B, D, H,
# whether W_x's columns stay resident)
CLUSTER_LAYERS = [(128, 257, 256, True), (128, 512, 256, False),
                  (128, 2560, 256, False), (128, 256, 256, True),
                  (32, 257, 256, True), (32, 512, 256, False),
                  (64, 257, 512, False), (64, 1024, 512, False),
                  (64, 2560, 512, False), (64, 512, 512, False),
                  (32, 257, 512, False), (32, 1024, 512, False)]
H100 = dict(n_sm=132, smem_optin=232_448)
# clusters an H100 runs at once, one block an SM: 15 of 8 blocks, 7 of 16
H100_CLUSTERS = {8: 15, 16: 7}


@pytest.mark.parametrize("case", CLUSTER_LAYERS,
                         ids=[f"B{c[0]}-D{c[1]}-H{c[2]}"
                              for c in CLUSTER_LAYERS])
def test_cluster_plan_fits_the_flagship_layers(case):
    """Every flagship and reference layer takes the cluster route on an
    H100: at H=256 clusters of 8 blocks of 32 units, 32-row groups at
    B=128, where 16 clusters of 16-row groups would exceed the 15 the card
    runs at once, 16-row ones at B=32, W_x resident where it fits (D=256,
    257); at H=512 clusters of 16 blocks of 32 units, 32-row groups at
    B=64 (8 clusters of 16 rows, the card runs 7), 16-row ones at B=32,
    half the pairs a chunk, W_x streamed at every D."""
    b, d, h, resident = case
    c_want = h // ops.CLUSTER_UNITS
    plan = ops.cluster_plan(b, d, h, 2, **H100,
                            max_clusters=H100_CLUSTERS[c_want])
    assert plan is not None
    c, r, f, res, smem = plan
    pairs = ops.CLUSTER_PAIRS if h == 256 else ops.CLUSTER_PAIRS_WIDE
    r_want = 16 if b == 32 else 32
    assert (c, r, f, res) == (c_want, r_want, pairs // r_want, resident)
    assert smem == ops.cluster_smem(h, c, r, ops._round_up(d, 16), res)
    assert smem <= H100["smem_optin"]
    # without the card's count, the plan takes n_sm // C = 16 clusters of
    # 8 blocks, 8 of 16
    assert ops.cluster_plan(b, d, h, 2, **H100)[1] == 16


# (itemsize, H, shared memory a block may take)
REFUSED = [
    (2, 200, 232_448),  # bf16 H not a multiple of 16
    (4, 256, 232_448),  # f32
    (4, 64, 232_448),  # f32, small H
    (2, 1024, 232_448),  # bf16 H=1,024: 64 units a block even at C=16
    (2, 80, 232_448),  # no cluster size gives a multiple of 8 units <= 32
    (2, 256, 100_000),  # the W_h slice's block over the budget
    (4, 512, 232_448),  # f32 at the reference width
    (2, 384, 232_448),  # past 256 rows only H=512: 24 units at C=16
    (2, 512, 180_000),  # H=512's block (W_h's shared part) over the budget
]


@pytest.mark.parametrize("case", REFUSED,
                         ids=["H200", "f32", "f32-H64", "H1024", "H80",
                              "small-smem", "f32-H512", "H384",
                              "H512-small-smem"])
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


@pytest.mark.parametrize("r", [16, 32])
def test_cluster_smem_is_the_hand_sum_at_h512(r):
    """One block at the reference encoder's layer 0 (H=512, C=16, D=2,560,
    W_x streamed), byte by byte: 64 pairs a chunk, W_h's rows 256-511 of
    the block's 128 columns in shared memory; both row groups fit the
    H100's 232,448 bytes."""
    x_stages = 2 * 64 * 64 * 2  # two (64 pairs, 64 columns) bf16 boxes
    wx_stages = 2 * 128 * 64 * 2  # two staged slices of 128 columns
    wh_shared = 128 * (512 - 256) * 2  # (4 n_u, H - 256) bf16: 64 KB
    h_buffers = 2 * 16 * r * (32 + 8) * 2  # (2, C, R, n_u + 8) bf16
    gx = 64 * 128 * 4  # (pairs, 4 n_u) float32
    rest = 1024 + r * 4 + 7 * 8  # alignment, lengths, mbarriers
    smem = ops.cluster_smem(512, 16, r, 2560, False)
    assert smem == (x_stages + wx_stages + wh_shared + h_buffers + gx
                    + rest)
    assert smem == {16: 189_560, 32: 230_584}[r] <= 232_448
    # W_x resident at D=257 (5 slices) does not fit beside W_h's part
    assert ops.cluster_smem(512, 16, 16, 272, True) > 232_448


def test_cluster_constants_are_the_kernels():
    """The plan's constants are those of ``csrc/blstm_infer_cluster.cu``:
    the slice width, the h rows' padding, the units a block (4 a warp),
    the rows of W_h a warp holds in registers and the one H past them, the
    pairs a chunk with and without W_h's shared part, and the cluster
    sizes its entry point takes."""
    import re
    from robust_e2e_gan_torch.utils.build import CSRC

    with open(f"{CSRC}/blstm_infer_cluster.cu") as f:
        src = f.read()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["DS"] == ops.CLUSTER_SLICE
    assert const["PAD"] == ops._PAD
    assert const["NT"] // 32 * 4 == ops.CLUSTER_UNITS
    assert 16 * const["KMAX"] == ops.CLUSTER_KREG
    assert 16 * const["KMAX"] + const["KW"] == ops.CLUSTER_WIDE_H
    pairs = re.search(r"return wide \? (\d+) : (\d+);", src)
    assert (int(pairs[1]), int(pairs[2])) == (ops.CLUSTER_PAIRS_WIDE,
                                              ops.CLUSTER_PAIRS)
    entry = src[src.index('extern "C" int blstm_infer_cluster('):]
    sizes = re.search(r"if \((C != \d+(?: && C != \d+)*)\)", entry)[1]
    assert tuple(int(c) for c in re.findall(r"\d+", sizes)) == (
        ops.CLUSTER_SIZES)


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


@pytest.mark.parametrize("h, c", [(256, 8), (64, 2), (48, 2), (512, 16)])
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


# ---------------------------------------------------------------------------
# the gate-stream recurrence's grid route (csrc/blstm_gx_grid.cu), without
# the card: its plan, packing and arithmetic
# ---------------------------------------------------------------------------

# (B, H, itemsize): (units a block, resident rows, chunks in flight, m16
# tiles and 16-column groups a warp, k splits) on an H100
GX_FITS = [
    # row 1b's shape, the enhancer layer in bf16 at B=128
    ((128, 256, 2), (4, 256, 8, 1, 1, 1)),
    # the wide encoder (H = 1,024) in float32 and bf16, and its B=16 slice
    ((128, 1024, 4), (16, 416, 3, 2, 2, 1)),
    ((128, 1024, 2), (16, 1024, 6, 2, 2, 1)),
    ((16, 1024, 4), (16, 640, 3, 1, 1, 2)),
    # B=112: 7 m16 tiles staged as 8
    ((112, 1024, 2), (16, 1024, 6, 2, 2, 1)),
    # phase 3's oversize layer (B=16, H=256, bf16)
    ((16, 256, 2), (4, 256, 8, 1, 1, 8)),
    # H = 768 (3 column groups: no pairs) and 512 in float32, B not a
    # multiple of 16
    ((128, 768, 4), (12, 576, 3, 4, 1, 1)),
    ((5, 512, 4), (8, 512, 8, 1, 1, 4)),
    ((5, 32, 2), (4, 32, 2, 1, 1, 8)),
]


@pytest.mark.parametrize("case", GX_FITS,
                         ids=[f"B{c[0][0]}-H{c[0][1]}-i{c[0][2]}"
                              for c in GX_FITS])
def test_gx_plan_fits(case):
    """64 blocks a direction (32 at H=32), each the fewest units that fit
    one block an SM; all of W_h's slice resident in bf16, the most rows
    that fit beside three chunks in flight in float32 at H >= 768; k
    splits where the warp tiles are fewer than the 8 warps; at B=128, H=768
    as many tiles as four warps' fit: 6 tile groups of 8 warps."""
    (b, h, itemsize), want = case
    plan = ops.gx_plan(b, h, itemsize, **H100)
    assert plan is not None
    assert (plan.units, plan.resident, plan.stages, plan.m_tiles,
            plan.col_groups, plan.k_splits) == want
    assert plan.blocks * plan.units == h and 2 * plan.blocks <= H100["n_sm"]
    tile = (plan.m_tiles, plan.col_groups, plan.k_splits)
    assert plan.smem == ops.gx_smem(b, h, plan.units, itemsize, plan.resident,
                                    plan.stages, *tile)
    assert plan.smem <= H100["smem_optin"]
    tiles = (-(-ops._round_up(b, 16) // 16 // plan.m_tiles)
             * (plan.units // 4 // plan.col_groups))
    assert tiles * plan.k_splits <= ops.GX_WARPS
    if plan.resident < h:  # one more 32-row piece would not fit
        assert ops.gx_smem(b, h, plan.units, itemsize,
                           plan.resident + ops.GX_CHUNK, plan.stages,
                           *tile) > H100["smem_optin"]


# (B, H, itemsize, SMs, shared memory a block may take)
GX_REFUSED = [
    (128, 200, 2, 132, 232_448),  # H not a multiple of 32
    (5, 16, 4, 132, 232_448),  # H below one chunk
    (256, 1024, 2, 132, 232_448),  # 16 m16 tiles x 4 groups past 8 warps
    (128, 2048, 2, 132, 232_448),  # H past MAX_HIDDEN
    (128, 1024, 4, 132, 100_000),  # not even the stages fit
    (128, 256, 2, 1, 232_448),  # one SM: no two blocks
]


@pytest.mark.parametrize("case", GX_REFUSED,
                         ids=["H200", "H16", "B256", "H2048", "small-smem",
                              "one-SM"])
def test_gx_plan_refuses(case):
    assert ops.gx_plan(*case) is None


def test_gx_smem_is_the_hand_sum():
    """Two blocks byte by byte: the wide bf16 layer (all of W_h resident,
    6 stages) and the float32 B=16 slice (640 rows resident, 3 stages of h
    and W_h, two k slices)."""
    w_res = 1024 * (64 + 8) * 2  # (H, 4 n_u + 8) bf16
    h_st = 6 * 128 * 32 * 2  # 6 x (MA, KC) bf16
    gx = 128 * (64 + 4) * 4  # (M, 4 n_u + 4) float32
    lens = 528  # (M + 1) int32, rounded up to 16 bytes
    bars = 48  # 6 mbarriers
    assert ops.gx_smem(128, 1024, 16, 2, 1024, 6, 2, 2, 1) == (
        w_res + h_st + gx + lens + bars)
    w_res = 640 * (64 + 8) * 4
    h_st = 3 * 16 * 32 * 4
    w_st = 3 * 32 * (64 + 8) * 4  # the streamed rows' stages
    gx = 16 * (64 + 4) * 4
    red = 1 * 4 * 1 * 32 * 8 * 4  # (k splits - 1) x groups x tiles x lanes x 8
    lens = 80
    bars = 32  # 3 mbarriers, rounded up to 16 bytes
    assert ops.gx_smem(16, 1024, 16, 4, 640, 3, 1, 1, 2) == (
        w_res + h_st + w_st + gx + red + lens + bars)
    # B=112 at 2 x 2 warp tiles: 7 m16 tiles staged as 8, the eighth zeros
    assert ops.gx_smem(112, 1024, 16, 2, 1024, 6, 2, 2, 1) - ops.gx_smem(
        128, 1024, 16, 2, 1024, 6, 2, 2, 1) == -(16 * (64 + 4) * 4 + 64)
    # the k slices' sums of 2 x 2 warp tiles: 8 floats a lane, tile and group
    assert ops.gx_smem(32, 1024, 16, 2, 1024, 6, 2, 2, 2) - ops.gx_smem(
        32, 1024, 16, 2, 1024, 6, 2, 2, 1) == 1 * 2 * 2 * 2 * 32 * 8 * 4


def test_gx_constants_are_the_kernels():
    """The plan's constants are those of ``csrc/blstm_gx_grid.cu``."""
    import re
    from robust_e2e_gan_torch.utils.build import CSRC

    with open(f"{CSRC}/blstm_gx_grid.cu") as f:
        src = f.read()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["NT"] // 32 == ops.GX_WARPS
    assert const["KC"] == ops.GX_CHUNK
    assert const["MW_MAX"] == ops.GX_TILES[-1]
    assert const["MAX_STAGES"] == ops.GX_STAGES
    from robust_e2e_gan_torch.utils.impl import BARRIER_LINE
    assert const["LINE"] == BARRIER_LINE


@pytest.mark.parametrize("h, n_u", [(256, 4), (1024, 16), (96, 12)])
def test_gx_pack_as_the_lanes_read_it(h, n_u):
    """Block p's slice of ``gx_pack``: (H, 4 n_u + 8), the columns of group q
    (16 a group of 4 units) such that lane (g, t) of an m16n8 tile pair
    reads i and f of unit 4 q + t from columns 2t and 2t + 1 of the first
    n8 tile and g and o from those of the second: the four gates of one
    unit, for the cell in registers."""
    wh = torch.arange(4 * h).float().expand(2, h, 4 * h) + torch.arange(
        h).float()[None, :, None] * 1e5
    wh = wh + torch.tensor([0.0, 1e9])[:, None, None]
    packed = ops.gx_pack(wh, n_u)
    p = h // n_u
    assert packed.shape == (2, p, h, 4 * n_u + 8)
    assert not packed[..., 4 * n_u:].any()  # the rows' padding
    for z in (0, 1):
        for blk in (0, p - 1):
            for q in range(n_u // 4):
                for lane in range(32):
                    t = lane % 4
                    unit = blk * n_u + 4 * q + t
                    for j, gates in ((0, (0, 1)), (1, (2, 3))):
                        for e, gate in enumerate(gates):
                            col = q * 16 + j * 8 + 2 * t + e
                            for k in (0, h - 1):
                                assert packed[z, blk, k, col] == wh[
                                    z, k, gate * h + unit]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (to nearest, ties away: common.cuh's tf32) by
    masking its float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _grid_products(a, w, itemsize, k_splits):
    """a (B, H) @ w (H, 4H) as the grid route sums it: each k step's
    product apart (bf16: k16 steps of exact products; float32: k8 steps of
    lo hi + hi lo + hi hi in tf32), the steps of each k slice (step modulo
    k_splits) added in float32 in order, then the slices in order."""
    kstep = 16 if itemsize == 2 else 8
    steps = a.shape[1] // kstep
    a3 = a.reshape(a.shape[0], steps, kstep).transpose(0, 1).double()
    w3 = w.reshape(steps, kstep, w.shape[1]).double()
    if itemsize == 2:
        d = (a3 @ w3).float()
    else:
        ah, wh = _tf32(a3.float()).double(), _tf32(w3.float()).double()
        al = _tf32((a3 - ah).float()).double()
        wl = _tf32((w3 - wh).float()).double()
        d = (al @ wh + ah @ wl + ah @ wh).float()
    total = None
    for ks in range(k_splits):
        part = torch.zeros(d.shape[1:])
        for step in range(ks, steps, k_splits):
            part = part + d[step]
        total = part if total is None else total + part
    return total


def _grid_route_emulated(gx, wh, lengths, plan):
    """The grid route's arithmetic on the CPU: per direction and frame,
    h_{t-1} rounded to wh's dtype, ``_grid_products`` with the plan's k
    splits, the float32 cell; rows past their length keep their state and
    write nothing; pad frames zeros."""
    b, t = gx.shape[:2]
    h = wh.shape[1]
    lengths = lengths.long().clamp(0, t)
    out = torch.zeros(b, t, 2 * h)
    rows = torch.arange(b)
    for z in (0, 1):
        w = wh[z].float()
        hs, c = torch.zeros(b, h), torch.zeros(b, h)
        for s in range(int(lengths.max())):
            acc = (_grid_products(hs.to(wh.dtype).float(), w,
                                  wh.element_size(), plan.k_splits)
                   if s > 0 else torch.zeros(b, 4 * h))
            live = s < lengths
            tt = (torch.full((b,), s) if z == 0 else lengths - 1 - s).clamp(
                0, t - 1)
            gates = gx[rows, tt, z] + acc
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            cn = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            hn = torch.sigmoid(go) * torch.tanh(cn)
            c = torch.where(live[:, None], cn, c)
            hs = torch.where(live[:, None], hn, hs)
            out[rows[live], tt[live], z * h:(z + 1) * h] = hn[live]
    return out.to(wh.dtype)


@pytest.mark.parametrize("dt", list(DTYPES), ids=list(DTYPES))
def test_grid_route_arithmetic_matches_jax_kernel(dt, monkeypatch):
    """The grid route's arithmetic, emulated on the CPU at its H100 plan
    (8 k slices at B=2, H=32), against the interpreted JAX ``_gx_kernel``
    at the oversize layer's set-up (W_x over the 64 MB budget), and
    against the port's plain version with h rounded."""
    tdt, jdt = DTYPES[dt]
    b, t, d, h = 2, 5, 40_000, 32
    lens = [5, 3]
    params, x = _inputs(1, b, t, d, h)
    assert _jax_variant(b, t, d, h, jdt) == "gx"
    if dt == "bf16":
        _einsum_in_a_cpu_layout(monkeypatch)
    want = _jax_infer(x, lens, params, jdt)
    plan = ops.gx_plan(b, h, torch.finfo(tdt).bits // 8, **H100)
    assert plan.k_splits == 8
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    from robust_e2e_gan_torch.models.rnn import input_projection
    gx = input_projection(torch.from_numpy(x), p["wx"], p["bias"], tdt)
    wh = p["wh"].to(tdt)
    lengths = torch.tensor(lens)
    got = _grid_route_emulated(gx, wh, lengths, plan)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dt])
    plain = ops.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **TOL[dt])
    assert not got[1, 3:].any()


@pytest.mark.parametrize("dt", list(DTYPES), ids=list(DTYPES))
def test_grid_route_arithmetic_wide_and_ragged(dt):
    """The emulated grid route at H=256 (bf16: k16 steps; float32: k8
    steps of three tf32 products, two k slices at B=16 H=1,024's plan
    shape) with ragged lengths 0, 1 and T, against the plain version."""
    tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(6)
    b, t, h = 6, 9, 256
    gx = torch.from_numpy(rng.standard_normal((b, t, 2, 4 * h)).astype(
        np.float32))
    wh = torch.from_numpy((rng.standard_normal((2, h, 4 * h)) / 16).astype(
        np.float32)).to(tdt)
    lengths = torch.tensor([t, 1, 0, 7, t - 1, 4])
    plan = ops.gx_plan(b, h, torch.finfo(tdt).bits // 8, **H100)
    plan = plan._replace(k_splits=2)
    got = _grid_route_emulated(gx, wh, lengths, plan)
    want = ops.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **TOL[dt])
    pad = torch.arange(t)[None] >= lengths[:, None]
    assert not got[pad].any()


@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("d", [2560, 1024])
def test_wide_f32_encoder_takes_the_gate_stream_kernel(d, b):
    """A 1,024-wide float32 encoder (hidden = proj = 1,024): layer 0 reads
    the VGG output (D = 2,560 at 80 mels), layers 1 and 2 the projection
    (D = 1,024). Both packages send every layer to the gate-stream kernel
    (W_x and W_h together past the 64 MB budget), which the grid route
    runs on an H100."""
    t, h = 174, 1024
    assert ops.infer_kernel_for(b, t, d, h, torch.float32) == "gx"
    assert blstm_pallas.infer_fits(b, h, 4)
    assert _jax_variant(b, t, d, h, jnp.float32) == "gx"
    assert ops.gx_plan(b, h, 4, **H100) is not None


def test_force_gx_route_names_a_route():
    with pytest.raises(ValueError, match="unknown route"):
        with ops._force_gx_route("cuDNN"):
            pass
    with ops._force_gx_route("row_tiled"):
        assert ops._forced_gx_route == "row_tiled"
    assert ops._forced_gx_route is None


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: parameters are trainable, and
    the inference-only kernel wrappers refuse inputs autograd records."""
    with torch.no_grad():
        yield
