"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
one (and nvcc), run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import contextlib

import pytest
import torch

from robust_e2e_gan_torch.ops import att, blstm, ctc_prefix

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, want):
    # float32: summation order only; bf16: one rounding of the outputs
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-5)
    return dict(rtol=0, atol=2e-2 * want.abs().max().item())


def _rec_inputs(gen, dev, b, t, h, dtype):
    """gx, wh and lengths of a gate-stream layer: the first five rows'
    lengths T, 1, 0, 17, T - 1, the others at random in [0, T]."""
    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    lengths = torch.randint(0, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[:5] = torch.tensor([t, 1, 0, 17, t - 1], dtype=torch.int32)
    return gx, wh, lengths


def _gx_on(route, gx, wh, lengths):
    """blstm_recurrence on ``route`` (None: the default); checks that it
    launched there."""
    before = dict(blstm.GX_ROUTE_LAUNCHES)
    ctx = (blstm._force_gx_route(route) if route is not None
           else contextlib.nullcontext())
    with ctx:
        got = blstm.blstm_recurrence(gx, wh, lengths)
    want = route or "grid"
    after = dict(blstm.GX_ROUTE_LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == want) for k in after}
    return got


def _pad_is_zero(got, lengths):
    t = got.shape[1]
    pad = torch.arange(t, device=got.device)[None] >= lengths[:, None]
    return not got[pad].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [32, 256, 512, 768, 1024])
@pytest.mark.parametrize("b", [5, 16, 128])
def test_blstm_kernel_matches_plain(dev, dtype, h, b):
    """The gate-stream recurrence on its default route, the grid route of
    ``csrc/blstm_gx_grid.cu`` (``gx_plan`` fits every one of these shapes:
    k splits at B = 5 and 16, W_h's slice partly streamed in float32 at H
    >= 768), against the plain version with h rounded: ragged lengths with
    0, 1 and T, pad frames exact zeros, a rerun bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(h + b)
    t = 23
    gx, wh, lengths = _rec_inputs(gen, dev, b, t, h, dtype)
    assert blstm._gx_grid(b, h, wh) is not None
    got = _gx_on(None, gx, wh, lengths)
    want = blstm.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, want))
    assert _pad_is_zero(got, lengths)
    assert torch.equal(_gx_on(None, gx, wh, lengths), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [32, 256, 1024])
def test_blstm_row_tiled_route_matches_plain(dev, dtype, h):
    """``csrc/blstm.cu`` forced: the route past the plan and the timing
    yardstick."""
    gen = torch.Generator(device=dev).manual_seed(h)
    gx, wh, lengths = _rec_inputs(gen, dev, 5, 23, h, dtype)
    got = _gx_on("row_tiled", gx, wh, lengths)
    want = blstm.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, want))
    assert _pad_is_zero(got, lengths)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_blstm_grid_long_and_short_batches(dev, dtype):
    """Frames past the batch's longest length advance the barrier counters
    all the same: a batch whose rows all end early, then a full one, a
    long one (T = 300) and B = 112 at H = 1,024 (7 m16 tiles staged as 8
    in 2 x 2 warp tiles), each against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(11)
    for b, t, top, h in ((16, 40, 25, 256), (16, 40, 40, 256),
                         (128, 300, 300, 256), (112, 30, 30, 1024)):
        gx, wh, lengths = _rec_inputs(gen, dev, b, t, h, dtype)
        lengths = lengths.clamp(max=top)
        got = _gx_on(None, gx, wh, lengths)
        want = blstm.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **_tol(dtype, want))
        assert _pad_is_zero(got, lengths)


def test_blstm_grid_refusals(dev):
    """Past ``gx_plan`` (H not a multiple of 32; B = 256 at H = 1,024,
    more warp tiles than warps) the default is the row-tiled kernel, and a
    forced grid route raises before any launch."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for b, h in ((5, 40), (256, 1024)):
        gx, wh, lengths = _rec_inputs(gen, dev, b, 23, h, torch.bfloat16)
        assert blstm._gx_grid(b, h, wh) is None
        got = _gx_on("row_tiled", gx, wh, lengths)
        torch.testing.assert_close(got, blstm.blstm_recurrence(gx, wh,
                                                               lengths))
        launches = dict(blstm.GX_ROUTE_LAUNCHES)
        with blstm._force_gx_route("grid"), pytest.raises(ValueError):
            blstm.blstm_recurrence(gx, wh, lengths)
        assert blstm.GX_ROUTE_LAUNCHES == launches


def _infer_inputs(gen, dev, b, t, d, h, dtype):
    x = torch.randn((b, t, d), generator=gen, device=dev)
    wx = (torch.randn((2, d, 4 * h), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    bias = torch.randn((2, 4 * h), generator=gen, device=dev) * 0.3
    return x, wx, wh, bias


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [32, 256, 512, 1024])
@pytest.mark.parametrize("d", [10, 257, 2560])
def test_blstm_infer_kernel_matches_plain(dev, dtype, h, d):
    """The row-tiled kernel (``csrc/blstm_infer.cu``): both projections
    (tensor cores in bf16 up to H = 512 in 32- and 16-pair chunks, FMAs
    otherwise in 16- and 8-pair chunks), ragged lengths with an empty row,
    pad frames exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(h + d)
    b, t = 5, 23
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, d, h, dtype)
    lengths = torch.tensor([t, 1, 0, 17, t - 1], dtype=torch.int32, device=dev)
    with blstm._force_infer_route("row_tiled"):
        got = blstm.blstm_infer(x, lengths, wx, wh, bias)
    want = blstm.blstm_infer_plain(x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, want))
    assert not got[2].any() and not got[1, 1:].any() and not got[3, 17:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_blstm_infer_kernel_four_rows_per_block(dev, dtype):
    """More rows than two per block fit in one wave of SMs: the row-tiled
    kernel with four rows a block, bf16 x given in float32."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d, h = 150, 9, 257, 256
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, d, h, dtype)
    lengths = torch.randint(0, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    with blstm._force_infer_route("row_tiled"):
        got = blstm.blstm_infer(x, lengths, wx, wh, bias)
    want = blstm.blstm_infer_plain(x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, want))
    pad = torch.arange(t, device=dev)[None] >= lengths[:, None]
    assert not got[pad].any()


def _ragged(gen, dev, b, t):
    """Lengths in [1, T], the first row full, the second (where B > 1)
    empty."""
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = t
    if b > 1:
        lengths[1] = 0
    return lengths


def _on_route(route, x, lengths, wx, wh, bias):
    """blstm_infer forced onto ``route``; checks that it launched there."""
    before = dict(blstm.INFER_ROUTE_LAUNCHES)
    with blstm._force_infer_route(route):
        got = blstm.blstm_infer(x, lengths, wx, wh, bias)
    after = dict(blstm.INFER_ROUTE_LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    return got


# (H, D, B): H=64 and 256 at the flagship's D; H=512 at the reference
# model's (enhancer D=257 and 1,024, encoder D=2,560), up to its decode's B
CLUSTER_CASES = ([(h, d, b) for h in (64, 256) for d in (10, 257, 2560)
                  for b in (1, 17, 128)]
                 + [(512, d, b) for d in (257, 1024, 2560)
                    for b in (1, 17, 64)])


@pytest.mark.parametrize("h, d, b", CLUSTER_CASES)
def test_blstm_infer_cluster_matches_plain(dev, h, d, b):
    """The cluster route (``csrc/blstm_infer_cluster.cu``; H=64 takes
    clusters of 2 blocks, H=256 of 8, H=512 of 16 with half of W_h in
    shared memory; W_x resident at D=10 and 257 up to H=256, streamed at
    2,560 and at every D at H=512) against the plain version in bf16:
    ragged lengths, a zero-length row, pad frames exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(b + h + d)
    t = 23
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, d, h, torch.bfloat16)
    lengths = _ragged(gen, dev, b, t)
    got = _on_route("cluster", x, lengths, wx, wh, bias)
    want = blstm.blstm_infer_plain(x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16, want))
    pad = torch.arange(t, device=dev)[None] >= lengths[:, None]
    assert not got[pad].any()


@pytest.mark.parametrize("b, t, d, h", [(5, 1, 257, 256), (150, 9, 257, 256),
                                        (3, 40, 48, 32), (9, 30, 1024, 128)],
                         ids=["T1", "R32", "C1", "C4-streamed"])
def test_blstm_infer_cluster_shapes(dev, b, t, d, h):
    """T = 1; B = 150, where 16-row groups would need more clusters than
    the card holds at once and the plan takes 32 rows; H = 32 (one block a
    cluster); H = 128 (four) with W_x streamed."""
    gen = torch.Generator(device=dev).manual_seed(b * t)
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, d, h, torch.bfloat16)
    lengths = _ragged(gen, dev, b, t)
    got = _on_route("cluster", x, lengths, wx, wh, bias)
    want = blstm.blstm_infer_plain(x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16, want))
    pad = torch.arange(t, device=dev)[None] >= lengths[:, None]
    assert not got[pad].any()


@pytest.mark.parametrize("b, t, d, h", [(128, 50, 257, 256),
                                        (64, 70, 2560, 512)],
                         ids=["H256", "H512"])
def test_blstm_infer_cluster_is_deterministic_and_agrees(dev, b, t, d, h):
    """Two runs of the cluster route are bit-identical, and the cluster
    and row-tiled routes agree within the bf16 tolerance: at the
    flagship's enhancer layer 0 and at the reference encoder's layer 0
    (H=512, 32-row groups over clusters of 16)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, d, h, torch.bfloat16)
    lengths = _ragged(gen, dev, b, t)
    runs = [_on_route("cluster", x, lengths, wx, wh, bias) for _ in range(2)]
    tiled = _on_route("row_tiled", x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].float(), tiled.float(),
                               **_tol(torch.bfloat16, tiled))


def test_blstm_infer_cluster_refusals(dev):
    """The plan sends f32 and bf16 H = 1,024 (64 units a block even at 16
    blocks) to the row-tiled route, and forcing the cluster route there
    raises before any launch; a launch the card refuses (W_x resident in
    more shared memory than a block has) raises, never runs, and leaves no
    error for the next launch."""
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(5)
    lengths = torch.tensor([7, 3], dtype=torch.int32, device=dev)
    for dtype, h in ((torch.float32, 256), (torch.bfloat16, 1024)):
        x, wx, wh, bias = _infer_inputs(gen, dev, 2, 7, 40, h, dtype)
        assert blstm._cluster(2, 40, h, wh) is None
        launches = dict(blstm.INFER_ROUTE_LAUNCHES)
        with blstm._force_infer_route("cluster"), pytest.raises(ValueError):
            blstm.blstm_infer(x, lengths, wx, wh, bias)
        assert blstm.INFER_ROUTE_LAUNCHES == launches
    b, t, dw, h, c = 2, 7, 16384, 256, 8
    x = torch.zeros((b, t, dw), dtype=torch.bfloat16, device=dev)
    wx = torch.zeros((2, c, 4 * h // c, dw), dtype=torch.bfloat16, device=dev)
    wh = torch.zeros((2, c, 4 * h // c, h), dtype=torch.bfloat16, device=dev)
    bias = torch.zeros((2, 4 * h), device=dev)
    out = torch.empty((b, t, 2 * h), dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError, match="blstm_infer_cluster"):
        launch("blstm_infer_cluster", x.data_ptr(), x.data_ptr(),
               wx.data_ptr(), wh.data_ptr(), bias.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), b, t, dw, h, c, 16, 1,
               torch.cuda.current_stream(dev).cuda_stream)
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, 40, h, torch.bfloat16)
    got = _on_route("cluster", x, lengths, wx, wh, bias)
    want = blstm.blstm_infer_plain(x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16, want))


def test_blstm_infer_refuses_autograd(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x, wx, wh, bias = _infer_inputs(gen, dev, 2, 5, 10, 32, torch.float32)
    lengths = torch.tensor([5, 3], dtype=torch.int32, device=dev)
    launches = blstm.blstm_infer.launches
    with pytest.raises(ValueError, match="inference-only"):
        blstm.blstm_infer(x, lengths, wx.requires_grad_(), wh, bias)
    assert blstm.blstm_infer.launches == launches


def _att_args(gen, dev, b, k, t, c, a, e, dtype, lens):
    """att_loc_step's arguments at its tests' scales, mask from lens."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    mask = (torch.arange(t, device=dev)[None]
            < torch.tensor(lens, device=dev)[:, None]).to(dtype)
    return (rnd(b, k, t, c, scale=0.1), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a), rnd(a, scale=0.3), mask)


def _att_on_route(route, *args):
    """att_loc_step forced onto ``route``; checks that it launched there."""
    before = dict(att.ATT_ROUTE_LAUNCHES)
    with att._force_att_route(route):
        got = att.att_loc_step(*args, 2.0)
    after = dict(att.ATT_ROUTE_LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    return got


@pytest.mark.parametrize("route", ["utt", "hyp"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_att_kernel_matches_plain(dev, dtype, route):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, k, t, c, a, e = 3, 4, 37, 10, 64, 48

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    mask = (torch.arange(t, device=dev)[None]
            < torch.tensor([[t], [5], [0]], device=dev)).to(dtype)
    args = (rnd(b, k, t, c, scale=0.1), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a), rnd(a, scale=0.3), mask)
    got = _att_on_route(route, *args)
    want = att.att_loc_step_plain(*args, 2.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(dtype, w))
    assert not got[1][1, :, 5:].any()
    with pytest.raises(ValueError):  # more conv channels than a warp keeps
        with att._force_att_route(route):
            att.att_loc_step(rnd(b, k, t, 40), *args[1:4], rnd(40, a),
                             *args[5:], 2.0)


# (B, K, T, C, A, E): the JAX toy widths, the flagship decode, K at the
# route's limit, C = 32 with T one frame past a chunk, T ~700, A and E
# odd, K and C at their limits together
UTT_SHAPES = [(1, 1, 1, 1, 24, 48), (17, 8, 37, 10, 24, 48),
              (128, 8, 174, 10, 256, 256), (17, 16, 174, 10, 256, 256),
              (3, 8, 65, 32, 256, 256), (2, 8, 700, 10, 256, 256),
              (5, 4, 37, 1, 23, 47), (128, 16, 37, 32, 24, 48)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", UTT_SHAPES,
                         ids=["x".join(map(str, s)) for s in UTT_SHAPES])
def test_att_utt_matches_plain(dev, dtype, shape):
    """The per-utterance route (``csrc/att_loc_utt.cu``) against the plain
    version: ragged masks with the last row empty (where B > 1), pad
    frames exact zeros."""
    b, k, t, c, a, e = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev).tolist()
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    args = _att_args(gen, dev, b, k, t, c, a, e, dtype, lens)
    got = _att_on_route("utt", *args)
    want = att.att_loc_step_plain(*args, 2.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(dtype, w))
    pad = torch.arange(t, device=dev)[None] >= torch.tensor(lens, device=dev)[:, None]
    assert not got[1].permute(0, 2, 1)[pad].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_att_utt_zero_length_row(dev, dtype):
    """A row whose mask is all zeros: its att and ctx are exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(3)
    args = _att_args(gen, dev, 3, 8, 174, 10, 256, 256, dtype, [174, 0, 9])
    ctx, alig = _att_on_route("utt", *args)
    torch.cuda.synchronize()
    assert not alig[1].any() and not ctx[1].any()
    assert ctx[0].abs().sum() > 0 and ctx[2].abs().sum() > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_att_utt_is_deterministic_and_agrees(dev, dtype):
    """Two runs of the per-utterance route are bit-identical, and the two
    routes agree within the tolerance of each against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(7)
    lens = torch.randint(87, 175, (128,), generator=gen, device=dev).tolist()
    args = _att_args(gen, dev, 128, 8, 174, 10, 256, 256, dtype, lens)
    runs = [_att_on_route("utt", *args) for _ in range(2)]
    hyp = _att_on_route("hyp", *args)
    torch.cuda.synchronize()
    for r0, r1, h in zip(*runs, hyp):
        assert torch.equal(r0, r1)
        torch.testing.assert_close(r0, h, **_tol(dtype, h))


def test_att_utt_refusals(dev):
    """Forcing the per-utterance route past its plan raises before any
    launch; a launch whose plan disagrees with the kernel's layout raises,
    never runs, and leaves no error for the next launch."""
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(9)
    for shape, dtype in (((1, 16, 700, 32, 256, 256), torch.float32),
                         ((1, 17, 20, 10, 24, 48), torch.bfloat16)):
        b, k, t, c, a, e = shape
        assert att.utt_plan(*shape, 4 if dtype == torch.float32 else 2,
                            att.device_limits(dev.index or 0)[1]) is None
        args = _att_args(gen, dev, b, k, t, c, a, e, dtype, [t])
        launches = dict(att.ATT_ROUTE_LAUNCHES)
        with att._force_att_route("utt"), pytest.raises(ValueError):
            att.att_loc_step(*args, 2.0)
        assert att.ATT_ROUTE_LAUNCHES == launches
    b, k, t, c, a, e = 2, 8, 174, 10, 256, 256
    args = _att_args(gen, dev, b, k, t, c, a, e, torch.bfloat16, [t, 9])
    chunk, splits, smem = att.utt_plan(b, k, t, c, a, e, 2, 232_448)
    mask = args[-1].float()
    ctx = torch.empty((b, k, e), device=dev)
    alig = torch.empty((b, k, t), device=dev)
    with pytest.raises(RuntimeError, match="att_loc_utt"):
        launch("att_loc_utt", *(x.data_ptr() for x in args[:6]),
               mask.data_ptr(), ctx.data_ptr(), alig.data_ptr(), b, k, t, c,
               a, e, chunk, splits, smem + 16, 2.0, 1,
               torch.cuda.current_stream(dev).cuda_stream)
    got = _att_on_route("utt", *args)
    want = att.att_loc_step_plain(*args, 2.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(torch.bfloat16, w))


def test_ctc_prefix_kernels_match_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, k, t, v = 3, 4, 29, 9
    lpz = torch.log_softmax(
        torch.randn((b, t, v), generator=gen, device=dev), -1).contiguous()
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for step in range(3):
        tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        tok[:, 0] = last[:, 0] if step else tok[:, 0]
        psi = ctc_prefix.prefix_psi(lpz, last, lens, r_n, r_b, 0, 1)
        psi_plain = ctc_prefix.prefix_psi_plain(lpz, last, lens, r_n, r_b, 0, 1)
        torch.testing.assert_close(psi, psi_plain, rtol=0, atol=1e-3)
        got = ctc_prefix.prefix_state(lpz, tok, last, lens, r_n, r_b, 0)
        want = ctc_prefix.prefix_state_plain(lpz, tok, last, lens, r_n, r_b, 0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-3)
        r_n, r_b = got
        last, lens = tok, lens + 1


# (B, K, T, V, blank, eos): the flagship decode and B=1; K=1 and K=16;
# V=9 and V=52; T=1; T one frame past the state's 64-frame chunk; T of
# several state chunks with blank and eos at other ids; T of several psi
# chunks (256 frames)
PREFIX_SHAPES = [(128, 8, 174, 52, 0, 1), (1, 8, 174, 52, 0, 1),
                 (3, 1, 29, 9, 0, 1), (5, 16, 65, 52, 0, 1),
                 (2, 8, 1, 9, 0, 1), (4, 8, 130, 52, 51, 3),
                 (2, 4, 700, 9, 8, 2)]


def _prefix_lpz(gen, dev, b, t, v, blank):
    """Masked CTC log-probs: ragged lengths, and a row with one valid
    frame, whose extensions' psi terms past t=0 all lie at or below
    LOG_ZERO."""
    lpz = torch.log_softmax(
        3 * torch.randn((b, t, v), generator=gen, device=dev), -1)
    hl = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    hl[0] = t
    if b > 1:
        hl[-1] = 1
    pad = torch.full((v,), ctc_prefix.LOG_ZERO, device=dev)
    pad[blank] = 0.0
    valid = torch.arange(t, device=dev)[None] < hl[:, None]
    return torch.where(valid[..., None], lpz, pad).contiguous()


def _on_prefix_route(route, kind, fn, *args):
    """``fn`` with the psi and state kernels forced onto ``route``; checks
    that it launched ``kind``'s kernel once, there."""
    before = {n: dict(r) for n, r in ctc_prefix.PREFIX_ROUTE_LAUNCHES.items()}
    with ctc_prefix._force_prefix_route(route):
        got = fn(*args)
    after = ctc_prefix.PREFIX_ROUTE_LAUNCHES
    assert {n: {r: after[n][r] - before[n][r] for r in after[n]}
            for n in after} == {
        n: {r: int(n == kind and r == route) for r in after[n]}
        for n in after}
    return got


@pytest.mark.parametrize("route", ["utt", "lane"])
@pytest.mark.parametrize("shape", PREFIX_SHAPES,
                         ids=["x".join(map(str, s)) for s in PREFIX_SHAPES])
def test_ctc_prefix_routes_match_plain(dev, route, shape):
    """psi, the contract-level state and ``prefix_state_step`` on one
    route against their plain versions over three chained beam steps:
    empty prefixes first, then repeated tokens and lanes with nothing
    appended, parents picked at random."""
    b, k, t, v, blank, eos = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    lpz = _prefix_lpz(gen, dev, b, t, v, blank)
    r_b = torch.cumsum(lpz[:, :, blank], 1)[:, None].expand(b, k, t)
    r_b = r_b.contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.full((b, k), eos, dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for step in range(3):
        psi = _on_prefix_route(route, "psi", ctc_prefix.prefix_psi, lpz,
                               last, lens, r_n, r_b, blank, eos)
        want = ctc_prefix.prefix_psi_plain(lpz, last, lens, r_n, r_b, blank,
                                           eos)
        torch.cuda.synchronize()
        torch.testing.assert_close(psi, want, rtol=0, atol=1e-3)
        k_idx = torch.randint(0, k, (b, k), generator=gen, device=dev)
        tok = torch.randint(0, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        last_par = ctc_prefix.gather_beam(last, k_idx)
        tok[:, 0] = last_par[:, 0]  # a repeated token (or sos at step 0)
        append = torch.rand((b, k), generator=gen, device=dev) < 0.7
        append[:, 0] = True
        args = (lpz, k_idx, tok, append, last, lens, r_n, r_b, blank)
        got = _on_prefix_route(route, "state", ctc_prefix.prefix_state_step,
                               *args)
        want = ctc_prefix.prefix_state_step_plain(*args)
        par = (lpz, tok, last_par, ctc_prefix.gather_beam(lens, k_idx),
               ctc_prefix.gather_beam(r_n, k_idx),
               ctc_prefix.gather_beam(r_b, k_idx), blank)
        got_c = _on_prefix_route(route, "state", ctc_prefix.prefix_state,
                                 *par)
        want_c = ctc_prefix.prefix_state_plain(*par)
        torch.cuda.synchronize()
        for g, w in zip(got + got_c, want + want_c):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-3)
        r_n, r_b = got
        last = torch.where(append, tok, last_par)
        lens = ctc_prefix.gather_beam(lens, k_idx) + append.to(torch.int32)


def test_ctc_prefix_psi_utt_is_deterministic(dev):
    """Two runs of the psi reduction are bit-identical, and the two routes
    agree within the tolerance of each against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(11)
    b, k, t, v = 128, 8, 174, 52
    lpz = _prefix_lpz(gen, dev, b, t, v, 0)
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.randint(2, v, (b, k), generator=gen, device=dev,
                         dtype=torch.int32)
    lens = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens[:, 0] = 0
    r_n, r_b = ctc_prefix.prefix_state_plain(lpz, last, last * 0 + 1,
                                             lens * 0, r_n, r_b, 0)
    args = (lpz, last, lens, r_n, r_b, 0, 1)
    runs = [_on_prefix_route("utt", "psi", ctc_prefix.prefix_psi, *args)
            for _ in range(2)]
    lane = _on_prefix_route("lane", "psi", ctc_prefix.prefix_psi, *args)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0], lane, rtol=0, atol=2e-3)


def test_ctc_prefix_utt_refusals(dev):
    """Forcing the "utt" route past its plans raises before any launch
    (K > 32 for the state, K x V > 1,024 for psi), the default takes the
    "lane" route there, and a launch the kernel refuses raises and leaves
    no error for the next launch."""
    from robust_e2e_gan_torch.utils.build import launch

    b, k, t, v = 2, 40, 9, 30
    lpz = torch.log_softmax(torch.randn((b, t, v), device=dev), -1)
    ints = torch.zeros((b, k), dtype=torch.int32, device=dev)
    rows = torch.zeros((b, k, t), device=dev)
    before = {n: dict(r) for n, r in ctc_prefix.PREFIX_ROUTE_LAUNCHES.items()}
    with ctc_prefix._force_prefix_route("utt"):
        with pytest.raises(ValueError, match="utt route"):
            ctc_prefix.prefix_psi(lpz, ints, ints, rows, rows, 0, 1)
        with pytest.raises(ValueError, match="utt route"):
            ctc_prefix.prefix_state(lpz, ints, ints, ints, rows, rows, 0)
    assert ctc_prefix.PREFIX_ROUTE_LAUNCHES == before
    _on_prefix_route("lane", "psi", ctc_prefix.prefix_psi, lpz, ints, ints,
                     rows, rows, 0, 1)
    ctc_prefix.prefix_state(lpz, ints + 1, ints, ints, rows, rows, 0)
    assert ctc_prefix.PREFIX_ROUTE_LAUNCHES["state"]["lane"] == (
        before["state"]["lane"] + 1)
    out = torch.empty((b, k, t), device=dev)
    with pytest.raises(RuntimeError, match="ctc_prefix_state_utt"):
        launch("ctc_prefix_state_utt", lpz.data_ptr(), 0, ints.data_ptr(), 0,
               ints.data_ptr(), ints.data_ptr(), rows.data_ptr(),
               rows.data_ptr(), out.data_ptr(), out.data_ptr(), b, k, t, v, 0,
               64, torch.cuda.current_stream(dev).cuda_stream)
    small = (lpz, ints[:, :8] + 2, ints[:, :8], ints[:, :8], rows[:, :8],
             rows[:, :8], 0)
    got = _on_prefix_route("utt", "state", ctc_prefix.prefix_state, *small)
    want = ctc_prefix.prefix_state_plain(*small)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)


def _train_inputs(gen, dev, b, t, d, h, dtype):
    x = torch.randn((b, t, d), generator=gen, device=dev)
    wx = (torch.randn((2, d, 4 * h), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    bias = torch.randn((2, 4 * h), generator=gen, device=dev) * 0.3
    lengths = torch.tensor([t, 1, 0, t - 3, 5][:b], dtype=torch.int32,
                           device=dev)
    dy = torch.randn((b, t, 2 * h), generator=gen, device=dev)
    return x, wx, wh, bias, lengths, dy


def _grads(fn, leaves, dy):
    leaves = [a.detach().requires_grad_() for a in leaves]
    y = fn(*leaves)
    return [y] + list(torch.autograd.grad(y.float().mul(dy).sum(), leaves))


def _grad_tol(dtype, want):
    # weight gradients sum over B*T rows: scale the limit by their size
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-4 * want.abs().max().item() + 1e-6)
    return dict(rtol=0, atol=2e-2 * want.abs().max().item() + 1e-6)


ROUTES = ["resident", "loop"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [32, 256, 512])
def test_blstm_train_kernels_match_plain(dev, dtype, h, route):
    """Both frame-loop routes (the resident loops of
    blstm_train_resident.cu, the row-tiled loops of blstm_train.cu) through
    both autograd functions."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(h)
    b, t, d = 5, 23, 70
    x, wx, wh, bias, lengths, dy = _train_inputs(gen, dev, b, t, d, h, dtype)

    def fused(kernel):
        fn = bt.blstm_train if kernel else bt.blstm_train_plain
        return _grads(lambda x_, wx_, wh_, b_: fn(x_, lengths, wx_, wh_, b_),
                      [x, wx, wh, bias], dy)

    before = dict(bt.ROUTE_LAUNCHES)
    with bt._force_route(route):
        got = fused(True)
    want = fused(False)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **_tol(dtype, want[0]))
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.float(), w.float(), **_grad_tol(dtype, w))
    assert not got[0][2].any() and not got[1][2].any()  # an empty row

    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)

    def gx_path(kernel):
        fn = bt.blstm_train_gx if kernel else bt.blstm_train_gx_plain
        return _grads(lambda g_, wh_: fn(g_, wh_, lengths), [gx, wh], dy)

    with bt._force_route(route):
        got = gx_path(True)
    want = gx_path(False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **_tol(dtype, want[0]))
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.float(), w.float(), **_grad_tol(dtype, w))
    # forward and backward of both functions, all on the forced route
    assert bt.ROUTE_LAUNCHES[route] == before[route] + 4
    other = ROUTES[1 - ROUTES.index(route)]
    assert bt.ROUTE_LAUNCHES[other] == before[other]


def _gx_inputs(gen, dev, b, t, h, dtype, lengths):
    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    dy = torch.randn((b, t, 2 * h), generator=gen, device=dev)
    return gx, wh, torch.tensor(lengths, dtype=torch.int32, device=dev), dy


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b, t, h", [(33, 31, 256), (3, 400, 64), (7, 19, 30)],
                         ids=["odd_batch", "long", "h_not_multiple_of_4"])
def test_blstm_train_gx_ragged_and_long(dev, dtype, b, t, h, route):
    """An odd batch whose lengths include 0 and T (the resident loops run
    to the longest row, rows past their length idle), a 400-frame case,
    and an H the resident loops stage one value at a time; pad frames of
    the output and of dgx are exact zeros."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(b + t)
    lens = torch.randint(0, t + 1, (b,), generator=gen, device=dev).tolist()
    lens[0], lens[1] = 0, t
    gx, wh, lengths, dy = _gx_inputs(gen, dev, b, t, h, dtype, lens)

    def run(fn):
        return _grads(lambda g_, wh_: fn(g_, wh_, lengths), [gx, wh], dy)

    with bt._force_route(route):
        got = run(bt.blstm_train_gx)
    want = run(bt.blstm_train_gx_plain)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **_tol(dtype, want[0]))
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.float(), w.float(), **_grad_tol(dtype, w))
    for i, n in enumerate(lens):
        assert not got[0][i, n:].any() and not got[1][i, n:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_blstm_train_resident_is_deterministic(dev, dtype):
    """The dh partials are summed in a fixed block order without float
    atomics: two runs give bit-identical dgates (dgx) and dW_h."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, h = 16, 72, 512
    lens = [t] + torch.randint(t // 2, t + 1, (b - 1,), generator=gen,
                               device=dev).tolist()
    gx, wh, lengths, dy = _gx_inputs(gen, dev, b, t, h, dtype, lens)
    runs = []
    with bt._force_route("resident"):
        for _ in range(2):
            runs.append(_grads(lambda g_, wh_: bt.blstm_train_gx(
                g_, wh_, lengths), [gx, wh], dy))
    torch.cuda.synchronize()
    for a, c in zip(runs[0], runs[1]):
        assert torch.equal(a, c)


def test_blstm_train_resident_refusals(dev):
    """The plan sends f32 H = 1,024 to the row-tiled loops, and forcing the
    resident ones there raises; a grid that cannot be co-resident (one
    unit per block: 2 x 512 blocks) is refused by the cooperative launch
    and raises, it never runs, and the next launch runs."""
    from robust_e2e_gan_torch.ops import blstm_train as bt
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(3)
    b, t = 4, 9
    gx, wh, lengths, dy = _gx_inputs(gen, dev, b, t, 1024, torch.float32,
                                     [t, 5, 0, 2])
    assert bt._resident(b, 1024, wh) is None
    with bt._force_route("resident"), pytest.raises(ValueError):
        bt.blstm_train_gx(gx, wh, lengths)
    h = 512
    gx, wh = gx[..., :4 * h].contiguous(), wh[:, :h, :4 * h].contiguous()
    out = torch.empty((b, t, 2 * h), device=dev)
    y_ext = torch.empty((2, b, t + 1, h), device=dev)
    c_ext = torch.empty((2, b, t + 1, h), device=dev)
    count = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="blstm_train_resident_fwd"):
        launch("blstm_train_resident_fwd", gx.data_ptr(), wh.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), y_ext.data_ptr(),
               c_ext.data_ptr(), count.data_ptr(), b, t, h, 1, 0,
               torch.cuda.current_stream(dev).cuda_stream)
    # the refusal is not left behind for the next kernel's launch check
    got = bt.blstm_train_gx(gx, wh, lengths)
    want = bt.blstm_train_gx_plain(gx, wh, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_tol(torch.float32, want))


# the products of the training BLSTM (csrc/gemm.cu): each layout of the
# layer against the plain version, at the flagship's enhancer layer 0
# (B=32, T=286, D=257, H=256) and encoder layer 0 (T=72, D=2560), and at a
# ragged small one (B=5, T=9, D=257, H=8)
GEMM_LAYERS = {"enhancer0": (32, 286, 257, 256),
               "encoder0": (32, 72, 2560, 256), "ragged": (5, 9, 257, 8)}
GEMM_LAYOUTS = ["proj", "dx", "dwx", "dwh"]


def _gemm_operands(gen, dev, b, t, d, h, dtype):
    xc = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    wx = (torch.randn((2, d, 4 * h), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    bias = torch.randn((2, 4 * h), generator=gen, device=dev)
    dg = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    y_ext = torch.randn((2, b, t + 1, h), generator=gen, device=dev).to(dtype)
    return xc, wx, bias, dg, y_ext


def _gemm_product(layout, xc, wx, bias, dg, y_ext, product=None):
    """One product of the layer through the wrapper that launches it (or
    with ``product``, e.g. the plain version)."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    b, t, _ = xc.shape
    rnd = wx.dtype == torch.bfloat16
    if layout == "proj":
        return bt._projection_kernel(xc, wx, bias, product)
    if layout == "dx":
        return bt._dx_kernel(dg, wx, rnd, product)
    if layout == "dwx":
        return bt._dwx_kernel(xc, dg, rnd, product)
    return bt._dwh_kernel(y_ext, dg, b, t, y_ext.shape[-1], product)


def _gemm_tol(want):
    # float32 sums in another order (bf16 products are exact in float32,
    # 3xTF32 keeps ~21 bits of each operand)
    return dict(rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("layer", list(GEMM_LAYERS))
@pytest.mark.parametrize("layout", GEMM_LAYOUTS)
def test_gemm_layouts_match_plain(dev, layout, layer, dtype):
    """Each product of the layer on the tensor-core kernel (one launch for
    both directions) against gemm_plain on the same inputs."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(11)
    args = _gemm_operands(gen, dev, *GEMM_LAYERS[layer], dtype)
    before = dict(bt.GEMM_ROUTE_LAUNCHES)
    got = _gemm_product(layout, *args)
    assert bt.GEMM_ROUTE_LAUNCHES["tc"] == before["tc"] + 1
    assert bt.GEMM_ROUTE_LAUNCHES["simt"] == before["simt"]
    want = _gemm_product(layout, *args, product=bt.gemm_plain)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_gemm_tol(want))


# (dtype, D, offset in elements of x's first element, A's copy mode)
COPY_CASES = [(torch.bfloat16, 256, 0, 2), (torch.bfloat16, 258, 0, 3),
              (torch.bfloat16, 257, 0, 4), (torch.bfloat16, 256, 1, 4),
              (torch.bfloat16, 256, 2, 3), (torch.float32, 256, 0, 0),
              (torch.float32, 257, 0, 1), (torch.float32, 256, 2, 1)]


@pytest.mark.parametrize("dtype, d, offset, mode", COPY_CASES,
                         ids=["bf16_16B", "bf16_4B", "bf16_d257",
                              "bf16_odd_base", "bf16_4B_base", "f32_16B",
                              "f32_d257", "f32_8B_base"])
def test_gemm_copy_widths(dev, dtype, d, offset, mode):
    """Every copy width of the kernel (16-byte pieces, 4-byte ones, single
    elements, bfloat16 and float32) on A of the projection and of dW_x
    (its x^T), from rows and base pointers aligned to 16, 4 or 2 bytes,
    against gemm_plain."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(d + offset)
    b, t, h = 6, 37, 64
    store = torch.randn(b * t * d + offset, generator=gen, device=dev)
    xc = store.to(dtype)[offset:].view(b, t, d)
    wx = (torch.randn((2, d, 4 * h), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    dg = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    isz = xc.element_size()
    assert bt.copy_mode(xc.data_ptr(), isz, b * t, d, d, 0, d, 0, 1) == (
        True, mode)
    products = {  # x @ wx[z] (+ bias), and x^T @ dgates[:, :, z]
        "proj": (wx, dict(m=b * t, k=d, a_strides=(0, d, 0, 1),
                          b_strides=(d * 4 * h, 0, 4 * h, 1))),
        "dwx": (dg, dict(m=d, k=b * t, a_strides=(0, 1, 0, d),
                         b_strides=(4 * h, 0, 8 * h, 1),
                         round_bf16=dtype == torch.bfloat16))}
    for other, args in products.values():
        got = torch.empty((2, args["m"], 4 * h), device=dev)
        want = torch.empty_like(got)
        args.update(batch=2, n=4 * h, c_strides=(args["m"] * 4 * h, 4 * h, 1))
        bt.gemm(xc, other, got, **args)
        bt.gemm_plain(xc, other, want, **args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **_gemm_tol(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gemm_split_k_is_deterministic(dev, dtype):
    """dW_h of the flagship's enhancer layer 0 takes 8 k slices in
    bfloat16, 4 in float32: three runs are bit-identical (partials summed
    in slice order, no float atomics), and the tickets are back at
    zero."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(5)
    b, t, d, h = GEMM_LAYERS["enhancer0"]
    _, _, _, dg, y_ext = _gemm_operands(gen, dev, b, t, d, h, dtype)
    plan = bt.gemm_plan(h, 4 * h, b * t, y_ext.element_size(),
                        *bt.device_limits(dev.index or 0), batch=2)
    assert plan.splits > 1
    runs = [bt._dwh_kernel(y_ext, dg, b, t, h) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert all(int(t_.abs().sum()) == 0 for t_ in bt._TICKETS.values())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gemm_simt_route_agrees(dev, dtype):
    """The SIMT kernel, forced, against the tensor-core kernel on each
    product of a layer; its launches are counted apart."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(9)
    args = _gemm_operands(gen, dev, 8, 45, 257, 64, dtype)
    for layout in GEMM_LAYOUTS:
        tc = _gemm_product(layout, *args)
        n, before = bt.gemm.launches, dict(bt.GEMM_ROUTE_LAUNCHES)
        with bt._force_gemm_route("simt"):
            simt = _gemm_product(layout, *args)
        assert bt.gemm.launches == n
        assert bt.GEMM_ROUTE_LAUNCHES["simt"] == before["simt"] + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(tc, simt, **_gemm_tol(simt))


def test_blstm_train_products_take_the_tc_kernel(dev):
    """Forward and backward of blstm_train run five products (the
    projection, again in the backward, dx, dW_x, dW_h), blstm_train_gx's
    backward one (dW_h): one tensor-core launch each for both directions,
    none on the SIMT route."""
    from robust_e2e_gan_torch.ops import blstm_train as bt

    gen = torch.Generator(device=dev).manual_seed(4)
    x, wx, wh, bias, lengths, dy = _train_inputs(gen, dev, 5, 23, 70, 32,
                                                 torch.bfloat16)
    before = dict(bt.GEMM_ROUTE_LAUNCHES)
    _grads(lambda x_, wx_, wh_, b_: bt.blstm_train(x_, lengths, wx_, wh_, b_),
           [x, wx, wh, bias], dy)
    assert bt.GEMM_ROUTE_LAUNCHES == {"tc": before["tc"] + 5,
                                      "simt": before["simt"]}
    gx = torch.randn((5, 23, 2, 4 * 32), generator=gen, device=dev)
    _grads(lambda g_, wh_: bt.blstm_train_gx(g_, wh_, lengths), [gx, wh], dy)
    assert bt.GEMM_ROUTE_LAUNCHES == {"tc": before["tc"] + 6,
                                      "simt": before["simt"]}


def test_gemm_refusals(dev):
    """A copy mode the pointer or strides do not allow, a plan with an
    empty slice or without its workspace, and too little shared memory are
    refused at the launch and raise; an unknown route raises; the next
    launch runs."""
    from robust_e2e_gan_torch.ops import blstm_train as bt
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn((64, 257), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((257, 128), generator=gen, device=dev).to(torch.bfloat16)
    c = torch.empty((64, 128), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = torch.empty(4 * 128 * 128, device=dev)
    tickets = torch.zeros(4, dtype=torch.int32, device=dev)

    def run(mode_a=4, splits=1, per=9, smem=81_920, buffers=True):
        launch("gemm", a.data_ptr(), b.data_ptr(), c.data_ptr(), 0,
               ws.data_ptr() if buffers else 0,
               tickets.data_ptr() if buffers else 0, 1, 64, 128, 257, 257,
               0, 257, 0, 1, 0, 0, 128, 1, 0, 128, 1, 0, mode_a, 1, 2, 0, 0,
               0, splits, per, smem, stream)

    # 257 k: 9 chunks; 3 slices of 5 leave one empty, 2 of 4 miss one
    for bad in (dict(mode_a=2), dict(mode_a=3), dict(splits=3, per=5),
                dict(splits=2, per=4), dict(smem=40_000),
                dict(splits=2, per=5, buffers=False)):
        with pytest.raises(RuntimeError, match="gemm"):
            run(**bad)
    with pytest.raises(ValueError):
        with bt._force_gemm_route("wgmma"):
            pass
    run(splits=2, per=5)
    torch.cuda.synchronize()
    want = torch.empty_like(c)
    bt.gemm_plain(a, b, want, batch=1, m=64, n=128, k=257,
                  a_strides=(0, 257, 0, 1), b_strides=(0, 0, 128, 1),
                  c_strides=(0, 128, 1))
    torch.testing.assert_close(c, want, **_gemm_tol(want))


@pytest.mark.parametrize("s", [1, 9])
def test_ctc_alpha_kernel_matches_plain(dev, s):
    """The bare recursion (the JAX kernel's contract, on no path): final
    alpha, the emission and alpha0 gradients, the history-free forward."""
    from robust_e2e_gan_torch.ops import ctc

    gen = torch.Generator(device=dev).manual_seed(s)
    b, t = 6, 31
    u = 2 * s + 1
    emit = torch.log(torch.rand((b, t, u), generator=gen, device=dev))
    label_lengths = torch.tensor([s, s, 0, max(s - 2, 0), 1, s], device=dev)
    pos = torch.where(torch.arange(u, device=dev)[None]
                      < 2 * label_lengths[:, None] + 1, 0.0, ctc.NEG_INF)
    skip = torch.where(torch.rand((b, u), generator=gen, device=dev) < 0.7,
                       0.0, ctc.NEG_INF)
    alpha0 = torch.full((b, u), ctc.NEG_INF, device=dev)
    alpha0[:, :2] = emit[:, 0, :2]
    alpha0 = torch.clamp_min(alpha0 + pos, ctc.NEG_INF)
    lens = torch.tensor([t, t - 4, 3, t, 1, 2 * s + 1], device=dev)
    dfin = torch.randn((b, u), generator=gen, device=dev)
    e, a0 = emit.clone().requires_grad_(), alpha0.clone().requires_grad_()
    launches = ctc.ctc_alpha.launches
    got = ctc.ctc_alpha(e, a0, skip, pos, lens)
    de, da0 = torch.autograd.grad(got, [e, a0], dfin)
    assert ctc.ctc_alpha.launches == launches + 2
    want, hist = ctc.ctc_alpha_fwd_plain(emit, alpha0, skip, pos, lens)
    want_de, want_da0 = ctc.ctc_alpha_bwd_plain(emit, skip, pos, lens, hist,
                                                dfin)
    torch.cuda.synchronize()
    finite = want > ctc.NEG_THRESH
    torch.testing.assert_close(got[finite], want[finite], rtol=0, atol=1e-4)
    assert bool((got[~finite] <= ctc.NEG_THRESH).all())
    torch.testing.assert_close(de, want_de, rtol=0, atol=1e-4)
    torch.testing.assert_close(da0, want_da0, rtol=0, atol=1e-4)
    with torch.no_grad():  # the history-free forward
        torch.testing.assert_close(ctc.ctc_alpha(emit, alpha0, skip, pos, lens),
                                   got.detach(), rtol=0, atol=0)


CTC_CASES = ["f32", "bf16", "log_input", "blank_last", "int32"]


@pytest.mark.parametrize("case", CTC_CASES)
@pytest.mark.parametrize("s", [1, 9])
def test_ctc_nll_kernels_match_plain(dev, s, case):
    """ctc_nll (one forward and one backward launch) against ctc_nll_plain
    on the card: ragged frames and labels, an empty label, repeats, one
    frame; log-probability input, blank = V - 1 with label 0 present,
    int32 labels and lengths (int64 otherwise); the no-grad forward."""
    from robust_e2e_gan_torch.ops import ctc

    gen = torch.Generator(device=dev).manual_seed(s)
    b, t, v = 6, 31, 13
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    blank = v - 1 if case == "blank_last" else 0
    logits = torch.randn((b, t, v), generator=gen, device=dev) * 3
    if case == "log_input":
        logits = torch.log_softmax(logits, -1)
    logits = logits.to(dtype)
    labels = torch.randint(1, v, (b, s), generator=gen, device=dev)
    if blank:
        labels[:, 0] = 0
        labels[labels == blank] = 1
    labels[0, 1:] = labels[0, :1] if s > 1 else labels[0, 1:]  # repeats
    label_lengths = torch.tensor([s, s, 0, max(s - 2, 0), 1, s],
                                 device=dev).clamp(max=s)
    logit_lengths = torch.tensor([t, t - 4, 3, t, 1, 2 * s + 1], device=dev)
    if case == "int32":
        labels, label_lengths, logit_lengths = (
            x.to(torch.int32) for x in (labels, label_lengths, logit_lengths))
    args = (logit_lengths, labels, label_lengths, blank, case == "log_input")
    weights = torch.arange(1, b + 1, dtype=torch.float32, device=dev)
    out = {}
    for fn in (ctc.ctc_nll, ctc.ctc_nll_plain):
        lg = logits.clone().requires_grad_()
        launches = ctc.ctc_nll.launches
        nll = fn(lg, *args)
        grad, = torch.autograd.grad(nll, lg, weights)
        out[fn] = (nll, grad)
        assert ctc.ctc_nll.launches - launches == (2 if fn is ctc.ctc_nll
                                                   else 0)
    torch.cuda.synchronize()
    for got, want in zip(out[ctc.ctc_nll], out[ctc.ctc_nll_plain]):
        assert got.dtype == want.dtype
        tol = 0 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=max(tol, 1e-4))
    launches = ctc.ctc_nll.launches
    with torch.no_grad():  # the history-free forward
        nll = ctc.ctc_nll(logits, *args)
    assert ctc.ctc_nll.launches == launches + 1
    torch.testing.assert_close(nll, out[ctc.ctc_nll][0].detach(), rtol=0,
                               atol=0)


def test_ctc_loss_takes_the_fused_pair(dev):
    """ctc_loss(impl="auto") on CUDA is one forward and one backward
    launch per loss and gradient; the wrapper raises past U = 1,024."""
    from robust_e2e_gan_torch.ops import ctc

    gen = torch.Generator(device=dev).manual_seed(0)
    lg = torch.randn((4, 20, 9), generator=gen, device=dev).requires_grad_()
    labels = torch.randint(1, 9, (4, 5), generator=gen, device=dev)
    lens = torch.tensor([20, 17, 12, 20], device=dev)
    label_lengths = torch.tensor([5, 3, 0, 4], device=dev)
    launches, plain = ctc.ctc_nll.launches, ctc.ctc_nll_plain.calls
    for reduction in ("mean", "sum", "none"):
        loss = ctc.ctc_loss(lg, lens, labels, label_lengths,
                            reduction=reduction)
        want = ctc.ctc_loss(lg, lens, labels, label_lengths,
                            reduction=reduction, impl="scan")
        got_g, = torch.autograd.grad(loss.sum(), lg)
        want_g, = torch.autograd.grad(want.sum(), lg)
        torch.testing.assert_close(loss, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(got_g, want_g, rtol=0, atol=1e-4)
    assert ctc.ctc_nll.launches == launches + 6
    assert ctc.ctc_nll_plain.calls == plain + 3  # the "scan" calls
    wide = torch.ones((1, 512), dtype=torch.long, device=dev)  # U = 1,025
    with pytest.raises(ValueError, match="U=1025"):
        ctc.ctc_nll(lg[:1], lens[:1], wide, label_lengths[:1])


def test_ctc_nll_long_utterance_matches_plain(dev):
    """A long shape: 400 frames (16 s at 40 ms a frame) and 150 labels
    (U = 301), where the (T, U) emission adjoints (470 KB an utterance)
    outgrow a block's shared memory; the kernels keep them in global
    scratch. Both sides are float32 chains of 400 frames that round the
    emissions differently (x - lse against torch's log_softmax); at
    |nll| ~ 2,000 one ulp is 1.2e-4, so alpha + beta - nll differ by a few
    of them. Loss to rtol 1e-5; gradient (occupancies times exp of that
    difference) to atol 5e-4."""
    from robust_e2e_gan_torch.ops import ctc

    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, v, s = 3, 400, 52, 150
    logits = torch.randn((b, t, v), generator=gen, device=dev) * 2
    labels = torch.randint(1, v, (b, s), generator=gen, device=dev)
    args = (torch.tensor([t, 371, 350], device=dev), labels,
            torch.tensor([s, 150, 120], device=dev))
    out = []
    for fn in (ctc.ctc_nll, ctc.ctc_nll_plain):
        lg = logits.clone().requires_grad_()
        nll = fn(lg, *args)
        out.append((nll, *torch.autograd.grad(nll.sum(), lg)))
    torch.cuda.synchronize()
    (got, got_g), (want, want_g) = out
    assert bool((want < 1e29).all())  # every utterance fits its label
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_g, want_g, rtol=0, atol=5e-4)


_BAD_LABEL = """
import torch
from robust_e2e_gan_torch.ops import ctc
lg = torch.randn((2, 20, 9), device="cuda", requires_grad=True)
labels = torch.tensor([[1, 2, 3], [4, 9, 5]], device="cuda")  # 9 = V
try:
    loss = ctc.ctc_loss(lg, torch.tensor([20, 20], device="cuda"), labels,
                        torch.tensor([3, 3], device="cuda"), impl="{impl}")
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised:", err)
else:
    print("no error:", loss.item())
"""


@pytest.mark.parametrize("impl", ["auto", "scan"])
def test_ctc_loss_bad_label_fails_on_both_paths(dev, impl):
    """A label outside [0, V) inside an utterance fails loudly on the card
    on both paths: torch.gather's device-side assert on the plain one, the
    forward kernel's on ctc_nll. A device-side assert ends the process's
    CUDA context, so each path runs in a process of its own."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _BAD_LABEL.format(impl=impl)],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert "raised:" in res.stdout and "assert" in res.stdout, (
        res.stdout + res.stderr)


def test_cuda_blstm_under_autograd_passes_gradients_upstream(dev):
    """The trap of an inference kernel under autograd: a cut gradient
    chain. Through the training kernels the enhancer's first BLSTM and the
    VGG convolutions below the encoder's BLSTM get non-zero gradients."""
    import dataclasses

    import numpy as np

    from robust_e2e_gan_torch.configs import tiny_config
    from robust_e2e_gan_torch.convert import from_flax, init_params
    from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
    from robust_e2e_gan_torch.ops import blstm_train
    from robust_e2e_gan_torch.pipeline import build_model

    jcfg = tiny_config(12)
    jcfg = dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(jcfg.e2e, encoder=dataclasses.replace(
            jcfg.e2e.encoder, lstm_impl="auto")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))
    model = build_model(jcfg)
    model.load_state_dict(from_flax(init_params(jcfg, seed=0)))
    model.to(dev)
    batch = make_batch(3, SyntheticConfig(vocab_size=12, min_tokens=2,
                                          max_tokens=4),
                       np.random.default_rng(0))
    wav, lens, labels = (torch.from_numpy(batch[k]).to(dev)
                         for k in ("noisy_wav", "wav_lengths", "labels"))
    launches = blstm_train.blstm_train.launches
    out = model.asr_forward(wav, lens, labels, use_enhancer=True)
    out["loss"].backward()
    torch.cuda.synchronize()
    assert blstm_train.blstm_train.launches > launches
    for p in (model.enhancer.blstm0.wx, model.asr.encoder.vgg.conv0_1.kernel):
        assert p.grad is not None and p.grad.abs().sum().item() > 0


def test_fbank_fused_kernels_match_plain(dev):
    """Forward (features, masks, exact-zero pad frames, an utterance shorter
    than one frame) and the backward to the waveform, float32 throughout."""
    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    cfg = FrontendConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, n = 4, 16000
    wav = torch.randn((b, n), generator=gen, device=dev)
    lens = torch.tensor([n, 9000, 300, 401], dtype=torch.int32, device=dev)
    launches = ff.fbank_fused.launches
    got, mask = ff.fbank_fused(wav, cfg, wav_lengths=lens)
    want, want_mask = ff.fbank_fused_plain(wav, cfg, wav_lengths=lens)
    torch.cuda.synchronize()
    assert ff.fbank_fused.launches == launches + 1
    torch.testing.assert_close(mask, want_mask, rtol=0, atol=0)
    # float32 DFT and mel sums in another order: ~1e-6 of O(1) features
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[mask == 0].any() and not got[2].any()

    g = torch.randn(got.shape, generator=gen, device=dev)
    n_valid = ff.valid_frames(wav, cfg, lens)
    for norm_var in (True, False):
        d_got = ff.fbank_fused_bwd(wav, n_valid, g, cfg, norm_var)
        d_want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg, norm_var)
        torch.cuda.synchronize()
        scale = d_want.abs().max().item()
        torch.testing.assert_close(d_got / scale, d_want / scale, rtol=1e-4,
                                   atol=1e-4)
        assert not d_got[1, 9000:].any() and not d_got[2].any()

    # the autograd form launches the forward and the backward kernels
    x = wav.clone().requires_grad_()
    bwd = ff.fbank_fused_bwd.launches
    feats, _ = ff.fbank_fused_trainable(x, cfg, wav_lengths=lens)
    (feats * g).sum().backward()
    torch.cuda.synchronize()
    assert ff.fbank_fused_bwd.launches == bwd + 1
    scale = x.grad.abs().max().item()
    d_want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg)
    torch.testing.assert_close(x.grad / scale, d_want / scale, rtol=1e-4,
                               atol=1e-4)


def _fbank_batch(dev, b, n, lens, seed=0, offset=0):
    """(B, N) waveform at ``offset`` floats past a 16-byte aligned base (a
    contiguous view), and its lengths as a tensor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn((b * n + offset,), generator=gen, device=dev)
    wav = flat[offset:].view(b, n)
    if not torch.is_tensor(lens):
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return wav, lens


def _fbank_routes(ff, wav, cfg, lens, norm_var=True):
    """The forward on auto, forced "tc" and forced "simt", with the route
    launches each took."""
    out = {}
    for route in ("auto", "tc", "simt"):
        before = dict(ff.FBANK_ROUTE_LAUNCHES)
        if route == "auto":
            got = ff.fbank_fused(wav, cfg, lens, norm_var)
        else:
            with ff._force_fbank_route(route):
                got = ff.fbank_fused(wav, cfg, lens, norm_var)
        took = {k: ff.FBANK_ROUTE_LAUNCHES[k] - before[k] for k in before}
        out[route] = (got, took)
    torch.cuda.synchronize()
    return out


FBANK_EDGES = {  # B, N, wav_lengths, changes to the flagship frontend
    "ragged": (4, 16_000, [16_000, 9_000, 4_321, 12_345], {}),
    "empty_utterance": (3, 16_000, [16_000, 300, 7_000], {}),
    "one_frame": (2, 559, [559, 400], {}),
    "n_mod4_1": (3, 16_001, [16_001, 8_001, 401], {}),
    "n_mod4_2": (2, 16_002, [16_002, 10_002], {}),
    "n_mod4_3": (2, 16_003, [16_003, 9_003], {}),
    "magnitude": (3, 16_000, [16_000, 9_000, 5_000], {"use_power": False}),
    "mels_40": (3, 16_000, [16_000, 9_000, 5_000], {"n_mels": 40}),
    "band_128": (3, 16_000, [16_000, 9_000, 5_000],
                 {"f_min": 4000.0, "n_mels": 24}),
}


@pytest.mark.parametrize("norm_var", [True, False], ids=["cmvn", "mean_only"])
@pytest.mark.parametrize("case", list(FBANK_EDGES))
def test_fbank_tc_route_matches_plain_and_simt(dev, case, norm_var):
    """Route "tc" (auto) against the plain version and route "simt" at
    rtol/atol 1e-4: ragged lengths, an utterance shorter than a frame
    (n_valid 0), T = 1, N % 4 in {1, 2, 3} (4-byte copies), magnitude
    spectra, 40 mels, a band of 128 bins (4 warps); pad frames exact
    zeros."""
    import dataclasses

    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    b, n, lens, changes = FBANK_EDGES[case]
    cfg = dataclasses.replace(FrontendConfig(), **changes)
    wav, lens = _fbank_batch(dev, b, n, lens)
    plan = ff.fbank_plan(cfg, b, n, *ff.device_limits(0), wav.data_ptr())
    assert plan is not None and plan.copy16 == (n % 4 == 0)
    runs = _fbank_routes(ff, wav, cfg, lens, norm_var)
    want, want_mask = ff.fbank_fused_plain(wav, cfg, lens, norm_var)
    assert runs["auto"][1] == {"tc": 1, "simt": 0}
    assert runs["tc"][1] == {"tc": 1, "simt": 0}
    assert runs["simt"][1] == {"tc": 0, "simt": 1}
    for route in ("auto", "simt"):
        got, mask = runs[route][0]
        torch.testing.assert_close(mask, want_mask, rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert not got[mask == 0].any()
    torch.testing.assert_close(runs["auto"][0][0], runs["simt"][0][0],
                               rtol=1e-4, atol=1e-4)


def test_fbank_tc_unaligned_waveform(dev):
    """A waveform 4 bytes past a 16-byte boundary takes 4-byte copies."""
    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    cfg = FrontendConfig()
    wav, lens = _fbank_batch(dev, 3, 16_000, [16_000, 9_000, 401], offset=1)
    assert wav.data_ptr() % 16 == 4 and wav.is_contiguous()
    plan = ff.fbank_plan(cfg, 3, 16_000, *ff.device_limits(0), wav.data_ptr())
    assert not plan.copy16
    runs = _fbank_routes(ff, wav, cfg, lens)
    want, _ = ff.fbank_fused_plain(wav, cfg, lens)
    torch.testing.assert_close(runs["auto"][0][0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(128, 111_360), (32, 46_080)],
                         ids=["decode", "train"])
def test_fbank_auto_takes_tc_at_flagship_shapes(dev, shape):
    """At the decode's and the train step's shapes auto takes route "tc"
    (64- and 32-frame tiles), held to the plain version at rtol/atol 1e-4,
    and a rerun is bit-identical."""
    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    cfg = FrontendConfig()
    b, n = shape
    gen = torch.Generator(device=dev).manual_seed(b)
    lens = torch.randint(n // 2, n + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = n
    wav, lens = _fbank_batch(dev, b, n, lens)
    plan = ff.fbank_plan(cfg, b, n, *ff.device_limits(0), wav.data_ptr())
    assert plan.tm == (64 if b == 128 else 32)
    before = dict(ff.FBANK_ROUTE_LAUNCHES)
    got, mask = ff.fbank_fused(wav, cfg, lens)
    again, _ = ff.fbank_fused(wav, cfg, lens)
    torch.cuda.synchronize()
    assert ff.FBANK_ROUTE_LAUNCHES == {"tc": before["tc"] + 2,
                                       "simt": before["simt"]}
    assert torch.equal(got, again)
    want, _ = ff.fbank_fused_plain(wav, cfg, lens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[mask == 0].any()


@pytest.mark.parametrize("route", ["tc", "simt"])
def test_fbank_bwd_recompute_on_each_route(dev, route):
    """The backward's dwav with its log-mel recomputed on each route,
    against the plain version at 1e-4 of max|plain|."""
    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    cfg = FrontendConfig()
    wav, lens = _fbank_batch(dev, 4, 16_000, [16_000, 9_000, 300, 12_001])
    n_valid = ff.valid_frames(wav, cfg, lens)
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn((4, n_valid.max().item(), cfg.n_mels), generator=gen,
                    device=dev)
    with ff._force_fbank_route(route):
        d_got = ff.fbank_fused_bwd(wav, n_valid, g, cfg)
    d_want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg)
    torch.cuda.synchronize()
    scale = d_want.abs().max().item()
    torch.testing.assert_close(d_got / scale, d_want / scale, rtol=1e-4,
                               atol=1e-4)
    assert not d_got[1, 9000:].any() and not d_got[2].any()


def test_fbank_forced_tc_past_the_plan_raises(dev):
    """A frame shift off a multiple of 8 is past the plan: auto takes
    "simt", a forced "tc" raises before any launch."""
    import dataclasses

    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    cfg = dataclasses.replace(FrontendConfig(), frame_shift=164)
    wav, lens = _fbank_batch(dev, 2, 16_000, [16_000, 8_000])
    before = dict(ff.FBANK_ROUTE_LAUNCHES)
    got, _ = ff.fbank_fused(wav, cfg, lens)
    assert ff.FBANK_ROUTE_LAUNCHES == {"tc": before["tc"],
                                       "simt": before["simt"] + 1}
    want, _ = ff.fbank_fused_plain(wav, cfg, lens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with ff._force_fbank_route("tc"), pytest.raises(ValueError,
                                                    match="does not fit"):
        ff.fbank_fused(wav, cfg, lens)
    assert ff.FBANK_ROUTE_LAUNCHES["tc"] == before["tc"]


FBANK_BWD_CASES = {  # B, N, wav_lengths, float offset, frontend changes
    "ragged": (4, 16_000, [16_000, 9_000, 300, 12_001], 0, {}),
    "unaligned": (3, 16_000, [16_000, 9_000, 401], 1, {}),
    "n_mod4_3": (2, 16_003, [16_003, 9_003], 0, {}),
    "one_frame": (2, 559, [559, 400], 0, {}),
    "mels_40": (3, 16_000, [16_000, 9_000, 5_000], 0, {"n_mels": 40}),
    "band_128": (3, 16_000, [16_000, 9_000, 5_000], 0,
                 {"f_min": 4000.0, "n_mels": 24}),
}


def _fbank_bwd_routes(ff, wav, n_valid, g, cfg, norm_var=True):
    """The backward with its frame pass on auto, forced "tc" and forced
    "simt", with the frame-pass launches each took."""
    out = {}
    for route in ("auto", "tc", "simt"):
        before = dict(ff.FBANK_BWD_ROUTE_LAUNCHES)
        if route == "auto":
            got = ff.fbank_fused_bwd(wav, n_valid, g, cfg, norm_var)
        else:
            with ff._force_fbank_bwd_route(route):
                got = ff.fbank_fused_bwd(wav, n_valid, g, cfg, norm_var)
        took = {k: ff.FBANK_BWD_ROUTE_LAUNCHES[k] - before[k] for k in before}
        out[route] = (got, took)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("norm_var", [True, False], ids=["cmvn", "mean_only"])
@pytest.mark.parametrize("case", list(FBANK_BWD_CASES))
def test_fbank_bwd_tc_route_matches_plain_and_simt(dev, case, norm_var):
    """The backward's frame pass on route "tc" (auto) and "simt" against
    the plain version at 1e-4 of max|plain|: ragged lengths with an
    utterance shorter than a frame, a waveform 4 bytes past a 16-byte
    boundary and N % 4 == 3 (the recompute's 4-byte copies), T = 1, 40
    mels, a band of 128 bins; nothing past each utterance's end."""
    import dataclasses

    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    b, n, lens, offset, changes = FBANK_BWD_CASES[case]
    cfg = dataclasses.replace(FrontendConfig(), **changes)
    wav, lens = _fbank_batch(dev, b, n, lens, offset=offset)
    plan = ff.fbank_bwd_plan(cfg, b, n, *ff.device_limits(0), wav.data_ptr())
    assert plan is not None and plan.nbins == ff.padded_bins(cfg)
    n_valid = ff.valid_frames(wav, cfg, lens)
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.randn((b, ff.fbank_ref.num_frames(n, cfg), cfg.n_mels),
                    generator=gen, device=dev)
    runs = _fbank_bwd_routes(ff, wav, n_valid, g, cfg, norm_var)
    want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg, norm_var)
    assert runs["auto"][1] == {"tc": 1, "simt": 0}
    assert runs["tc"][1] == {"tc": 1, "simt": 0}
    assert runs["simt"][1] == {"tc": 0, "simt": 1}
    scale = max(want.abs().max().item(), 1e-30)
    for route in ("auto", "simt"):
        got = runs[route][0]
        torch.testing.assert_close(got / scale, want / scale, rtol=1e-4,
                                   atol=1e-4)
        for i, length in enumerate(lens.tolist()):
            assert not got[i, length:].any()


@pytest.mark.parametrize("shape", [(128, 111_360), (32, 46_080)],
                         ids=["decode", "train"])
def test_fbank_bwd_auto_takes_tc_at_flagship_shapes(dev, shape):
    """At the decode's and the train step's shapes the backward's frame
    pass takes route "tc" on auto, held to the plain version at 1e-4 of
    max|plain|, and a rerun is bit-identical."""
    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    cfg = FrontendConfig()
    b, n = shape
    gen = torch.Generator(device=dev).manual_seed(b + 1)
    lens = torch.randint(n // 2, n + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = n
    wav, lens = _fbank_batch(dev, b, n, lens)
    n_valid = ff.valid_frames(wav, cfg, lens)
    g = torch.randn((b, ff.fbank_ref.num_frames(n, cfg), cfg.n_mels),
                    generator=gen, device=dev)
    assert ff.fbank_bwd_plan(cfg, b, n, *ff.device_limits(0),
                             wav.data_ptr()) is not None
    before = dict(ff.FBANK_BWD_ROUTE_LAUNCHES)
    got = ff.fbank_fused_bwd(wav, n_valid, g, cfg)
    again = ff.fbank_fused_bwd(wav, n_valid, g, cfg)
    torch.cuda.synchronize()
    assert ff.FBANK_BWD_ROUTE_LAUNCHES == {"tc": before["tc"] + 2,
                                           "simt": before["simt"]}
    assert torch.equal(got, again)
    want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg)
    scale = want.abs().max().item()
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-4,
                               atol=1e-4)


def test_fbank_bwd_forced_tc_past_the_plan_raises(dev):
    """Past the plan (a frame shift off a multiple of 8, whose recompute
    takes "simt") auto takes "simt"; a forced "tc" raises before any
    launch, as it does with the recompute forced onto "simt"."""
    import dataclasses

    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import fbank_fused as ff

    for cfg, force in ((dataclasses.replace(FrontendConfig(),
                                            frame_shift=164), None),
                       (FrontendConfig(), "simt")):
        wav, lens = _fbank_batch(dev, 2, 16_000, [16_000, 8_000])
        n_valid = ff.valid_frames(wav, cfg, lens)
        g = torch.randn((2, ff.fbank_ref.num_frames(16_000, cfg),
                         cfg.n_mels), device=dev)
        with contextlib.ExitStack() as stack:
            if force:
                stack.enter_context(ff._force_fbank_route(force))
            before = dict(ff.FBANK_BWD_ROUTE_LAUNCHES)
            launches = ff.fbank_fused_bwd.launches
            got = ff.fbank_fused_bwd(wav, n_valid, g, cfg)
            assert ff.FBANK_BWD_ROUTE_LAUNCHES == {
                "tc": before["tc"], "simt": before["simt"] + 1}
            want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg)
            scale = want.abs().max().item()
            torch.testing.assert_close(got / scale, want / scale, rtol=1e-4,
                                       atol=1e-4)
            with ff._force_fbank_bwd_route("tc"), pytest.raises(
                    ValueError, match="does not fit"):
                ff.fbank_fused_bwd(wav, n_valid, g, cfg)
            assert ff.fbank_fused_bwd.launches == launches + 1
            assert ff.FBANK_BWD_ROUTE_LAUNCHES["tc"] == before["tc"]


def _lm_args(gen, dev, layers, n, h, e, v):
    """lm_step's arguments at its tests' scales."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    tok = torch.randint(0, v, (n,), generator=gen, device=dev)
    return (tok, rnd(v, e),
            [rnd(e if i == 0 else h, 4 * h, scale=e ** -0.5)
             for i in range(layers)],
            [rnd(h, 4 * h, scale=h ** -0.5) for _ in range(layers)],
            [rnd(4 * h, scale=0.3) for _ in range(layers)],
            rnd(h, v, scale=h ** -0.5), rnd(v, scale=0.3),
            rnd(layers, n, h, scale=0.5), rnd(layers, n, h, scale=0.5))


def _lm_on_route(route, *args, dtype):
    """lm_step forced onto ``route``; checks that it launched there once."""
    from robust_e2e_gan_torch.ops import lm_step as ls

    launches, before = ls.lm_step.launches, dict(ls.LM_ROUTE_LAUNCHES)
    with ls._force_lm_route(route):
        got = ls.lm_step(*args, dtype=dtype)
    assert ls.lm_step.launches == launches + 1
    assert {k: ls.LM_ROUTE_LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == route) for k in before}
    return got


@pytest.mark.parametrize("route", ["tile", "lane"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("layers,n,h,e,v", [(1, 9, 24, 16, 200),
                                             (2, 1024, 256, 128, 52),
                                             (1, 33, 512, 512, 12)])
def test_lm_step_kernel_matches_plain(dev, dtype, layers, n, h, e, v, route):
    """Both routes of the LM step against the plain version, launches
    counted by route: N not a multiple of the tile route's 64 lanes and H
    not a multiple of its 32 units (its padding), two layers (a grid
    barrier a layer) and the decode CLI's E = H = 512 (more tiles than
    blocks)."""
    from robust_e2e_gan_torch.ops import lm_step as ls

    gen = torch.Generator(device=dev).manual_seed(h)
    args = _lm_args(gen, dev, layers, n, h, e, v)
    got = _lm_on_route(route, *args, dtype=dtype)
    want = ls.lm_step_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **_tol(dtype, w))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_lm_step_tile_is_deterministic_and_agrees(dev, dtype, layers):
    """At the clean decode's LM (N = 1,024, E = 128, H = 256, V = 52) the
    "tile" route is the default, two runs of it are bit-identical, and it
    agrees with the "lane" route within each one's tolerance against the
    plain version."""
    from robust_e2e_gan_torch.ops import lm_step as ls

    gen = torch.Generator(device=dev).manual_seed(17 + layers)
    args = _lm_args(gen, dev, layers, 1024, 256, 128, 52)
    before = dict(ls.LM_ROUTE_LAUNCHES)
    runs = [ls.lm_step(*args, dtype=dtype) for _ in range(2)]
    assert ls.LM_ROUTE_LAUNCHES["tile"] == before["tile"] + 2
    assert ls.LM_ROUTE_LAUNCHES["lane"] == before["lane"]
    lane = _lm_on_route("lane", *args, dtype=dtype)
    torch.cuda.synchronize()
    for r0, r1, ln in zip(*runs, lane):
        assert torch.equal(r0, r1)
        torch.testing.assert_close(r0, ln, **_tol(dtype, ln))


def test_lm_step_tile_refusals(dev):
    """Forcing route "tile" past its plan (E not whole 16-byte pieces in
    bfloat16, a Wout beyond shared memory) raises before any launch, and
    the unforced call takes route "lane"; a launch whose shared-memory
    bytes disagree with the kernel's layout, or whose grid cannot be
    co-resident, raises, never runs, and leaves no error for the next
    launch."""
    from robust_e2e_gan_torch.ops import lm_step as ls
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(19)
    for e, v, dtype in ((20, 52, torch.bfloat16),
                        (128, 5000, torch.float32)):
        args = _lm_args(gen, dev, 1, 70, 256, e, v)
        routes = dict(ls.LM_ROUTE_LAUNCHES)
        with ls._force_lm_route("tile"), pytest.raises(ValueError,
                                                       match="tile route"):
            ls.lm_step(*args, dtype=dtype)
        assert ls.LM_ROUTE_LAUNCHES == routes
        got = ls.lm_step(*args, dtype=dtype)
        assert ls.LM_ROUTE_LAUNCHES["lane"] == routes["lane"] + 1
        want = ls.lm_step_plain(*args, dtype=dtype)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **_tol(dtype, w))
    n, v, e, h = 1024, 52, 128, 256
    args = _lm_args(gen, dev, 1, n, h, e, v)
    kc, stages, grid, smem = ls.tile_plan(
        n, v, e, h, 1, 4, *att.device_limits(dev.index or 0))
    ins = [args[0].int(), args[1], args[2][0], args[2][0], args[3][0],
           args[4][0], args[5], args[6], args[7], args[8]]
    outs = [torch.empty_like(args[7]), torch.empty_like(args[8]),
            torch.empty((n, v), device=dev)]
    scratch = torch.empty((1, n, h), device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for bad_grid, bad_smem in ((grid, smem + 16), (100_000, smem)):
        with pytest.raises(RuntimeError, match="lm_step_tile"):
            launch("lm_step_tile", *(x.data_ptr() for x in ins),
                   *(x.data_ptr() for x in outs), scratch.data_ptr(),
                   count.data_ptr(), n, v, e, h, 1, kc, stages, bad_grid,
                   bad_smem, 0, 0, stream)
    assert int(count) == 0
    got = _lm_on_route("tile", *args, dtype=torch.float32)
    want = ls.lm_step_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(torch.float32, w))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("k,h", [(3, 24), (10, 256)])
def test_att_dec_kernel_matches_plain(dev, dtype, k, h):
    """The fused decoder step: ragged masks, one and two passes of the
    cell's 8 lanes, and a plan past the shared memory raising."""
    from robust_e2e_gan_torch.ops import att_dec

    gen = torch.Generator(device=dev).manual_seed(h)
    b, t, c, a, e, v, embd = 3, 37, 10, 64, 48, 30, 40

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    mask = (torch.arange(t, device=dev)[None]
            < torch.tensor([[t], [5], [0]], device=dev)).to(dtype)
    f32 = torch.float32
    args = (rnd(b, k, t, c, scale=0.1), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a), rnd(a, scale=0.3), mask, 2.0,
            torch.randint(0, v, (b, k), generator=gen, device=dev),
            rnd(v, embd), rnd(embd + e, 4 * h, scale=(embd + e) ** -0.5),
            rnd(h, 4 * h, scale=h ** -0.5), rnd(4 * h, scale=0.3, dt=f32),
            rnd(h + e, v, scale=(h + e) ** -0.5), rnd(v, scale=0.3, dt=f32),
            rnd(b, k, h, scale=0.5, dt=f32), rnd(b, k, h, scale=0.5, dt=f32))
    launches = att_dec.att_dec_step.launches
    got = att_dec.att_dec_step(*args)
    want = att_dec.att_dec_step_plain(*args)
    torch.cuda.synchronize()
    assert att_dec.att_dec_step.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **_tol(dtype, w))
    assert not got[1][1, :, 5:].any()
    big = 700  # K lanes whose [emb | ctx] and z rows overflow the block
    with pytest.raises(ValueError, match="shared memory"):
        att_dec.att_dec_step(
            rnd(b, big, t, c), *args[1:3], rnd(b, big, a), *args[4:8],
            torch.zeros((b, big), dtype=torch.long, device=dev), *args[9:15],
            rnd(b, big, h, dt=f32), rnd(b, big, h, dt=f32))


def _dec_args(gen, dev, b, k, t, c, a, e, embd, h, v, dtype, lens):
    """att_dec_step's arguments at its tests' scales, mask from lens."""
    f32 = torch.float32

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    return (*_att_args(gen, dev, b, k, t, c, a, e, dtype, lens), 2.0,
            torch.randint(0, v, (b, k), generator=gen, device=dev),
            rnd(v, embd), rnd(embd + e, 4 * h, scale=(embd + e) ** -0.5),
            rnd(h, 4 * h, scale=h ** -0.5), rnd(4 * h, scale=0.3, dt=f32),
            rnd(h + e, v, scale=(h + e) ** -0.5), rnd(v, scale=0.3, dt=f32),
            rnd(b, k, h, scale=0.5, dt=f32), rnd(b, k, h, scale=0.5, dt=f32))


def _dec_on_route(route, *args):
    """att_dec_step forced onto ``route``; checks that it launched there."""
    from robust_e2e_gan_torch.ops import att_dec

    before = dict(att_dec.DEC_ROUTE_LAUNCHES)
    with att_dec._force_dec_route(route):
        got = att_dec.att_dec_step(*args)
    after = dict(att_dec.DEC_ROUTE_LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    return got


# (B, K, T, C, A, E, EMB, H, V): one utterance; more utterances than the
# grid's blocks (132 on an H100) with K = 3 and H = 40, not a multiple of
# the 32-unit tile; K = 1 and V = 300, past one readout chunk of threads;
# K = 16 with V = 300; the flagship's widths
DEC_SHAPES = [(1, 8, 37, 10, 64, 48, 40, 64, 9),
              (150, 3, 29, 10, 64, 48, 40, 40, 9),
              (5, 1, 37, 10, 64, 48, 40, 64, 300),
              (4, 16, 50, 10, 64, 48, 40, 256, 300),
              (3, 8, 174, 10, 256, 256, 256, 256, 52)]


@pytest.mark.parametrize("route", ["utt", "hyp"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DEC_SHAPES,
                         ids=["x".join(map(str, s)) for s in DEC_SHAPES])
def test_att_dec_routes_match_plain(dev, shape, dtype, route):
    """Both routes of the fused decoder step against the plain version:
    ragged masks with the last row empty (where B > 1), whose att is exact
    zeros, and pad frames exact zeros."""
    from robust_e2e_gan_torch.ops import att_dec

    b, k, t, c, a, e, embd, h, v = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev).tolist()
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    args = _dec_args(gen, dev, b, k, t, c, a, e, embd, h, v, dtype, lens)
    got = _dec_on_route(route, *args)
    want = att_dec.att_dec_step_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **_tol(dtype, w))
    pad = torch.arange(t, device=dev)[None] >= torch.tensor(lens, device=dev)[:, None]
    assert not got[1].permute(0, 2, 1)[pad].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_att_dec_utt_is_deterministic_and_agrees(dev, dtype):
    """Two runs of route "utt" at the flagship's decode shape are
    bit-identical, and the two routes agree within the tolerance of each
    against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(11)
    lens = torch.randint(87, 175, (128,), generator=gen, device=dev).tolist()
    args = _dec_args(gen, dev, 128, 8, 174, 10, 256, 256, 256, 256, 52, dtype,
                     lens)
    runs = [_dec_on_route("utt", *args) for _ in range(2)]
    hyp = _dec_on_route("hyp", *args)
    torch.cuda.synchronize()
    for r0, r1, hh in zip(*runs, hyp):
        assert torch.equal(r0, r1)
        torch.testing.assert_close(r0, hh, **_tol(dtype, hh))


def test_att_dec_utt_refusals(dev):
    """Forcing route "utt" past its plan (K = 17, H not a multiple of 8)
    raises before any launch; a launch whose shared-memory bytes disagree
    with the kernel's layout, or whose grid cannot be co-resident, raises,
    never runs, and leaves no error for the next launch."""
    from robust_e2e_gan_torch.ops import att_dec
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(13)
    for k, h in ((17, 64), (8, 20)):
        args = _dec_args(gen, dev, 2, k, 20, 10, 64, 48, 40, h, 9,
                         torch.bfloat16, [20, 7])
        routes = dict(att_dec.DEC_ROUTE_LAUNCHES)
        with att_dec._force_dec_route("utt"), pytest.raises(ValueError):
            att_dec.att_dec_step(*args)
        assert att_dec.DEC_ROUTE_LAUNCHES == routes
    b, k, t, c, a, e, embd, h, v = 2, 8, 174, 10, 256, 256, 256, 256, 52
    args = _dec_args(gen, dev, b, k, t, c, a, e, embd, h, v, torch.bfloat16,
                     [t, 9])
    chunk, splits, vc, grid, smem = att_dec.utt_plan(
        b, k, t, c, a, e, embd, h, v, 2, *att.device_limits(dev.index or 0))
    ins = ([x.contiguous() for x in args[:6]] + [args[6].float(), args[8].int()]
           + list(args[9:]))
    outs = [torch.empty(s, device=dev) for s in
            ((b, k, v), (b, k, t), (b, k, h), (b, k, h))]
    xin = torch.empty((b * k, att_dec.utt_row_width(embd, e, h, 2)),
                      dtype=torch.bfloat16, device=dev)
    zq = torch.empty((b * k, h), dtype=torch.bfloat16, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for bad_grid, bad_smem in ((grid, smem + 16), (100_000, smem)):
        with pytest.raises(RuntimeError, match="att_dec_utt"):
            launch("att_dec_utt", *(x.data_ptr() for x in ins),
                   *(x.data_ptr() for x in outs), xin.data_ptr(),
                   zq.data_ptr(), count.data_ptr(), b, k, t, c, a, e, v, embd,
                   h, chunk, splits, vc, bad_grid, bad_smem, 0, 2.0, 1, stream)
    torch.cuda.synchronize()
    assert count.item() == 0
    got = _dec_on_route("utt", *args)
    want = att_dec.att_dec_step_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(torch.bfloat16, w))


def _utt_parents(gen, dev, lpz, k, steps):
    """Parents ``steps`` tokens deep (repeats included) of every row, by
    the state kernel: (last_tok, lengths, r_n, r_b)."""
    b, t, v = lpz.shape
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for step in range(steps):
        tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        tok[:, 0] = last[:, 0] if step else tok[:, 0]
        r_n, r_b = ctc_prefix.prefix_state(lpz, tok, last, lens, r_n, r_b, 0)
        last, lens = tok, lens + 1
    return last, lens, r_n, r_b


def test_ctc_prefix_utt_kernel_matches_plain(dev):
    """The per-utterance psi kernel, eos and blank columns included: over
    three steps of parents at a small shape (V % 4 != 0: lpz by 4-byte
    pieces), at the flagship decode (B=128, K=8, T=174, V=52: lpz by bulk
    copies; and from a base off 16-byte alignment: 4-byte pieces), and at
    T = 1,200 (19 chunks through the ring; a length the old whole-utterance
    staging refused); K*V past a block's threads raises."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, k, t, v = 3, 4, 29, 9
    lpz = torch.log_softmax(
        torch.randn((b, t, v), generator=gen, device=dev), -1).contiguous()
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    launches = ctc_prefix.prefix_psi_utt.launches
    for step in range(3):
        psi = ctc_prefix.prefix_psi_utt(lpz, last, lens, r_n, r_b, 0, 1)
        want = ctc_prefix.prefix_psi_plain(lpz, last, lens, r_n, r_b, 0, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(psi, want, rtol=0, atol=1e-3)
        tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        tok[:, 0] = last[:, 0] if step else tok[:, 0]
        r_n, r_b = ctc_prefix.prefix_state(lpz, tok, last, lens, r_n, r_b, 0)
        last, lens = tok, lens + 1
    assert ctc_prefix.prefix_psi_utt.launches == launches + 3
    for b, t in ((128, 174), (16, 1200)):
        lpz = _prefix_lpz(gen, dev, b, t, 52, 0)
        parents = _utt_parents(gen, dev, lpz, 8, 2)
        want = ctc_prefix.prefix_psi_plain(lpz, *parents, 0, 1)
        got = ctc_prefix.prefix_psi_utt(lpz, *parents, 0, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
        if t == 174:
            buf = torch.empty(lpz.numel() + 1, device=dev)
            off = buf[1:].view(lpz.shape)
            off.copy_(lpz)
            assert off.data_ptr() % 16 != 0
            got = ctc_prefix.prefix_psi_utt(off, *parents, 0, 1)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    wide = torch.zeros((b, 40), dtype=torch.int32, device=dev)
    rows = torch.zeros((b, 40, t), device=dev)
    with pytest.raises(ValueError, match="threads"):
        ctc_prefix.prefix_psi_utt(torch.zeros((b, t, 30), device=dev), wide,
                                  wide, rows, rows, 0, 1)


def test_ctc_prefix_utt_is_deterministic(dev):
    """Two runs of the per-utterance psi kernel are bit-identical, at the
    flagship decode and at T = 1,200, and a launch whose shared-memory
    bytes disagree with the kernel's layout is refused."""
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(5)
    for b, t in ((128, 174), (16, 1200)):
        lpz = _prefix_lpz(gen, dev, b, t, 52, 0)
        parents = _utt_parents(gen, dev, lpz, 8, 2)
        runs = [ctc_prefix.prefix_psi_utt(lpz, *parents, 0, 1)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
    splits, chunk, stages = ctc_prefix.utt_psi_plan(8, t, 52, 232_448)
    smem = ctc_prefix.utt_psi_smem(8, 52, splits, chunk, stages)
    with pytest.raises(RuntimeError, match="ctc_prefix_utt"):
        launch("ctc_prefix_utt", lpz.data_ptr(),
               *(x.data_ptr() for x in parents), runs[0].data_ptr(), b, 8, t,
               52, 0, 1, splits, chunk, stages, smem + 16,
               torch.cuda.current_stream(dev).cuda_stream)
    got = ctc_prefix.prefix_psi_utt(lpz, *parents, 0, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, runs[0])


def test_decode_cli_on_the_card(dev, tmp_path):
    """``train.cli`` then ``decode.cli`` on the card at a small model:
    ``--serving-impls fused`` launches the fused step once per beam step and
    decodes what ``xla`` (the plain versions) decodes."""
    import json

    import numpy as np

    from robust_e2e_gan_torch.data.synthetic import (
        SyntheticConfig,
        sample_transcript,
        synth_utterance,
    )
    from robust_e2e_gan_torch.decode import cli as decode_cli
    from robust_e2e_gan_torch.ops import att_dec
    from robust_e2e_gan_torch.train import cli as train_cli

    ckpt = str(tmp_path / "exp")
    train_cli.main(["--mode", "joint", "--synthetic", "--ckpt-dir", ckpt,
                    "--synthetic-utts", "8", "--batch-size", "4",
                    "--epochs", "1", "--n-mels", "24", "--enc-layers", "1",
                    "--enc-hidden", "32", "--enc-proj", "32", "--att-dim",
                    "24", "--dec-hidden", "32", "--dec-embed", "16",
                    "--enh-layers", "1", "--enh-hidden", "32"])
    synth = SyntheticConfig()
    rng = np.random.default_rng(0)
    entries = []
    for i in range(6):
        _, noisy = synth_utterance(sample_transcript(synth, rng), synth, rng)
        np.save(tmp_path / f"u{i}.npy", noisy)
        entries.append({"utt_id": f"u{i}", "noisy": f"u{i}.npy",
                        "n_samples": len(noisy), "text": "ab"})
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("\n".join(json.dumps(e) for e in entries))
    hyps = {}
    for impls in ("fused", "xla"):
        out = tmp_path / impls
        launches = att_dec.att_dec_step.launches
        decode_cli.main(["--manifest", str(manifest), "--ckpt-dir", ckpt,
                         "--out", str(out), "--batch-size", "4",
                         "--beam-size", "3", "--max-steps", "5",
                         "--no-early-exit", "--serving-impls", impls])
        torch.cuda.synchronize()
        # two batches of 4 (the second padded), 5 steps each
        assert att_dec.att_dec_step.launches - launches == (
            10 if impls == "fused" else 0)
        hyps[impls] = (out / "hyp.txt").read_text()
    assert hyps["fused"] == hyps["xla"]
    assert len(hyps["fused"].splitlines()) == 6


def test_async_snapshot_of_a_cuda_state(dev, tmp_path):
    """``AsyncCheckpointer.save`` of a state on the card: the checkpoint
    holds the parameters and optimizer state of the moment of ``save()``,
    though in-place steps on the card's stream follow at once."""
    from robust_e2e_gan_torch.configs import tiny_config
    from robust_e2e_gan_torch.config import TrainConfig
    from robust_e2e_gan_torch.train.loop import init_state
    from robust_e2e_gan_torch.utils import checkpoint as ckpt

    state = init_state(tiny_config(12), TrainConfig(), dev)
    opt = state.opt_g
    opt.step([torch.full_like(p, 0.1) for p in opt.params])
    want = {k: v.cpu() for k, v in state.model.state_dict().items()}
    want_acc = [s["square_avg"].cpu() for s in opt.opt.state.values()]
    with ckpt.AsyncCheckpointer() as saver:
        saver.save(str(tmp_path), state, 1)
        for _ in range(3):  # steps queued on the card at once
            opt.step([torch.full_like(p, 0.3) for p in opt.params])
            with torch.no_grad():
                for p in state.model.parameters():
                    p.mul_(1.5).add_(1.0)
    saved = torch.load(tmp_path / "ckpt_1.pt", weights_only=True)
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
        assert saved["model"][k].device.type == "cpu"
    got_acc = [s["square_avg"] for s in saved["opt_g"]["opt"]["state"]
               .values()]
    assert all(torch.equal(a, b) for a, b in zip(got_acc, want_acc))


def test_two_gloo_ranks_on_one_card_step_as_one_process(dev):
    """``chip_smoke.py`` phase 21's two-rank train step: two gloo ranks on
    cuda:0 take 8 rows each of a float32 B=16 batch of the flagship
    (shards with different token counts) through one joint step on the
    kernels; the metrics, both gradient norms included, equal one
    process's at rtol 2e-4 / atol 2e-5 (``tests/test_parallel.py:93-96``),
    and every rank launches ``blstm_train``, ``gemm`` and ``ctc_nll`` and
    no plain version."""
    import dataclasses

    import numpy as np

    from robust_e2e_gan_torch.config import TrainConfig
    from robust_e2e_gan_torch.configs import flagship_config
    from robust_e2e_gan_torch.convert import (
        from_flax,
        init_disc_params,
        init_params,
    )
    from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
    from robust_e2e_gan_torch.parallel import launch, make_mesh
    from robust_e2e_gan_torch.tools import dp_phases

    jcfg = flagship_config(52)
    jcfg = dataclasses.replace(
        jcfg, e2e=dataclasses.replace(
            jcfg.e2e, ctc_impl="auto", encoder=dataclasses.replace(
                jcfg.e2e.encoder, lstm_impl="auto")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))
    state_g = from_flax(init_params(jcfg, seed=0))
    state_d = from_flax(init_disc_params(jcfg.discriminator, seed=1))
    synth = SyntheticConfig(vocab_size=52, min_tokens=20, max_tokens=24)
    batch = make_batch(16, synth, np.random.default_rng(100))
    batch["labels"][8:, synth.min_tokens:] = -1
    args = (jcfg, TrainConfig(), state_g, state_d, [batch])
    ranks = launch(dp_phases.joint_steps, make_mesh(2, 1, "cuda:0"), *args,
                   limit_s=600.0)
    one = dp_phases.joint_steps(None, *args, device="cuda")
    for rank in ranks:
        for k, want in one["metrics"][0].items():
            np.testing.assert_allclose(rank["metrics"][0][k], want,
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        launched = rank["launches"]
        assert all(launched[k] > 0 for k in ("blstm_train", "gemm",
                                             "ctc_nll")), launched
        assert not any(launched[k] for k in (
            "blstm_train_plain", "gemm_plain", "ctc_nll_plain")), launched


def _flagship_f32_kernels():
    import dataclasses

    from robust_e2e_gan_torch.configs import flagship_config

    jcfg = flagship_config(52)
    return dataclasses.replace(
        jcfg, e2e=dataclasses.replace(
            jcfg.e2e, ctc_impl="auto", encoder=dataclasses.replace(
                jcfg.e2e.encoder, lstm_impl="auto")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))


def test_tensor_parallel_gloo_ranks_on_one_card_step_as_one_process(dev):
    """``chip_smoke.py`` phase 24 (2): a (1, 2) mesh of two gloo ranks on
    cuda:0 takes one float32 joint step of the flagship with its 14
    partition_rule leaves model-sharded, deterministic algorithms on: the
    losses bit-equal to one process's, the gradient norms and the
    parameters within 1e-6 relative (the full norm sums the shards in
    another order), every rank launching ``blstm_train``, ``gemm`` and
    ``ctc_nll`` and no plain version."""
    import numpy as np

    from robust_e2e_gan_torch.config import TrainConfig
    from robust_e2e_gan_torch.convert import (
        from_flax,
        init_disc_params,
        init_params,
    )
    from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
    from robust_e2e_gan_torch.parallel import launch, make_mesh
    from robust_e2e_gan_torch.tools import dp_phases

    jcfg = _flagship_f32_kernels()
    state_g = from_flax(init_params(jcfg, seed=0))
    state_d = from_flax(init_disc_params(jcfg.discriminator, seed=1))
    synth = SyntheticConfig(vocab_size=52, min_tokens=20, max_tokens=24)
    batch = make_batch(16, synth, np.random.default_rng(100))
    args = (jcfg, TrainConfig(), state_g, state_d, [batch])
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        ranks = launch(dp_phases.joint_steps, make_mesh(1, 2, "cuda:0"),
                       *args, limit_s=600.0)
        one = dp_phases.joint_steps(None, *args, device="cuda")
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
    for rank in ranks:
        assert len(rank["shards"]) == 14
        for k, want in one["metrics"][0].items():
            got = rank["metrics"][0][k]
            if k.startswith("grad_norm"):
                assert abs(got - want) <= 1e-6 * abs(want), k
            else:
                assert got == want, k
        for k, want in one["params"].items():
            diff = (rank["params"][k] - want).abs().max().item()
            assert diff <= 1e-6 * max(want.abs().max().item(), 1.0), k
        launched = rank["launches"]
        assert all(launched[k] > 0 for k in ("blstm_train", "gemm",
                                             "ctc_nll")), launched
        assert not any(launched[k] for k in (
            "blstm_train_plain", "gemm_plain", "ctc_nll_plain")), launched


def test_tensor_parallel_sharded_cluster_blstm_equals_whole(dev):
    """``tests/test_parallel.py:339-365`` on the card: the flagship's
    enhancer layer 0 in bfloat16 at B=128 (the cluster route) with wx, wh
    and bias model-sharded over two gloo ranks on cuda:0 gives the
    unsharded layer's output bit for bit on every rank, and one
    process's."""
    from robust_e2e_gan_torch.convert import from_flax, init_params
    from robust_e2e_gan_torch.ops.fbank import num_frames
    from robust_e2e_gan_torch.parallel import launch, make_mesh
    from robust_e2e_gan_torch.tools import dp_phases

    jcfg = _flagship_f32_kernels()
    state_g = from_flax(init_params(jcfg, seed=0))
    weights = {k: state_g[f"enhancer.blstm0.{k}"]
               for k in ("wx", "wh", "bias")}
    args = (weights, 128, num_frames(111_360, jcfg.e2e.frontend),
            torch.bfloat16, 0)
    ranks = launch(dp_phases.blstm_layer, make_mesh(1, 2, "cuda:0"), *args,
                   limit_s=600.0)
    one = dp_phases.blstm_layer(None, *args, device="cuda")
    for rank in ranks:
        assert rank["equal"] and rank["sha256"] == one["sha256"]
        assert len(rank["sharded"]) == 3
        assert rank["launches"]["blstm_infer_cluster"] == 1, rank["launches"]


def test_host_library_builds_on_the_card_machine(dev):
    """``utils/native.py`` builds ``csrc/host`` with this machine's g++ and
    its readers and scorer run: a ``.npy`` batch equal to numpy's, an edit
    distance."""
    import tempfile

    import numpy as np

    from robust_e2e_gan_torch.data import dataset
    from robust_e2e_gan_torch.utils import native

    native.build()
    assert native.compiler_version()
    assert native.native_edit_distance(list("kitten"), list("sitting")) == 3
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, n in enumerate((300, 500)):
            paths.append(f"{d}/{i}.npy")
            np.save(paths[-1], np.arange(n, dtype=np.float32))
        got, lens = native.native_load_npy_batch(paths, 400)
        want, _ = dataset.load_npy_batch_plain(paths, 400)
    assert lens.tolist() == [300, 500]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("early_exit", [True, False], ids=["exit", "all"])
@pytest.mark.parametrize("step_impl", ["auto", "fused"])
def test_pipelined_searcher_matches_sequential(dev, step_impl, early_exit):
    """The staged searcher on the card (each encode on a side stream under
    the previous batch's beam loop, host batches copied from pinned
    memory) against the sequential one on the same host batches: three
    batches and a shape change; tokens identical, scores within 1e-5
    relative; the fused step's cooperative launches on the current stream
    beside the encodes on the side one."""
    import dataclasses

    import numpy as np

    from robust_e2e_gan_torch.config import BeamSearchConfig
    from robust_e2e_gan_torch.configs import tiny_config
    from robust_e2e_gan_torch.convert import from_flax, init_params
    from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
    from robust_e2e_gan_torch.decode.beam import (
        make_beam_searcher,
        make_pipelined_beam_searcher,
    )
    from robust_e2e_gan_torch.ops import att_dec
    from robust_e2e_gan_torch.pipeline import build_model

    jcfg = tiny_config(12)
    e2e = jcfg.e2e
    jcfg = dataclasses.replace(
        jcfg, e2e=dataclasses.replace(
            e2e, encoder=dataclasses.replace(e2e.encoder, lstm_impl="auto"),
            decoder=dataclasses.replace(e2e.decoder, step_impl=step_impl)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))
    model = build_model(jcfg)
    model.load_state_dict(from_flax(init_params(jcfg, seed=0)))
    model.to(dev).eval()
    bcfg = BeamSearchConfig(beam_size=4, ctc_weight=0.3, max_steps=12,
                            early_exit=early_exit)
    synth = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(5)
    stream = []
    for pad in (None, None, None, 2):
        b = make_batch(8, synth, rng, pad_to_samples=(
            None if pad is None else pad * stream[0][0].shape[1]))
        stream.append((torch.from_numpy(b["noisy_wav"]),
                       torch.from_numpy(b["wav_lengths"])))
    seq = make_beam_searcher(model, jcfg.e2e, bcfg)
    want = [seq(w.to(dev), n.to(dev)) for w, n in stream]
    launches = att_dec.att_dec_step.launches
    got = list(make_pipelined_beam_searcher(model, jcfg.e2e, bcfg)(
        iter(stream)))
    torch.cuda.synchronize()
    if step_impl == "fused":
        assert att_dec.att_dec_step.launches > launches
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.tokens, w.tokens)
        assert torch.equal(g.beam_tokens, w.beam_tokens)
        torch.testing.assert_close(g.scores, w.scores, rtol=1e-5, atol=0)
