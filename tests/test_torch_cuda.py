"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
one (and nvcc), run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [32, 256, 1024])
def test_blstm_kernel_matches_plain(dev, dtype, h):
    gen = torch.Generator(device=dev).manual_seed(h)
    b, t = 5, 23
    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    lengths = torch.tensor([t, 1, 0, 17, t - 1], dtype=torch.int32, device=dev)
    got = blstm.blstm_recurrence(gx, wh, lengths)
    want = blstm.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, want))
    assert not got[2].any() and not got[1, 1:].any()  # pad frames


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


@pytest.mark.parametrize("b", [1, 17, 128])
@pytest.mark.parametrize("d", [10, 257, 2560])
@pytest.mark.parametrize("h", [64, 256])
def test_blstm_infer_cluster_matches_plain(dev, h, d, b):
    """The cluster route (``csrc/blstm_infer_cluster.cu``; H=64 takes
    clusters of 2 blocks, H=256 of 8; W_x resident at D=10 and 257,
    streamed at 2,560) against the plain version in bf16: ragged lengths,
    a zero-length row, pad frames exact zeros."""
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


def test_blstm_infer_cluster_is_deterministic_and_agrees(dev):
    """Two runs of the cluster route are bit-identical, and the cluster
    and row-tiled routes agree within the bf16 tolerance."""
    gen = torch.Generator(device=dev).manual_seed(11)
    b, t, d, h = 128, 50, 257, 256
    x, wx, wh, bias = _infer_inputs(gen, dev, b, t, d, h, torch.bfloat16)
    lengths = _ragged(gen, dev, b, t)
    runs = [_on_route("cluster", x, lengths, wx, wh, bias) for _ in range(2)]
    tiled = _on_route("row_tiled", x, lengths, wx, wh, bias)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].float(), tiled.float(),
                               **_tol(torch.bfloat16, tiled))


def test_blstm_infer_cluster_refusals(dev):
    """The plan sends f32 and bf16 H = 512 to the row-tiled route, and
    forcing the cluster route there raises before any launch; a launch the
    card refuses (W_x resident in more shared memory than a block has)
    raises, never runs, and leaves no error for the next launch."""
    from robust_e2e_gan_torch.utils.build import launch

    gen = torch.Generator(device=dev).manual_seed(5)
    lengths = torch.tensor([7, 3], dtype=torch.int32, device=dev)
    for dtype, h in ((torch.float32, 256), (torch.bfloat16, 512)):
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_att_kernel_matches_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, k, t, c, a, e = 3, 4, 37, 10, 64, 48

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    mask = (torch.arange(t, device=dev)[None]
            < torch.tensor([[t], [5], [0]], device=dev)).to(dtype)
    args = (rnd(b, k, t, c, scale=0.1), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a), rnd(a, scale=0.3), mask)
    got = att.att_loc_step(*args, 2.0)
    want = att.att_loc_step_plain(*args, 2.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(dtype, w))
    assert not got[1][1, :, 5:].any()
    with pytest.raises(ValueError):  # more conv channels than a warp keeps
        att.att_loc_step(rnd(b, k, t, 40), *args[1:4], rnd(40, a), *args[5:],
                         2.0)


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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("layers,n,h,e,v", [(1, 9, 24, 16, 200),
                                             (2, 1024, 256, 128, 52),
                                             (1, 33, 512, 512, 12)])
def test_lm_step_kernel_matches_plain(dev, dtype, layers, n, h, e, v):
    from robust_e2e_gan_torch.ops import lm_step as ls

    gen = torch.Generator(device=dev).manual_seed(h)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    tok = torch.randint(0, v, (n,), generator=gen, device=dev)
    args = (tok, rnd(v, e),
            [rnd(e if i == 0 else h, 4 * h, scale=e ** -0.5)
             for i in range(layers)],
            [rnd(h, 4 * h, scale=h ** -0.5) for _ in range(layers)],
            [rnd(4 * h, scale=0.3) for _ in range(layers)],
            rnd(h, v, scale=h ** -0.5), rnd(v, scale=0.3),
            rnd(layers, n, h, scale=0.5), rnd(layers, n, h, scale=0.5))
    launches = ls.lm_step.launches
    got = ls.lm_step(*args, dtype=dtype)
    want = ls.lm_step_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert ls.lm_step.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **_tol(dtype, w))


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


def test_ctc_prefix_utt_kernel_matches_plain(dev):
    """The per-utterance psi kernel, eos and blank columns included, over
    three steps of parents; K*V past a block's threads raises."""
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
    wide = torch.zeros((b, 40), dtype=torch.int32, device=dev)
    rows = torch.zeros((b, 40, t), device=dev)
    with pytest.raises(ValueError, match="threads"):
        ctc_prefix.prefix_psi_utt(torch.zeros((b, t, 30), device=dev), wide,
                                  wide, rows, rows, 0, 1)


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
