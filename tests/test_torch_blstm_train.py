"""The port's training BLSTM (plain versions of ``blstm_train`` and
``blstm_train_gx``) against the JAX package: its Pallas kernels in
interpret mode and the XLA scan layer, forward and every gradient; and the
per-layer kernel choice against the JAX predicates."""

import itertools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.models.rnn import BLSTM as JaxBLSTM  # noqa: E402
from robust_e2e_gan_tpu.ops import blstm_train_pallas as jax_train  # noqa: E402
from robust_e2e_gan_torch.convert import blstm_params, from_flax  # noqa: E402
from robust_e2e_gan_torch.models.rnn import BLSTM, input_projection  # noqa: E402
from robust_e2e_gan_torch.ops import blstm_train as ops  # noqa: E402

# float32: the same recurrence and adjoint summed in another order
RTOL, ATOL = 1e-4, 1e-5
# B = 5 is no multiple of 8, H = 8 no multiple of 128; a ragged batch
B, T, D, H = 5, 9, 10, 8
LENGTHS = [9, 4, 1, 7, 2]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = {k: v.astype(np.float32)
              for k, v in blstm_params(rng, D, H).items()}
    params["bias"] += rng.uniform(-0.5, 0.5, (2, 4 * H)).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    return params, x, dy


def _jax_vjp(fn, x, params, dy):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(params["wx"]),
                     jnp.asarray(params["wh"]), jnp.asarray(params["bias"]))
    return [np.asarray(a) for a in (y, *vjp(jnp.asarray(dy)))]


def _torch_grads(fn, x, params, dy):
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, params["wx"], params["wh"], params["bias"])]
    y = fn(*leaves)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    return [y.detach().numpy()] + [g.numpy() for g in grads]


NAMES = ["y", "dx", "dwx", "dwh", "dbias"]


def _check(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("variant", ["fused", "gx"])
def test_train_blstm_matches_jax_kernel_and_scan(variant):
    params, x, dy = _inputs(0)
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    mask = (np.arange(T)[None] < np.asarray(LENGTHS)[:, None]).astype(
        np.float32)
    kernel = (jax_train.blstm_train if variant == "fused"
              else jax_train.blstm_train_gx)
    want_kernel = _jax_vjp(
        lambda x_, wx, wh, b: kernel(x_, lengths, wx, wh, b, interpret=True),
        x, params, dy)
    layer = JaxBLSTM(H, impl="scan")
    want_scan = _jax_vjp(
        lambda x_, wx, wh, b: layer.apply(
            {"params": {"wx": wx, "wh": wh, "bias": b}}, x_,
            jnp.asarray(mask)),
        x, params, dy)

    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    if variant == "fused":
        def port(x_, wx, wh, b):
            return ops.blstm_train(x_, lens, wx, wh, b)
        calls = ops.blstm_train_plain
    else:
        def port(x_, wx, wh, b):
            gx = input_projection(x_, wx, b, torch.float32)
            return ops.blstm_train_gx(gx, wh, lens)
        calls = ops.blstm_train_gx_plain
    n = calls.calls
    got = _torch_grads(port, x, params, dy)
    assert calls.calls == n + 1  # CPU tensors take the plain version
    _check(got, want_kernel)
    _check(got, want_scan)
    for bi, n in enumerate(LENGTHS):  # pad frames: zero output and dx
        assert not np.any(got[0][bi, n:]) and not np.any(got[1][bi, n:])


def test_blstm_layer_routes_by_autograd():
    """Under autograd a kernel-impl layer takes the training path; without
    it the inference wrapper; both agree with the scan layer."""
    params, x, _ = _inputs(1)
    mask = torch.from_numpy(
        (np.arange(T)[None] < np.asarray(LENGTHS)[:, None]).astype(np.float32))
    layer = BLSTM(D, H, torch.float32, "auto")
    layer.load_state_dict(from_flax(params))
    n = ops.blstm_train_plain.calls
    y = layer(torch.from_numpy(x), mask)
    assert y.requires_grad and ops.blstm_train_plain.calls == n + 1
    with torch.no_grad():
        y_infer = layer(torch.from_numpy(x), mask)
    assert ops.blstm_train_plain.calls == n + 1
    np.testing.assert_allclose(y.detach().numpy(), y_infer.numpy(),
                               rtol=RTOL, atol=ATOL)


GRID = list(itertools.product((1, 5, 16, 32, 64), (10, 257, 512, 2560, 5120),
                              (32, 256, 512, 1024), (2, 4)))


def test_kernel_choice_is_the_jax_rule():
    for b, d, h, itemsize in GRID:
        fused = jax_train.fused_train_fits(b, 72, d, h, itemsize)
        assert ops.fused_train_fits(b, 72, d, h, itemsize) == fused
        assert ops.gx_train_fits(b, h, itemsize) == jax_train.gx_train_fits(
            b, h, itemsize)
        dtype = torch.bfloat16 if itemsize == 2 else torch.float32
        assert ops.train_kernel_for(b, 72, d, h, dtype) == (
            "fused" if fused else "gx")
    # the train CLI's default encoder layer 0 takes the gx kernel, the
    # flagship's layers the fused one
    assert ops.train_kernel_for(16, 72, 2560, 512, torch.float32) == "gx"
    assert ops.train_kernel_for(32, 72, 2560, 256, torch.bfloat16) == "fused"


H100_SXM = dict(n_sm=132, smem_per_block=232_448)
H100_PCIE = dict(n_sm=114, smem_per_block=232_448)


@pytest.mark.parametrize("b, h, itemsize, card, want", [
    # the flagship's train layers (B=32, H=256, bf16; the plan does not
    # depend on T, 286 enhancer or 72 encoder frames)
    (32, 256, 2, H100_SXM, (4, 64, 52_356)),
    # the train CLI's layers, encoder layer 0 among them (B=16, H=512, f32)
    (16, 512, 4, H100_SXM, (8, 64, 142_404)),
    # an H100 PCIe's 114 SMs
    (32, 256, 2, H100_PCIE, (5, 52, 57_220)),
    (16, 512, 4, H100_PCIE, (9, 57, 152_004)),
    # an odd batch, and bf16 H = 1,024
    (33, 512, 4, H100_SXM, (8, 64, 224_072)),
    (16, 1024, 2, H100_SXM, (16, 64, 219_204)),
    # past the plan: 2 x 16 MiB of f32 W_h at H = 1,024 exceed the card's
    # shared memory; a batch whose h stages (2 x B x H) cannot fit
    (16, 1024, 4, H100_SXM, None),
    (128, 512, 4, H100_SXM, None),
    (64, 1024, 2, H100_SXM, None),
], ids=["flagship", "cli", "pcie_flagship", "pcie_cli", "odd_batch",
        "bf16_h1024", "f32_h1024", "big_batch", "bf16_big_batch"])
def test_resident_plan(b, h, itemsize, card, want):
    plan = ops.resident_plan(b, h, itemsize, **card)
    assert plan == want
    if plan is not None:
        n_u, p, smem = plan
        assert 2 * p <= card["n_sm"] and p * n_u >= h > (p - 1) * n_u
        assert smem == ops.resident_smem(b, h, n_u, itemsize)
        assert smem <= card["smem_per_block"]


def test_every_flagship_and_cli_train_layer_is_resident():
    """The layers the train step and the train CLI run fit the plan on an
    H100 SXM, at the batch each trains with."""
    from robust_e2e_gan_torch.configs import flagship_config

    cfg = flagship_config(52)
    for b, h, itemsize in ((32, cfg.enhancer.hidden_dim, 2),
                           (32, cfg.e2e.encoder.hidden_dim, 2),
                           (16, 512, 4)):  # train.cli's defaults, f32
        assert ops.resident_plan(b, h, itemsize, **H100_SXM) is not None


# --------------------------------------------------------------------------
# the products (csrc/gemm.cu): the launch plan, the strided plain version
# and the kernel's numerics
# --------------------------------------------------------------------------


def _gemm_source_constants():
    """BM, BN, BK, and the stages, stage bytes and blocks an SM by compute
    itemsize as csrc/gemm.cu defines them."""
    import os
    import re

    path = os.path.join(os.path.dirname(ops.__file__), os.pardir, "csrc",
                        "gemm.cu")
    with open(path) as f:
        src = f.read()
    tile = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);", src)
    ldk = int(re.search(r"constexpr int LDK = BK \+ (\d+);", src).group(1))
    ldk32 = int(re.search(r"constexpr int LDK32 = BK \+ (\d+);", src).group(1))
    stages = [int(s) for s in re.findall(r"STAGES = (\d+);", src)]
    # blocks an SM: the launch bounds' minimum, by compute type
    blocks = re.search(r"__launch_bounds__\(NT, TF32 \? (\d) : (\d)\)", src)
    bm, bn, bk = (int(g) for g in tile.groups())
    return ((bm, bn, bk), {2: stages[0], 4: stages[1]},
            {2: bm * (bk + ldk) * 2, 4: 2 * bm * (bk + ldk32) * 4},
            {2: int(blocks.group(2)), 4: int(blocks.group(1))})


def _layer_products(b, t, d, h):
    """(batch, M, N, K) of a training layer's products: the projection
    (both directions), dx (both directions' gates as K = 8H), dW_x and
    dW_h (both directions)."""
    return {"proj": (2, b * t, 4 * h, d), "dx": (1, b * t, d, 8 * h),
            "dwx": (2, d, 4 * h, b * t), "dwh": (2, h, 4 * h, b * t)}


# the flagship's four train layers (B=32, H=256, bf16: enhancer layers 0
# and 1 at T=286, encoder layers 0 and 1 at T=72) and the train CLI's (B=16,
# H=512, f32, at phase 3's T=72; its encoder layer 0 takes blstm_train_gx,
# whose only product is dW_h), each product's k slices on an H100 SXM
PLAN_LAYERS = {
    "enh0": ((32, 286, 257, 256, 2), dict(proj=1, dx=1, dwx=5, dwh=8)),
    "enh1": ((32, 286, 512, 256, 2), dict(proj=1, dx=1, dwx=4, dwh=8)),
    "enc0": ((32, 72, 2560, 256, 2), dict(proj=1, dx=1, dwx=1, dwh=8)),
    "enc1": ((32, 72, 256, 256, 2), dict(proj=1, dx=7, dwx=8, dwh=8)),
    "cli_enh0": ((16, 72, 257, 512, 4), dict(proj=1, dx=4, dwx=1, dwh=1)),
    "cli_enh1": ((16, 72, 1024, 512, 4), dict(proj=1, dx=1, dwx=1, dwh=1)),
    "cli_enc0": ((16, 72, 2560, 512, 4), dict(dwh=1)),
    "cli_enc1": ((16, 72, 512, 512, 4), dict(proj=1, dx=3, dwx=1, dwh=1)),
}
PLAN_CASES = [(layer, prod, card) for layer, (_, want) in PLAN_LAYERS.items()
              for prod in want for card in ("sxm", "pcie")]


@pytest.mark.parametrize("layer, prod, card", PLAN_CASES,
                         ids=[f"{l}-{p}-{c}" for l, p, c in PLAN_CASES])
def test_gemm_plan(layer, prod, card):
    """The plan of every product of the flagship's and the train CLI's
    layers: 128 x 128 tiles, k chunks of 32 (the kernel's constants read
    from its source), K split only where the tiles fill at most half of
    the blocks the card runs at once (two an SM in bfloat16, one in tf32),
    then into whole chunks with no slice empty, as many slices as keep one
    wave where K allows (in bfloat16 a block for every SM and more), the
    workspace the partial tiles need, the ring within the card's shared
    memory."""
    (b, t, d, h, isz), want = PLAN_LAYERS[layer]
    batch, m, n, k = _layer_products(b, t, d, h)[prod]
    limits = H100_SXM if card == "sxm" else H100_PCIE
    plan = ops.gemm_plan(m, n, k, isz, **limits, batch=batch)
    tile, stages, stage_bytes, blocks = _gemm_source_constants()
    assert tile == ops.GEMM_TILE == plan.tile == (128, 128, 32)
    assert stages == ops.GEMM_STAGES and stage_bytes == ops.GEMM_TILE_BYTES
    assert blocks == ops.GEMM_BLOCKS_PER_SM
    assert plan.smem == stages[isz] * 2 * stage_bytes[isz] <= \
        limits["smem_per_block"]
    tiles = batch * -(-m // 128) * -(-n // 128)
    chunks = -(-k // 32)
    s, per = plan.splits, plan.slice_chunks
    if card == "sxm":
        assert s == want[prod]
    assert (s - 1) * per < chunks <= s * per  # whole chunks, none empty
    slots = limits["n_sm"] * ops.GEMM_BLOCKS_PER_SM[isz]
    if tiles > slots // 2:
        assert s == 1
    else:
        assert tiles * s <= slots  # one wave
        if s > 1:
            assert per >= ops.GEMM_MIN_SLICE
        if chunks >= ops.GEMM_MIN_SLICE * (slots // tiles):  # K allows
            assert tiles * (s + 1) > slots
            if isz == 2:
                assert tiles * s >= limits["n_sm"]
    assert plan.workspace == (tiles * s * 128 * 128 * 4 if s > 1 else 0)


def test_gemm_plan_refusals():
    """None for a compute itemsize other than 2 or 4, and where the ring
    does not fit the card's shared memory (the float32 ring takes
    147,456 bytes)."""
    assert ops.gemm_plan(256, 1024, 9152, 8, **H100_SXM) is None
    assert ops.gemm_plan(256, 1024, 9152, 4, n_sm=132,
                         smem_per_block=100_000) is None
    assert ops.gemm_plan(256, 1024, 9152, 2, n_sm=132,
                         smem_per_block=100_000).smem == 81_920


@pytest.mark.parametrize("itemsize, kcol, want", [
    # bfloat16 rows of 2,560 elements: 16-byte pieces; of 257 (D = 257):
    # one element; of 514 bytes at a 4-byte-aligned start: 4-byte pieces
    (2, True, 2), (2, True, 4), (2, True, 3),
    (4, False, 0), (4, False, 1)], ids=["bf16_16B", "bf16_d257",
                                        "bf16_4B", "f32_16B", "f32_odd_n"])
def test_gemm_copy_mode(itemsize, kcol, want):
    """The copy width of an operand from its base pointer, strides and
    extents: the widest piece that starts on a multiple of its size and
    crosses no edge."""
    if kcol:  # (rows, k) k-contiguous: x (B T, D) as the projection's A
        d = {2: 2560, 4: 257, 3: 258}[want]
        got = ops.copy_mode(1024, itemsize, 9152, d, d, 0, d, 0, 1)
    else:  # n-contiguous: dgates (B T, 2, 4H) as dW_h's B, or N = 1,023
        n = 1024 if want == 0 else 1023
        got = ops.copy_mode(1024, itemsize, n, 9152, 286, n, 1, 286 * 2 * n,
                            2 * n)
    assert got == (kcol, want)
    # a base pointer two bytes off a 16-byte boundary takes no piece
    assert ops.copy_mode(1026, 2, 9152, 2560, 2560, 0, 2560, 0, 1) == (True, 4)


GEMM_SHAPES = dict(b=5, t=9, d=257, h=8)  # M = 257 (dW_x), K = 45 (B T)


def _gemm_layer(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    b, t, d, h = (GEMM_SHAPES[x] for x in "btdh")

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return (rnd(b, t, d).to(dtype), rnd(2, d, 4 * h).to(dtype),
            rnd(2, 4 * h), rnd(b, t, 2, 4 * h), rnd(2, b, t + 1, h).to(dtype))


@pytest.mark.parametrize("layout", ["proj", "dx", "dwx", "dwh", "ragged_ki"])
def test_gemm_plain_layouts(layout):
    """Each stride layout of the products, through the wrappers that launch
    them (CPU tensors take ``gemm_plain``), against einsum on ragged shapes:
    the projection with its bias (both directions as batch 2), dx over both
    directions' gates (K = 8H split by KI = 4H), dW_x through x^T (M = 257,
    batch 2), dW_h over the padded residual (k = (row, frame) by KI = T,
    batch 2); and a two-level k with a partial last segment, accumulated
    into C."""
    xc, wx, bias, dg, y_ext = _gemm_layer(3)
    b, t, d, h = (GEMM_SHAPES[x] for x in "btdh")
    n = ops.gemm_plain.calls
    if layout == "proj":
        got = ops._projection_kernel(xc, wx, bias)
        want = torch.einsum("btd,zdg->btzg", xc, wx) + bias
    elif layout == "dx":
        got = ops._dx_kernel(dg, wx, False)
        want = torch.einsum("btzg,zdg->btd", dg, wx)
    elif layout == "dwx":
        got = ops._dwx_kernel(xc, dg, False)
        want = torch.einsum("btd,btzg->zdg", xc, dg)
    elif layout == "dwh":
        got = ops._dwh_kernel(y_ext, dg, b, t, h)
        want = ops._dwh_plain(y_ext, dg, t)
    else:
        # A (3, 13) read as k = (k // 5, k % 5), k1 stride 7: 13 = 2 x 5 + 3
        a = torch.arange(60, dtype=torch.float32).reshape(3, 20) / 7
        bm = torch.linspace(-1, 1, 13 * 4).reshape(13, 4)
        idx = torch.tensor([q * 7 + r for q in range(3)
                            for r in range(5)][:13])
        got = torch.ones(3, 4)
        ops.gemm(a, bm, got, batch=1, m=3, n=4, k=13, ki=5,
                 a_strides=(0, 20, 7, 1), b_strides=(0, 20, 4, 1),
                 c_strides=(0, 4, 1), accumulate=True)
        want = 1 + a[:, idx] @ bm
    assert ops.gemm_plain.calls == n + 1  # one product, CPU: the plain one
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits; to nearest, ties away from
    zero) by masking its float32 bits, as common.cuh::tf32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int):
    """a @ b with each operand split into hi = tf32(x) and lo = tf32(x -
    hi), lo hi + hi lo + hi hi summed in float32 (``passes=1``: hi hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_gemm(passes, slices):
    """``gemm`` with csrc/gemm.cu's numerics, emulated: operands rounded to
    bfloat16 on load in the bfloat16 type, else split into tf32 hi and lo
    by bit masking (3xTF32; ``passes=1``: single-pass TF32); k in chunks
    of 32 over the plan's slices ("plan", on an H100 SXM) or one chunk a
    slice ("chunk"), each slice's partial product in float32, the partials
    summed in slice order; then the bias and the write into C."""

    def run(a, b, c, bias=None, *, batch, m, n, k, a_strides, b_strides,
            c_strides, ki=None, bias_stride=0, round_bf16=False,
            accumulate=False):
        ki = k if ki is None else ki
        sb, sk1, sk0, sn = b_strides
        av = ops._operand_view(a, batch, m, k, ki, *a_strides).float()
        bv = ops._operand_view(b, batch, n, k, ki, sb, sn, sk1,
                               sk0).float().transpose(1, 2)
        bf16 = round_bf16 or a.dtype == b.dtype == torch.bfloat16
        plan = ops.gemm_plan(m, n, k, 2 if bf16 else 4, **H100_SXM,
                             batch=batch)
        per = 32 * (plan.slice_chunks if slices == "plan" else 1)
        out = None
        for lo in range(0, k, per):
            pa, pb = av[..., lo:lo + per], bv[..., lo:lo + per, :]
            if bf16:
                part = pa.bfloat16().float() @ pb.bfloat16().float()
            else:
                part = torch.stack([_mm_3xtf32(x, y, passes)
                                    for x, y in zip(pa, pb)])
            out = part if out is None else out + part
        if bias is not None:
            out = out + torch.as_strided(bias, (batch, 1, n),
                                         (bias_stride, 0, 1))
        cv = torch.as_strided(c, (batch, m, n), c_strides)
        cv.copy_(cv + out if accumulate else out)

    return run


def _emulated_layer(params, x, dy, variant, passes, slices):
    """The port's layer with its products on the emulated kernel: the
    projection, the plain frame loops, dx, dW_x and dW_h (blstm_train);
    or the plain projection and frame loops, then dW_h (blstm_train_gx)."""
    product = _emulated_gemm(passes, slices)
    xc, wx, wh, bias = (torch.from_numpy(v) for v in
                        (x, params["wx"], params["wh"], params["bias"]))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    dyt = torch.from_numpy(dy)
    if variant == "fused":
        gx = ops._projection_kernel(xc, wx, bias, product)
    else:
        gx = torch.einsum("btd,zdg->btzg", xc, wx) + bias
    y, y_ext, c_ext = ops.recurrence_fwd_plain(gx, wh, lengths)
    dg = ops.recurrence_bwd_plain(gx, wh, lengths, y_ext, c_ext, dyt)
    dwh = ops._dwh_kernel(y_ext, dg, B, T, H, product)
    if variant == "gx":
        return {"y": y, "dwh": dwh}
    return {"y": y, "dx": ops._dx_kernel(dg, wx, False, product),
            "dwx": ops._dwx_kernel(xc, dg, False, product), "dwh": dwh}


@pytest.mark.parametrize("slices", ["plan", "chunk"])
@pytest.mark.parametrize("variant", ["fused", "gx"])
def test_gemm_3xtf32_matches_the_jax_kernels(variant, slices):
    """csrc/gemm.cu's float32 numerics (3xTF32, the partials of its k
    slices summed in slice order), emulated, through the layer's products
    against the JAX ``blstm_train`` and ``blstm_train_gx`` in interpret
    mode: within the file's float32 tolerance, where single-pass TF32 is
    not."""
    params, x, dy = _inputs(4)
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    kernel = (jax_train.blstm_train if variant == "fused"
              else jax_train.blstm_train_gx)
    want = dict(zip(NAMES, _jax_vjp(
        lambda x_, wx, wh, b: kernel(x_, lengths, wx, wh, b, interpret=True),
        x, params, dy)))
    got = _emulated_layer(params, x, dy, variant, 3, slices)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    one = _emulated_layer(params, x, dy, variant, 1, slices)
    assert not all(np.allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL)
                   for name, g in one.items())


def test_gemm_bf16_numerics_match_plain():
    """In bfloat16 the kernel's products are exact (bfloat16 operands,
    float32 sums): the emulated split-K partials summed in slice order
    agree with ``gemm_plain`` to float32 summation order."""
    xc, wx, bias, dg, y_ext = _gemm_layer(5, torch.bfloat16)
    b, t, _, h = (GEMM_SHAPES[x] for x in "btdh")
    for product in (None, _emulated_gemm(3, "chunk")):
        got = [ops._projection_kernel(xc, wx, bias, product),
               ops._dx_kernel(dg, wx, True, product),
               ops._dwx_kernel(xc, dg, True, product),
               ops._dwh_kernel(y_ext, dg, b, t, h, product)]
        if product is None:
            plain = got
    for g, w in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
