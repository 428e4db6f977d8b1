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
    want = blstm.blstm_recurrence_plain(gx, wh, lengths)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, want))
    assert not got[2].any() and not got[1, 1:].any()  # pad frames


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
