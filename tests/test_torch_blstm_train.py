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
