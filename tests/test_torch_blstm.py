"""The port's BLSTM against the JAX package: the XLA scan layer and the
Pallas ``blstm_infer`` kernel (interpret mode), ragged lengths, bf16."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.models.rnn import BLSTM as JaxBLSTM  # noqa: E402
from robust_e2e_gan_tpu.models.rnn import BLSTMP as JaxBLSTMP  # noqa: E402
from robust_e2e_gan_tpu.ops.blstm_pallas import blstm_infer  # noqa: E402
from robust_e2e_gan_torch.convert import (  # noqa: E402
    blstm_params,
    dense_params,
    from_flax,
)
from robust_e2e_gan_torch.models.rnn import (  # noqa: E402
    BLSTM,
    BLSTMP,
    input_projection,
)
from robust_e2e_gan_torch.ops import blstm as ops  # noqa: E402

# float32 layers: the same recurrence in another summation order; errors
# stay a few ulps of the O(1) hidden states
RTOL, ATOL = 1e-4, 1e-5
LENS = {"full": [11, 11, 11], "ragged": [11, 6, 1]}


def _inputs(seed, b=3, t=11, d=10, h=8):
    rng = np.random.default_rng(seed)
    params = {k: v.astype(np.float32)
              for k, v in blstm_params(rng, d, h).items()}
    params["bias"] += rng.uniform(-0.5, 0.5, (2, 4 * h)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return params, x


def _mask(lens, t):
    return (np.arange(t)[None] < np.asarray(lens)[:, None]).astype(np.float32)


@pytest.mark.parametrize("lens", list(LENS), ids=list(LENS))
def test_blstm_layer_matches_jax_scan_and_kernel(lens):
    params, x = _inputs(0)
    mask = _mask(LENS[lens], x.shape[1])
    want = JaxBLSTM(8, impl="scan").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask))
    want_kernel = blstm_infer(
        jnp.asarray(x), jnp.asarray(LENS[lens], jnp.int32),
        jnp.asarray(params["wx"]), jnp.asarray(params["wh"]),
        jnp.asarray(params["bias"]), interpret=True)

    for impl in ("scan", "auto"):  # plain version, and the CPU wrapper
        layer = BLSTM(10, 8, torch.float32, impl)
        layer.load_state_dict(from_flax(params))
        got = layer(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=RTOL,
                                   atol=ATOL)
        # pad frames are exact zeros in both directions
        for bi, n in enumerate(LENS[lens]):
            assert not np.any(got[bi, n:])


def test_blstm_bf16_compute_matches_jax():
    """bf16 compute: bf16 operands of the input projection with a float32
    result, float32 recurrence, bf16 outputs."""
    params, x = _inputs(1)
    mask = _mask(LENS["ragged"], x.shape[1])
    want = JaxBLSTM(8, dtype=jnp.bfloat16, impl="scan").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask))
    layer = BLSTM(10, 8, torch.bfloat16, "scan")
    layer.load_state_dict(from_flax(params))
    got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the O(1) outputs: 2^-8 relative, plus f32
    # summation-order differences that can flip that rounding
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=8e-3)


def test_blstmp_stack_matches_jax():
    rng = np.random.default_rng(2)
    params = {"blstm0": blstm_params(rng, 10, 8),
              "proj0": dense_params(rng, 16, 6),
              "blstm1": blstm_params(rng, 6, 8),
              "proj1": dense_params(rng, 16, 6)}
    params = {k: {n: a.astype(np.float32) for n, a in v.items()}
              for k, v in params.items()}
    x = rng.standard_normal((3, 9, 10)).astype(np.float32)
    mask = _mask([9, 4, 7], 9)
    want = JaxBLSTMP(2, 8, 6).apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(mask))
    stack = BLSTMP(10, 2, 8, 6, torch.float32)
    stack.load_state_dict(from_flax(params))
    got = stack(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_recurrence_wrapper_takes_plain_version_on_cpu():
    params, x = _inputs(3)
    xt = torch.from_numpy(x)
    gx = input_projection(xt, torch.from_numpy(params["wx"]),
                          torch.from_numpy(params["bias"]), torch.float32)
    assert gx.shape == (3, 11, 2, 32)
    lengths = torch.tensor([11, 3, 0], dtype=torch.int32)
    wh = torch.from_numpy(params["wh"])
    launches = ops.blstm_recurrence.launches
    calls = ops.blstm_recurrence_plain.calls
    got = ops.blstm_recurrence(gx, wh, lengths)
    assert ops.blstm_recurrence.launches == launches
    assert ops.blstm_recurrence_plain.calls == calls + 1
    torch.testing.assert_close(got, ops.blstm_recurrence_plain(gx, wh, lengths),
                               rtol=0, atol=0)
    assert not got[2].any()  # an empty row is all padding


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: parameters are trainable, and
    the inference-only kernel wrappers refuse inputs autograd records."""
    with torch.no_grad():
        yield
