"""The port's CTC loss against the JAX package: the loss and its gradient
with respect to the logits against the JAX scan (the trustworthy gradient
oracle), for every reduction and for the per-utterance loss at its edges
(log-probability input, a blank other than 0, labels too long for their
frames, one frame), the alpha recursion against the Pallas
``ctc_alpha_final`` (interpret mode), and the greedy decode."""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.ops import ctc as jax_ctc  # noqa: E402
from robust_e2e_gan_tpu.ops.ctc_pallas import ctc_alpha_final  # noqa: E402
from robust_e2e_gan_torch.ops import ctc  # noqa: E402

ATOL = 1e-5  # float32 log-sum-exp chains summed in the same order
LOSS_RTOL = 1e-6  # plus one float32 rounding of a summed loss (~100)
B, T, V, S = 5, 13, 7, 4
# ragged inputs and labels; an empty label; a label of one repeated token
LOGIT_LENGTHS = [13, 9, 4, 13, 11]
LABEL_LENGTHS = [4, 2, 0, 3, 4]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((B, T, V))).astype(np.float32)
    labels = rng.integers(1, V, (B, S)).astype(np.int32)
    labels[3] = labels[3, 0]  # repeats: the skip transition is refused
    return logits, labels


@pytest.mark.parametrize("impl", ["auto", "scan"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_and_grad_match_jax_scan(impl, reduction):
    logits, labels = _inputs(0)
    args = (jnp.asarray(LOGIT_LENGTHS), jnp.asarray(labels),
            jnp.asarray(LABEL_LENGTHS))

    def jloss(lg):
        out = jax_ctc.ctc_loss(lg, *args, reduction=reduction, impl="scan")
        return jnp.sum(out * jnp.arange(1, out.size + 1).reshape(out.shape))

    want = jax_ctc.ctc_loss(jnp.asarray(logits), *args, reduction=reduction,
                            impl="scan")
    want_grad = jax.grad(jloss)(jnp.asarray(logits))

    lg = torch.from_numpy(logits).requires_grad_()
    got = ctc.ctc_loss(lg, torch.tensor(LOGIT_LENGTHS), torch.from_numpy(labels),
                       torch.tensor(LABEL_LENGTHS), reduction=reduction,
                       impl=impl)
    weights = torch.arange(1, got.numel() + 1, dtype=torch.float32)
    grad, = torch.autograd.grad((got * weights.reshape(got.shape)).sum(), lg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOSS_RTOL, atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=ATOL)


# name: (logit lengths, label lengths, blank_id, log_input)
EDGE_CASES = {
    "log_input": (LOGIT_LENGTHS, LABEL_LENGTHS, 0, True),
    # blank is the last column, and label 0 is an ordinary token
    "blank_last": (LOGIT_LENGTHS, LABEL_LENGTHS, V - 1, False),
    # row 3 (one token three times) needs 5 frames and has 4; row 1 has
    # fewer than 2 S_b + 1 frames and no repeat, so it fits
    "infeasible": ([13, 5, 4, 4, 11], [4, 4, 0, 3, 4], 0, False),
    # one frame: a one-token label, an empty one, one that cannot fit
    "one_frame": ([1, 1, 13, 1, 9], [1, 0, 2, 2, 4], 0, False),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_ctc_nll_edge_cases_match_jax_scan(case):
    """ctc_nll_plain and ctc_loss(impl="auto", reduction="none") against
    the JAX scan, loss and gradient."""
    logit_lengths, label_lengths, blank, log_input = EDGE_CASES[case]
    logits, labels = _inputs(4)
    if log_input:
        logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    if blank:
        labels = labels - 1  # tokens in [0, V - 1)
        labels[0, :2] = 0
    labels[1] = [1, 2, 3, 4]
    args = (jnp.asarray(logit_lengths), jnp.asarray(labels),
            jnp.asarray(label_lengths))
    weights = np.arange(1, B + 1, dtype=np.float32)

    def jfn(lg):
        return jax_ctc.ctc_loss(lg, *args, blank_id=blank, log_input=log_input,
                                reduction="none", impl="scan")

    want, vjp = jax.vjp(jfn, jnp.asarray(logits))
    want_grad, = vjp(jnp.asarray(weights))
    targs = (torch.tensor(logit_lengths), torch.from_numpy(labels),
             torch.tensor(label_lengths))
    for fn in (lambda lg: ctc.ctc_nll_plain(lg, *targs, blank, log_input),
               lambda lg: ctc.ctc_loss(lg, *targs, blank, log_input,
                                       reduction="none", impl="auto")):
        lg = torch.from_numpy(logits).requires_grad_()
        got = fn(lg)
        grad, = torch.autograd.grad(got, lg, torch.from_numpy(weights))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=ATOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                                   rtol=0, atol=ATOL)
        if case == "infeasible":
            assert got[3].item() == np.float32(1e30) and got[1].item() < 1e29
            assert not grad[3].any()


@pytest.mark.parametrize("bad", ["label", "label_length"])
@pytest.mark.parametrize("impl", ["auto", "scan"])
def test_ctc_loss_refuses_a_bad_label(impl, bad):
    """A label outside [0, V) inside an utterance, or a label length past
    S, raises on the CPU on both impls (the card's kernel asserts)."""
    logits, labels = _inputs(5)
    label_lengths = list(LABEL_LENGTHS)
    if bad == "label":
        labels[1, 1] = V
    else:
        label_lengths[4] = S + 1
    with pytest.raises(RuntimeError, match="out of bounds"):
        ctc.ctc_loss(torch.from_numpy(logits), torch.tensor(LOGIT_LENGTHS),
                     torch.from_numpy(labels), torch.tensor(label_lengths),
                     impl=impl)


def test_ctc_alpha_matches_pallas_kernel():
    logits, labels = _inputs(1)
    rng = np.random.default_rng(2)
    u = 2 * S + 1
    emit = np.log(rng.dirichlet(np.ones(u), (B, T))).astype(np.float32)
    alpha0 = np.full((B, u), ctc.NEG_INF, np.float32)
    alpha0[:, :2] = emit[:, 0, :2]
    skip = np.where(rng.random((B, u)) < 0.7, 0.0, ctc.NEG_INF).astype(
        np.float32)
    pos = np.where(np.arange(u)[None] < 2 * np.asarray(LABEL_LENGTHS)[:, None]
                   + 1, 0.0, ctc.NEG_INF).astype(np.float32)
    alpha0 = np.maximum(alpha0 + pos, ctc.NEG_INF).astype(np.float32)
    lens = np.asarray(LOGIT_LENGTHS, np.int32)
    dfin = rng.standard_normal((B, u)).astype(np.float32)

    def jfn(e, a0):
        return ctc_alpha_final(e, a0, jnp.asarray(skip), jnp.asarray(pos),
                               jnp.asarray(lens), interpret=True)

    want, vjp = jax.vjp(jfn, jnp.asarray(emit), jnp.asarray(alpha0))
    want_de, want_da0 = vjp(jnp.asarray(dfin))

    e = torch.from_numpy(emit).requires_grad_()
    a0 = torch.from_numpy(alpha0).requires_grad_()
    got = ctc.ctc_alpha(e, a0, torch.from_numpy(skip), torch.from_numpy(pos),
                        torch.from_numpy(lens))
    de, da0 = torch.autograd.grad(got, [e, a0], torch.from_numpy(dfin))
    finite = np.asarray(want) > ctc.NEG_THRESH
    np.testing.assert_allclose(got.detach().numpy()[finite],
                               np.asarray(want)[finite], rtol=0, atol=ATOL)
    assert np.all(got.detach().numpy()[~finite] <= ctc.NEG_THRESH)
    np.testing.assert_allclose(de.numpy(), np.asarray(want_de), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(da0.numpy(), np.asarray(want_da0), rtol=0,
                               atol=ATOL)
    with torch.no_grad():  # the history-free forward
        np.testing.assert_array_equal(
            ctc.ctc_alpha(e, a0, torch.from_numpy(skip),
                          torch.from_numpy(pos), torch.from_numpy(lens)),
            got.detach())


def test_ctc_greedy_decode_matches_jax():
    logits, _ = _inputs(3)
    logits[0, 1] = logits[0, 0]  # a repeat
    want = jax_ctc.ctc_greedy_decode(jnp.asarray(logits),
                                     jnp.asarray(LOGIT_LENGTHS))
    got = ctc.ctc_greedy_decode(torch.from_numpy(logits),
                                torch.tensor(LOGIT_LENGTHS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
