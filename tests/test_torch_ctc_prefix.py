"""The port's CTC prefix scoring against the JAX package: the twopass XLA
forms (``batched_prefix_psi``, ``prefix_state_for_token``), the tiled
Pallas kernels and the per-utterance psi kernel (interpret mode)."""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.decode.beam import (  # noqa: E402
    batched_prefix_psi,
    prefix_state_for_token,
)
from robust_e2e_gan_tpu.ops.ctc_prefix_pallas import (  # noqa: E402
    prefix_scores_psi_pallas,
)
from robust_e2e_gan_tpu.ops.ctc_prefix_tiled import (  # noqa: E402
    prefix_psi_tiled,
    prefix_state_tiled,
)
from robust_e2e_gan_torch.ops import ctc_prefix as ops  # noqa: E402

BLANK, EOS = 0, 1
# log-space sums over T frames: values reach tens of nats, so compare at
# 1e-3 absolute (a few float32 ulps of the largest partial sums)
ATOL = 1e-3


def _state(seed, b=2, k=3, t=13, v=7):
    """Masked CTC log-probs and plausible parent states: the forward
    variables of random prefixes, built by running the JAX recursion."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    lpz = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    hl = np.array([t, t - 4][:b])
    lpz[1, hl[1]:] = -1e10
    lpz[1, hl[1]:, BLANK] = 0.0
    r_b = np.broadcast_to(np.cumsum(lpz[:, :, BLANK], 1)[:, None],
                          (b, k, t)).copy()
    r_n = np.full((b, k, t), -1e10, np.float32)
    last = np.full((b, k), EOS, np.int32)
    lens = np.zeros((b, k), np.int32)
    for _ in range(2):  # extend some lanes twice, with repeats
        tok = rng.integers(2, v, (b, k)).astype(np.int32)
        tok[0, 0] = last[0, 0] if lens[0, 0] else tok[0, 0]
        grow = rng.random((b, k)) < 0.7
        rn_s, rb_s = prefix_state_for_token(
            jnp.asarray(lpz), jnp.asarray(tok), jnp.asarray(last),
            jnp.asarray(lens), jnp.asarray(r_n), jnp.asarray(r_b), BLANK)
        r_n = np.where(grow[..., None], np.asarray(rn_s), r_n)
        r_b = np.where(grow[..., None], np.asarray(rb_s), r_b)
        last = np.where(grow, tok, last)
        lens = lens + grow
    tok = rng.integers(2, v, (b, k)).astype(np.int32)
    tok[1, 2] = last[1, 2]  # a repeated token
    return dict(lpz=lpz, last=last, lens=lens.astype(np.int32),
                r_n=r_n.astype(np.float32), r_b=r_b.astype(np.float32), tok=tok)


@pytest.mark.parametrize("seed", [0, 1])
def test_psi_matches_jax_twopass_and_tiled_kernel(seed):
    s = _state(seed)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = batched_prefix_psi(j["lpz"], j["last"], j["lens"], j["r_n"],
                              j["r_b"], BLANK, EOS)
    want_kernel = prefix_psi_tiled(j["lpz"], j["last"], j["lens"], j["r_n"],
                                   j["r_b"], BLANK, EOS, interpret=True)
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    for fn in (ops.prefix_psi_plain, ops.prefix_psi):
        got = fn(t_["lpz"], t_["last"], t_["lens"], t_["r_n"], t_["r_b"],
                 BLANK, EOS).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_state_matches_jax_twopass_and_tiled_kernel(seed):
    s = _state(seed)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = prefix_state_for_token(j["lpz"], j["tok"], j["last"], j["lens"],
                                  j["r_n"], j["r_b"], BLANK)
    want_kernel = prefix_state_tiled(j["lpz"], j["tok"], j["last"], j["lens"],
                                     j["r_n"], j["r_b"], BLANK, interpret=True)
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    for fn in (ops.prefix_state_plain, ops.prefix_state):
        got = fn(t_["lpz"], t_["tok"], t_["last"], t_["lens"], t_["r_n"],
                 t_["r_b"], BLANK)
        for g, w, wk in zip(got, want, want_kernel):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=0,
                                       atol=ATOL)


def test_wrappers_take_plain_versions_on_cpu():
    s = {n: torch.from_numpy(np.ascontiguousarray(a))
         for n, a in _state(2).items()}
    before = (ops.prefix_psi.launches, ops.prefix_state.launches,
              ops.prefix_psi_recursion_plain.calls,
              ops.prefix_state_plain.calls)
    ops.prefix_psi(s["lpz"], s["last"], s["lens"], s["r_n"], s["r_b"],
                   BLANK, EOS)
    ops.prefix_state(s["lpz"], s["tok"], s["last"], s["lens"], s["r_n"],
                     s["r_b"], BLANK)
    after = (ops.prefix_psi.launches, ops.prefix_state.launches,
             ops.prefix_psi_recursion_plain.calls,
             ops.prefix_state_plain.calls)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_psi_utt_matches_jax_per_utterance_kernel(seed):
    """``prefix_psi_utt`` (on the CPU, its plain version
    ``prefix_psi_plain``) against ``prefix_scores_psi_pallas``, eos and
    blank columns included."""
    s = _state(seed, b=3, k=4, t=17, v=9)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = prefix_scores_psi_pallas(j["lpz"], j["last"], j["lens"], j["r_n"],
                                    j["r_b"], BLANK, EOS, interpret=True)
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    before = (ops.prefix_psi_utt.launches,
              ops.prefix_psi_recursion_plain.calls)
    got = ops.prefix_psi_utt(t_["lpz"], t_["last"], t_["lens"], t_["r_n"],
                             t_["r_b"], BLANK, EOS).numpy()
    assert (ops.prefix_psi_utt.launches,
            ops.prefix_psi_recursion_plain.calls) == (before[0],
                                                      before[1] + 1)
    # the same float32 log-space sums, in the same frame order
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert (got[..., BLANK] == -1e10).all()
