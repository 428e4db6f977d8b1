"""The port's RNNLM (``models/lm.py``, ``ops/lm_step.py``, ``train/lm.py``)
against the JAX package's on the CPU, float32: the beam-search step through
the plain cells and through the kernel's plain version against both JAX
step impls (the fused one in interpret mode), the teacher-forced pass and
its loss, and one Adam train step."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models import lm as jax_lm  # noqa: E402
from robust_e2e_gan_tpu.models.e2e import (  # noqa: E402
    add_sos_eos as jax_add_sos_eos,
)
from robust_e2e_gan_tpu.train import lm as jax_train_lm  # noqa: E402
from robust_e2e_gan_torch.config import LMConfig, TrainConfig  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, to_flax  # noqa: E402
from robust_e2e_gan_torch.models.e2e import add_sos_eos  # noqa: E402
from robust_e2e_gan_torch.models.lm import RNNLM, lm_loss  # noqa: E402
from robust_e2e_gan_torch.ops import lm_step as lm_ops  # noqa: E402
from robust_e2e_gan_torch.train.lm import (  # noqa: E402
    LMState,
    make_lm_train_step,
)
from robust_e2e_gan_torch.train.steps import create_optimizer  # noqa: E402
from test_torch_train_step import PARAM_ATOL, _close_trees  # noqa: E402

VOCAB = 200
SHAPES = {"1layer": (1, 12, 24, 16), "2layer": (2, 9, 128, 128)}  # L, N, H, E


def _jax_lm(cfg):
    return jax_lm.RNNLM(jax_lm.LMConfig(**dataclasses.asdict(cfg)))


def _models(cfg, seed=0):
    """A JAX RNNLM with its init parameters and the port's RNNLM holding
    the same parameters."""
    jlm = _jax_lm(cfg)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    lm = RNNLM(cfg)
    lm.load_state_dict(from_flax(params["params"]))
    return jlm, params, lm


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lm_step_matches_jax(shape, impl):
    """The port's "xla" step (plain cells) and "fused" step (the kernel
    wrapper: its plain version on CPU tensors) against the JAX step of the
    same impl."""
    layers, n, hid, emb = SHAPES[shape]
    cfg = LMConfig(vocab_size=VOCAB, embed_dim=emb, hidden_dim=hid,
                   num_layers=layers, step_impl=impl)
    jlm, params, lm = _models(cfg)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, VOCAB, size=(n,)).astype(np.int32)
    h0, c0 = (0.3 * rng.standard_normal((layers, n, hid))
              .astype(np.float32) for _ in range(2))
    (h_w, c_w), lg_w = jlm.apply(params, (jnp.asarray(h0), jnp.asarray(c0)),
                                 jnp.asarray(tok), method=jax_lm.RNNLM.step)
    calls = lm_ops.lm_step_plain.calls
    with torch.no_grad():
        (h, c), lg = lm.step((torch.from_numpy(h0), torch.from_numpy(c0)),
                             torch.from_numpy(tok))
    # the fused impl goes through the kernel wrapper, the xla one does not
    assert lm_ops.lm_step_plain.calls - calls == (impl == "fused")
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_w), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_w), rtol=0, atol=1e-6)


def _labels(seed, b=4, s=7, vocab=12):
    rng = np.random.default_rng(seed)
    ys = np.full((b, s), -1, np.int32)
    for i in range(b):
        n = int(rng.integers(1, s + 1))
        ys[i, :n] = rng.integers(2, vocab, size=n)
    return ys


def test_lm_forward_and_loss_match_jax():
    cfg = LMConfig(vocab_size=12, embed_dim=16, hidden_dim=24, num_layers=2)
    jlm, params, lm = _models(cfg, seed=2)
    ys = _labels(3)
    jin, jout, _ = jax_add_sos_eos(jnp.asarray(ys), cfg.sos_id, cfg.eos_id,
                                   cfg.ignore_id)
    want = jlm.apply(params, jin)
    want_loss, want_ppl = jax_lm.lm_loss(want, jout, cfg.ignore_id)
    ys_in, ys_out, _ = add_sos_eos(torch.from_numpy(ys), cfg.sos_id,
                                   cfg.eos_id, cfg.ignore_id)
    with torch.no_grad():
        got = lm(ys_in)
        loss, ppl = lm_loss(got, ys_out, cfg.ignore_id)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ppl), float(want_ppl), rtol=1e-5)


def test_lm_train_step_matches_jax():
    """One Adam step with warmup: loss, ppl, grad_norm and every updated
    parameter (Adam's first update compared as in the joint-step test)."""
    cfg = LMConfig(vocab_size=12, embed_dim=16, hidden_dim=24)
    tcfg = TrainConfig(optimizer="adam", learning_rate=1e-3, warmup_steps=2)
    jlm = _jax_lm(cfg)
    jstate, opt = jax_train_lm.init_lm_state(
        jlm, jax_config.from_dict(jax_config.TrainConfig,
                                  dataclasses.asdict(tcfg)), seed=4)
    before = jax.tree_util.tree_map(np.asarray, jstate.params)
    ys = _labels(5)
    jstate, want = jax_train_lm.make_lm_train_step(jlm, opt)(
        jstate, jnp.asarray(ys))

    lm = RNNLM(cfg)
    lm.load_state_dict(from_flax({"step_mod": before["step_mod"]}))
    state = LMState(lm, create_optimizer(lm.parameters(), tcfg))
    got = make_lm_train_step()(state, torch.from_numpy(ys))
    assert state.step == 1 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    # the first warmup step's learning rate: lr / warmup_steps
    _close_trees(to_flax(lm.state_dict()),
                 jax.tree_util.tree_map(np.asarray, jstate.params),
                 PARAM_ATOL, to_flax(from_flax(before)),
                 tcfg.learning_rate / 2)
