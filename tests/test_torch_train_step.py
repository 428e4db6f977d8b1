"""The port's training steps against the JAX package's, one tiny-config
step from the same converted parameters and batch, in float32: every
metric, both gradient norms, and the updated generator and discriminator
parameters. Dropout and scheduled sampling are 0 (the two frameworks draw
different random numbers)."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models.enhancement import (  # noqa: E402
    Discriminator as JaxDiscriminator,
)
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_tpu.train import steps as jax_steps  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import TrainConfig  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, to_flax  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.models.enhancement import Discriminator  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402
from robust_e2e_gan_torch.train import steps  # noqa: E402

# losses and norms: float32 sums in another order; parameters after one
# step: Adadelta's first update is ~4.5e-4 * sign(g), Adam's lr-sized
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-6
# Adam's first update is -lr * g / (|g| + 1e-8): linear in g for |g| << 1e-8
# and saturated at lr for |g| >> 1e-8, but between the two (1% to 99% of
# lr) it magnifies the float32 rounding of g itself by up to lr / 1e-8.
# There the gradient the update implies, g = 1e-8 * u / (lr - |u|), is
# compared instead, at the gradients' own float32 error (~2e-8 absolute
# on gradients of scale 0.03, tiny config)
ADAM_EPS = 1e-8
ADAM_BAND = (0.01, 0.99)
ADAM_GRAD_ATOL = 5e-8
SYNTH = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=3)


def _jcfg():
    jcfg = configs.tiny_config(12)
    e2e = jcfg.e2e
    # the kernel impl names: on CPU tensors they run the plain training
    # versions (blstm_train with its rounding points, the CTC adjoint loop)
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(
            e2e, encoder=dataclasses.replace(e2e.encoder, lstm_impl="auto")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))


def _jax(cfg):
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _setup(tcfg, seed=0):
    jcfg = _jcfg()
    rng = np.random.default_rng(seed)
    batch = make_batch(3, SYNTH, rng)
    # dither the clean speech: its silent stretches put log-mel values at
    # the log floor, where float32 DFT sums in another order differ by
    # 1e-3 and flip the discriminator's leaky-ReLU slopes
    valid = np.arange(SYNTH.max_samples)[None] < batch["wav_lengths"][:, None]
    batch["clean_wav"] += (0.1 * rng.standard_normal(
        batch["clean_wav"].shape) * valid).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jjcfg = _jax(jcfg)
    jmodel = JaxRobustE2E(jjcfg)
    jdisc = JaxDiscriminator(jjcfg.discriminator)
    jstate, opt_g, opt_d = jax_steps.init_train_state(
        jmodel, jdisc, _jax(tcfg), jbatch, seed=seed)
    params_g = jax.tree_util.tree_map(np.asarray, jstate.params_g)
    params_d = jax.tree_util.tree_map(np.asarray, jstate.params_d)

    model = build_model(jcfg)
    model.load_state_dict(from_flax(params_g))
    disc = Discriminator(jcfg.discriminator)
    disc.load_state_dict(from_flax(params_d))
    state = steps.init_train_state(model, disc, tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return (jcfg, jjcfg, jmodel, jdisc, jstate, opt_g, opt_d, jbatch, state,
            tbatch)


def _close_trees(got, want, atol, before=None, adam_lr=None):
    flat_got = dict(_flat(got))
    flat_want = dict(_flat(want))
    assert set(flat_got) == set(flat_want)
    for k, w in flat_want.items():
        g = flat_got[k]
        if adam_lr is not None:
            p0 = dict(_flat(before))[k]
            u_want, u_got = w - p0, g - p0
            band = ((np.abs(u_want) > ADAM_BAND[0] * adam_lr)
                    & (np.abs(u_want) < ADAM_BAND[1] * adam_lr))

            def implied(u):
                return ADAM_EPS * u / (adam_lr - np.abs(u))

            np.testing.assert_allclose(implied(u_got[band]),
                                       implied(u_want[band]), rtol=0,
                                       atol=ADAM_GRAD_ATOL, err_msg=k)
            g, w = g[~band], w[~band]
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["adadelta", "adam_warmup", "gan"])
def test_joint_step_matches_jax(kind):
    tcfg = (TrainConfig(optimizer="adam", learning_rate=1e-3, warmup_steps=2)
            if kind == "adam_warmup" else TrainConfig())
    with_asr = kind != "gan"
    (jcfg, jjcfg, jmodel, jdisc, jstate, opt_g, opt_d, jbatch, state,
     tbatch) = _setup(tcfg)
    jstep = jax_steps.make_joint_train_step(jmodel, jdisc, jjcfg, opt_g,
                                            opt_d, with_asr=with_asr)
    before_g = to_flax(state.model.state_dict())
    before_d = to_flax(state.discriminator.state_dict())
    jstate, want = jstep(jstate, jbatch)
    step = steps.make_joint_train_step(jcfg, with_asr=with_asr)
    got = step(state, tbatch)
    _close_metrics(got, want)
    assert state.step == 1
    # the first warmup step's learning rate: lr / warmup_steps
    lr = tcfg.learning_rate / 2 if kind == "adam_warmup" else None
    _close_trees(to_flax(state.model.state_dict()), jstate.params_g,
                 PARAM_ATOL, before_g, lr)
    _close_trees(to_flax(state.discriminator.state_dict()), jstate.params_d,
                 PARAM_ATOL, before_d, lr)


def test_asr_pretrain_and_eval_steps_match_jax():
    tcfg = TrainConfig()
    (jcfg, jjcfg, jmodel, jdisc, jstate, opt_g, opt_d, jbatch, state,
     tbatch) = _setup(tcfg, seed=1)
    jeval = jax_steps.make_eval_step(jmodel, use_enhancer=True)
    _close_metrics(steps.make_eval_step(True)(state.model, tbatch),
                   jeval(jstate.params_g, jbatch))
    jstep = jax_steps.make_asr_pretrain_step(jmodel, opt_g)
    jstate, want = jstep(jstate, jbatch)
    got = steps.make_asr_pretrain_step()(state, tbatch)
    _close_metrics(got, want)
    _close_trees(to_flax(state.model.state_dict()), jstate.params_g,
                 PARAM_ATOL)


def test_decay_adadelta_eps_matches_jax():
    tcfg = TrainConfig(adadelta_eps=1e-6)
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = steps.create_optimizer(params, tcfg)
    steps.decay_adadelta_eps(opt, 0.01)
    jopt = jax_steps.create_optimizer(_jax(tcfg))
    jstate = jax_steps.decay_adadelta_eps(jopt.init(jnp.ones(3)), 0.01)
    want = float(jstate[1].hyperparams["eps"])
    assert opt.opt.param_groups[0]["eps"] == pytest.approx(want, rel=1e-6)
    adam = steps.create_optimizer(params, TrainConfig(optimizer="adam"))
    steps.decay_adadelta_eps(adam, 0.01)  # a no-op for Adam
    assert "eps" in adam.opt.param_groups[0]
    assert adam.opt.param_groups[0]["eps"] == 1e-8


def test_input_kinds_not_ported_raise():
    """The input kinds no JAX step runs raise: the joint and GAN steps on
    precomputed log-mel (they need the linear spectrum the enhancer
    masks; the JAX CLI refuses them too) and an unknown kind. The
    precomputed kinds' steps are held against JAX in
    test_torch_precomputed.py."""
    with pytest.raises(ValueError, match="--mode asr only"):
        steps.make_joint_train_step(_jcfg(), input_kind="feats")
    for make in (steps.make_asr_pretrain_step, steps.make_eval_step):
        with pytest.raises(ValueError, match="input_kind must be one of"):
            make(input_kind="mfcc")
    for kind in steps.INPUT_KINDS:
        assert callable(steps.make_asr_pretrain_step(input_kind=kind))
        assert callable(steps.make_eval_step(input_kind=kind))
