"""The port's AttAdd and AttDot against the JAX package's, in float32: each
step in beam and non-beam mode, the factory's refusal, the serving search
of a model with each variant (also with ``step_impl="fused"``, which such
a model does not take), and the model's joint loss and its parameter
gradients."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.decode.beam import (  # noqa: E402
    make_beam_searcher as jax_make_beam_searcher,
)
from robust_e2e_gan_tpu.models.attention import (  # noqa: E402
    make_attention as jax_make_attention,
)
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_torch.config import BeamSearchConfig  # noqa: E402
from robust_e2e_gan_torch.configs import tiny_config  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params, to_flax  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.decode.beam import make_beam_searcher  # noqa: E402
from robust_e2e_gan_torch.models.attention import (  # noqa: E402
    ATTENTION_VARIANTS,
    AttAdd,
    AttDot,
    make_attention,
)
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402

# float32: the same arithmetic in another summation order
RTOL, ATOL = 1e-4, 1e-5
B, K, T, E, D = 2, 3, 10, 32, 32
VARIANTS = ("add", "dot")
SYNTH = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _variant(variant, step_impl="auto"):
    """The tiny model with attention ``variant``, its kernel impl names
    (which run the plain versions on CPU tensors)."""
    jcfg = tiny_config()
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(
            e2e,
            encoder=dataclasses.replace(e2e.encoder, lstm_impl="auto"),
            attention=dataclasses.replace(e2e.attention, variant=variant),
            decoder=dataclasses.replace(e2e.decoder, step_impl=step_impl)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    hlens = np.array([T, 6])
    mask = (np.arange(T)[None] < hlens[:, None]).astype(np.float32)
    enc = (rng.standard_normal((B, T, E)) * mask[..., None]).astype(np.float32)
    enc_proj = rng.standard_normal((B, T, 24)).astype(np.float32)
    dec_z = rng.standard_normal((B, K, D)).astype(np.float32)
    att_prev = np.full((B, K, T), 1.0 / T, np.float32)
    return enc, enc_proj, mask, dec_z, att_prev


@pytest.mark.parametrize("beam", [True, False], ids=["beam", "non_beam"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_attention_step_matches_jax(variant, beam):
    jcfg = _variant(variant)
    acfg = jcfg.e2e.attention
    p_att = init_params(jcfg, 3)["asr"]["decoder"]["step_mod"]["att"]
    enc, enc_proj, mask, dec_z, att_prev = _step_inputs(4)
    if not beam:
        dec_z, att_prev = dec_z[:, 0], att_prev[:, 0]
    arrays = (enc, enc_proj, mask, dec_z, att_prev)
    want = jax_make_attention(_jax(acfg)).apply(
        {"params": p_att}, *map(jnp.asarray, arrays))

    att = make_attention(acfg, D)
    assert type(att) is ATTENTION_VARIANTS[variant]
    att.load_state_dict(from_flax(p_att))
    with torch.no_grad():
        got = att(*map(torch.from_numpy, arrays))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    alignment = got[1].numpy()
    assert not alignment[1, ..., 6:].any()  # exact zeros on pad frames
    np.testing.assert_allclose(alignment.sum(-1), 1.0, rtol=1e-5)


def test_variants_keep_their_own_parameters():
    """AttAdd holds mlp_dec and gvec, AttDot mlp_dec alone; the alignment
    comes back in att_prev's dtype whatever the context's."""
    acfg = tiny_config().e2e.attention
    assert set(AttAdd(acfg, D).state_dict()) == {"mlp_dec.kernel",
                                                 "gvec.kernel"}
    assert set(AttDot(acfg, D).state_dict()) == {"mlp_dec.kernel"}
    enc, enc_proj, mask, dec_z, att_prev = map(torch.from_numpy,
                                               _step_inputs(5))
    ctx, att = AttDot(acfg, D)(enc, enc_proj, mask, dec_z,
                               att_prev.double())
    assert ctx.dtype == torch.float32 and att.dtype == torch.float64


def test_unknown_variant_raises():
    acfg = dataclasses.replace(tiny_config().e2e.attention, variant="nope")
    with pytest.raises(ValueError, match="unknown attention variant"):
        make_attention(acfg, D)
    with pytest.raises(ValueError, match="unknown attention variant"):
        build_model(_variant("nope"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_search_with_variant_matches_jax(variant):
    """The serving search of a model with ``variant``, token-exact against
    the JAX searcher; with ``step_impl="fused"`` the port's decoder keeps
    the unfused step, as the JAX decoder does."""
    bcfg = BeamSearchConfig(beam_size=3, ctc_weight=0.3, max_steps=8,
                            early_exit=False)
    jcfg = _variant(variant)
    params = init_params(jcfg, 7)
    batch = make_batch(3, SYNTH, np.random.default_rng(3))
    wav, lens = batch["noisy_wav"], batch["wav_lengths"]
    want = jax_make_beam_searcher(JaxRobustE2E(_jax(jcfg)), _jax(jcfg.e2e),
                                  _jax(bcfg), use_enhancer=True)(
        params, jnp.asarray(wav), jnp.asarray(lens))
    for step_impl in ("auto", "fused"):
        cfg = _variant(variant, step_impl)
        model = build_model(cfg)
        assert not model.asr.decoder.step_mod.fused_step
        model.load_state_dict(from_flax(params))
        got = make_beam_searcher(model, cfg.e2e, bcfg, use_enhancer=True)(
            torch.from_numpy(wav), torch.from_numpy(lens))
        np.testing.assert_array_equal(got.beam_tokens.numpy(),
                                      np.asarray(want.beam_tokens))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=1e-3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_joint_loss_and_gradients_match_jax(variant):
    """The joint CTC/attention loss of enhanced speech and every parameter
    gradient against ``jax.grad``, each within 1e-4 of its tensor's
    max |grad|."""
    jcfg = _variant(variant)
    params = init_params(jcfg, 11)
    batch = make_batch(2, SYNTH, np.random.default_rng(6))
    args = (batch["noisy_wav"], batch["wav_lengths"], batch["labels"])
    jmodel = JaxRobustE2E(_jax(jcfg))

    def jloss(p):
        return jmodel.apply({"params": p}, *map(jnp.asarray, args),
                            use_enhancer=True,
                            method=JaxRobustE2E.asr_forward)["loss"]

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = build_model(jcfg)
    model.load_state_dict(from_flax(params))
    loss = model.asr_forward(*map(torch.from_numpy, args),
                             use_enhancer=True)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = to_flax({n: p.grad for n, p in model.named_parameters()})
    flat_want = dict(_leaves(jax.tree_util.tree_map(np.asarray, want_grads)))
    flat_got = dict(_leaves(got))
    assert set(flat_got) == set(flat_want)
    for name, w in flat_want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(flat_got[name], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v
