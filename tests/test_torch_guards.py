"""Guards of the PyTorch port: the parameter mapping covers the JAX tree,
the configs and synthetic data match the JAX package's, the package
imports neither JAX nor the JAX package, and chip_smoke.py refuses to run
without a GPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import synthetic as jax_synthetic  # noqa: E402
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_torch import config, configs  # noqa: E402
from robust_e2e_gan_torch.data import synthetic  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402
from robust_e2e_gan_torch.utils.impl import kernel_enabled, on_cuda  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "tiny": configs.tiny_config(12),
    "flagship": configs.flagship_config(52),
    "tiny_enc_proj_bias": dataclasses.replace(
        configs.tiny_config(12),
        e2e=dataclasses.replace(
            configs.tiny_config(12).e2e,
            attention=dataclasses.replace(configs.tiny_config(12).e2e.attention,
                                          enc_proj_bias=True))),
}
# JAX config fields the port leaves out: training, XLA scheduling and
# kernel-selection knobs that do not change what the serving decode computes
LEFT_OUT = {
    "FrontendConfig": set(),
    "EncoderConfig": {"dropout_rate", "subsample_factor", "remat",
                      "scan_unroll", "gate_storage"},
    "AttentionConfig": set(),
    "DecoderConfig": {"dropout_rate", "label_smoothing",
                      "sampling_probability", "scan_unroll", "step_impl"},
    "EnhancerConfig": {"remat", "scan_unroll", "gate_storage"},
    "E2EConfig": {"mtlalpha", "ignore_id", "ctc_impl"},
    "JointConfig": {"discriminator", "lambda_adv", "mu_enh", "enh_loss"},
    "BeamSearchConfig": {"scan_unroll"},
}


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _jax_init_shapes(jcfg):
    """Shapes of ``model.init(...)["params"]``, traced without running."""
    vocab = jcfg.e2e.decoder.vocab_size
    batch = synthetic.make_batch(
        2, synthetic.SyntheticConfig(vocab_size=vocab, min_tokens=2,
                                     max_tokens=3), np.random.default_rng(0))
    model = JaxRobustE2E(_jax(jcfg))
    tree = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["noisy_wav"]),
            jnp.asarray(batch["wav_lengths"]), jnp.asarray(batch["labels"]),
            use_enhancer=True, method=JaxRobustE2E.asr_forward,
        )["params"])
    return _flat(tree)


@pytest.mark.parametrize("name", list(CONFIGS), ids=list(CONFIGS))
def test_parameter_trees_match_jax_init(name):
    jcfg = CONFIGS[name]
    want = _jax_init_shapes(jcfg)
    tree = init_params(jcfg, 0)
    assert _flat(tree) == want  # same keys, same flax-layout shapes

    state = from_flax(tree)
    port = build_model(jcfg).state_dict()
    assert set(state) == set(port) == set(want)
    for key, shape in want.items():
        got = tuple(state[key].shape)
        assert got == tuple(port[key].shape), key
        if key.endswith("loc_conv.kernel"):
            assert got == (shape[2], shape[1], shape[0])
        elif len(shape) == 4:
            assert got == (shape[3], shape[2], shape[0], shape[1])
        else:
            assert got == shape, key


def test_from_flax_loads_a_real_jax_init_tree():
    jcfg = configs.tiny_config(12)
    batch = synthetic.make_batch(
        2, synthetic.SyntheticConfig(vocab_size=12, min_tokens=2,
                                     max_tokens=3), np.random.default_rng(0))
    params = JaxRobustE2E(_jax(jcfg)).init(
        jax.random.PRNGKey(3), jnp.asarray(batch["noisy_wav"]),
        jnp.asarray(batch["wav_lengths"]), jnp.asarray(batch["labels"]),
        use_enhancer=True, method=JaxRobustE2E.asr_forward)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = build_model(jcfg)
    model.load_state_dict(from_flax(params), strict=True)
    conv = params["asr"]["encoder"]["vgg"]["conv0_1"]["kernel"]
    torch.testing.assert_close(
        model.asr.encoder.vgg.conv0_1.kernel,
        torch.from_numpy(conv.transpose(3, 2, 0, 1).copy()), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["flagship", "tiny"])
def test_configs_match_graft_entry(name):
    vocab = 52 if name == "flagship" else 12
    ours = getattr(configs, f"{name}_config")(vocab)
    theirs = getattr(graft, f"_{name}_config")(vocab)
    assert ours == config.from_dict(config.JointConfig,
                                    dataclasses.asdict(theirs))


@pytest.mark.parametrize("name", list(LEFT_OUT))
def test_config_fields_are_the_jax_fields(name):
    """Every port field is the JAX field of that name with its default;
    every JAX field the port lacks is one it leaves out on purpose."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    names = {f.name for f in dataclasses.fields(ours)}
    jax_names = {f.name for f in dataclasses.fields(theirs)}
    assert jax_names - names == LEFT_OUT[name]
    assert names <= jax_names
    assert config.from_dict(ours, dataclasses.asdict(theirs())) == ours()


@pytest.mark.parametrize("kw", [
    dict(vocab_size=12, min_tokens=2, max_tokens=4),
    dict(vocab_size=52, min_tokens=48, max_tokens=58),  # the bench traffic
], ids=["tiny", "bench"])
def test_synthetic_batch_matches_jax(kw):
    want = jax_synthetic.make_batch(3, jax_synthetic.SyntheticConfig(**kw),
                                    np.random.default_rng(5), ignore_id=-1)
    got = synthetic.make_batch(3, synthetic.SyntheticConfig(**kw),
                               np.random.default_rng(5))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_port_imports_no_jax():
    child = (
        "import importlib, pkgutil, sys\n"
        "import robust_e2e_gan_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax', 'robust_e2e_gan_tpu')\n"
        "       if m in sys.modules]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", child], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _run_smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_impl_selection():
    assert kernel_enabled("auto") and kernel_enabled("tiled")
    assert not kernel_enabled("scan") and not kernel_enabled("xla")
    assert not kernel_enabled("twopass")
    with pytest.raises(ValueError):
        kernel_enabled("palas")
    assert not on_cuda(torch.zeros(1), torch.zeros(2))
    with pytest.raises(ValueError):
        on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
