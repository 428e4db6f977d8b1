"""Guards of the PyTorch port: the parameter mapping covers the JAX tree,
the configs, synthetic data and LM label batches match the JAX package's,
each command-line tool takes the JAX tool's flags (and ``--device`` where
it runs on the device),
the package imports neither JAX nor the JAX package, the inference-only
wrappers refuse autograd, the entry points refuse to fall back to the CPU,
and chip_smoke.py refuses to run without a GPU."""

import argparse
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
from robust_e2e_gan_tpu.models import lm as jax_lm  # noqa: E402
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
# the AttAdd and AttDot models: the attention subtree follows the variant
for _variant in ("add", "dot"):
    for _name, _cfg in (("tiny", configs.tiny_config(12)),
                        ("flagship", configs.flagship_config(52))):
        CONFIGS[f"{_name}_{_variant}"] = dataclasses.replace(
            _cfg, e2e=dataclasses.replace(
                _cfg.e2e, attention=dataclasses.replace(
                    _cfg.e2e.attention, variant=_variant)))
# JAX config fields the port leaves out: XLA scheduling knobs, which do
# not change what is computed, and the fixed subsampling factor (the fused
# decoder step's step_impl is kept: it rounds where the unfused step does
# not, and launches once; gate_storage is kept: "compute" rounds the bf16
# scan's gate projections)
LEFT_OUT = {
    "FrontendConfig": set(),
    "EncoderConfig": {"subsample_factor", "remat", "scan_unroll"},
    "AttentionConfig": set(),
    "DecoderConfig": {"scan_unroll"},
    "EnhancerConfig": {"remat", "scan_unroll"},
    "DiscriminatorConfig": set(),
    "E2EConfig": set(),
    "JointConfig": set(),
    "BeamSearchConfig": {"scan_unroll"},
    "TrainConfig": set(),
    "LMConfig": set(),
}
# JAX config classes that live outside robust_e2e_gan_tpu/config.py
JAX_CLASSES = {"LMConfig": jax_lm.LMConfig}


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
    ours = getattr(config, name)
    theirs = JAX_CLASSES.get(name) or getattr(jax_config, name)
    names = {f.name for f in dataclasses.fields(ours)}
    jax_names = {f.name for f in dataclasses.fields(theirs)}
    assert jax_names - names == LEFT_OUT[name]
    assert names <= jax_names
    assert config.from_dict(ours, dataclasses.asdict(theirs())) == ours()


# name -> (the config, built from either package's synthetic module, and
# make_batch's keyword arguments)
SYNTH_CASES = {
    "tiny": (lambda m: m.SyntheticConfig(vocab_size=12, min_tokens=2,
                                         max_tokens=4), {}),
    # the bench traffic
    "bench": (lambda m: m.SyntheticConfig(vocab_size=52, min_tokens=48,
                                          max_tokens=58), {}),
    # the paper-claim protocols' task, and its round-2 form
    "hard": (lambda m: m.hard_task(32), {}),
    "hard_no_reverb_babble": (
        lambda m: m.hard_task(32, reverb=False, babble=False), {}),
    # lm_benefit's lexicon task, with a seed that moves the lexicon
    "lexicon": (lambda m: dataclasses.replace(m.hard_task(32, seed=3),
                                              lexicon_size=50), {}),
    "jitter": (lambda m: m.SyntheticConfig(vocab_size=12, tone_jitter=0.3),
               {}),
    "snr_range": (lambda m: m.SyntheticConfig(vocab_size=12,
                                              snr_range_db=(-3.0, 5.0)), {}),
    # padded short of the longest utterances (cut) and with another label
    # pad; the flat task's max_tokens override
    "pad_ignore": (lambda m: m.hard_task(32),
                   dict(pad_to_samples=20000, ignore_id=-7)),
    "max_tokens": (lambda m: m.SyntheticConfig(vocab_size=12),
                   dict(max_tokens=3, pad_to_samples=9000)),
}


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_synthetic_batch_matches_jax(case):
    make_cfg, kw = SYNTH_CASES[case]
    want = jax_synthetic.make_batch(3, make_cfg(jax_synthetic),
                                    np.random.default_rng(5),
                                    **{"ignore_id": -1, **kw})
    got = synthetic.make_batch(3, make_cfg(synthetic),
                               np.random.default_rng(5), **kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# the subcommands of ``python -m robust_e2e_gan_torch`` that run on the
# device and so add ``--device`` to the JAX tool's flags
DEVICE_TOOLS = {"train": True, "decode": True, "enhance": True,
                "score": False, "cmvn": True, "fbank": True,
                "copy-feats": False}


@pytest.mark.parametrize("command", list(DEVICE_TOOLS))
def test_cli_flags_are_the_jax_flags(command, monkeypatch):
    """Each subcommand's parser, caught as its ``main`` parses, against the
    JAX package's subcommand of that name."""
    from robust_e2e_gan_tpu import __main__ as jax_entry
    from robust_e2e_gan_torch import __main__ as entry

    class Parsed(Exception):
        pass

    def catch(parser, *a, **kw):
        raise Parsed(parser)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    flags = []
    for main in (entry.main, jax_entry.main):
        with pytest.raises(Parsed) as exc:
            main([command])
        flags.append({s for a in exc.value.args[0]._actions
                      for s in a.option_strings})
    assert flags[0] - flags[1] == ({"--device"} if DEVICE_TOOLS[command]
                                   else set())
    assert flags[1] <= flags[0]


def test_port_imports_no_jax():
    child = (
        "import importlib, pkgutil, sys\n"
        "import robust_e2e_gan_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "                   'robust_e2e_gan_tpu', 'tools')\n"
        "       if m in sys.modules]\n"
        "need = {'robust_e2e_gan_torch.' + m for m in ('models.lm',\n"
        "        'ops.lm_step', 'ops.fbank_fused', 'train.lm', 'decode.cli',\n"
        "        'data.dataset', 'ops.editdistance', 'ops.att_dec',\n"
        "        'data.cmvn', 'data.cmvn_cli', 'data.featbin_cli',\n"
        "        '__main__', 'utils.flax_msgpack',\n"
        "        'tools.import_reference_ckpt')}\n"
        "print(len(names), bad, need - set(names))\n"
        "sys.exit(1 if bad or need - set(names) or len(names) < 23 else 0)\n"
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
    assert kernel_enabled("pallas") and kernel_enabled("fused")
    assert not kernel_enabled("scan") and not kernel_enabled("xla")
    assert not kernel_enabled("twopass")
    with pytest.raises(ValueError):
        kernel_enabled("palas")
    assert not on_cuda(torch.zeros(1), torch.zeros(2))
    with pytest.raises(ValueError):
        on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


def test_inference_wrappers_refuse_autograd():
    """The inference kernel wrappers write fresh tensors that carry no graph;
    under autograd they raise instead of cutting the gradient chain."""
    from robust_e2e_gan_torch.config import FrontendConfig
    from robust_e2e_gan_torch.ops import att, att_dec, blstm, ctc_prefix
    from robust_e2e_gan_torch.ops import fbank_fused, lm_step

    def leaf(*shape):
        return torch.randn(shape).requires_grad_()

    b, k, t, h, v = 2, 3, 5, 4, 6
    ints = torch.ones((b, k), dtype=torch.int32)
    calls = {
        "blstm_recurrence": lambda: blstm.blstm_recurrence(
            leaf(b, t, 2, 4 * h), leaf(2, h, 4 * h),
            torch.full((b,), t, dtype=torch.int32)),
        "blstm_infer": lambda: blstm.blstm_infer(
            leaf(b, t, 3), torch.full((b,), t, dtype=torch.int32),
            leaf(2, 3, 4 * h), leaf(2, h, 4 * h), leaf(2, 4 * h)),
        "att_loc_step": lambda: att.att_loc_step(
            leaf(b, k, t, 2), leaf(b, t, 3), leaf(b, t, 3), leaf(b, k, 3),
            leaf(2, 3), leaf(3), torch.ones(b, t), 2.0),
        "prefix_psi": lambda: ctc_prefix.prefix_psi(
            leaf(b, t, v), ints, ints, leaf(b, k, t), leaf(b, k, t), 0, 1),
        "att_dec_step": lambda: att_dec.att_dec_step(
            leaf(b, k, t, 2), leaf(b, t, 3), leaf(b, t, 3), leaf(b, k, 3),
            leaf(2, 3), leaf(3), torch.ones(b, t), 2.0, ints, leaf(v, 4),
            leaf(4 + 3, 4 * h), leaf(h, 4 * h), leaf(4 * h), leaf(h + 3, v),
            leaf(v), torch.zeros(b, k, h), torch.zeros(b, k, h)),
        "prefix_psi_utt": lambda: ctc_prefix.prefix_psi_utt(
            leaf(b, t, v), ints, ints, leaf(b, k, t), leaf(b, k, t), 0, 1),
        "prefix_state": lambda: ctc_prefix.prefix_state(
            leaf(b, t, v), ints, ints, ints, leaf(b, k, t), leaf(b, k, t), 0),
        "prefix_state_step": lambda: ctc_prefix.prefix_state_step(
            leaf(b, t, v), ints.long() * 0, ints, ints > 0, ints, ints,
            leaf(b, k, t), leaf(b, k, t), 0),
        "fbank_fused": lambda: fbank_fused.fbank_fused(
            leaf(b, 800), FrontendConfig(n_mels=8)),
        "lm_step": lambda: lm_step.lm_step(
            torch.tensor([0, 2, 1]), leaf(v, 3), [leaf(3, 4 * h)],
            [leaf(h, 4 * h)], [leaf(4 * h)], leaf(h, v), leaf(v),
            torch.zeros(1, 3, h), torch.zeros(1, 3, h)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="inference-only"):
            call()
        with torch.no_grad():
            call()  # the same inputs without autograd run


def test_lm_label_batches_match_the_jax_cli(monkeypatch, tmp_path):
    """``--mode lm --synthetic`` trains on the same (B, max_tokens) label
    batches as the JAX CLI, epoch after epoch, for the same seed."""
    from robust_e2e_gan_tpu.train import cli as jax_cli
    from robust_e2e_gan_tpu.train import lm as jax_train_lm
    from robust_e2e_gan_torch.train import cli

    argv = ["--mode", "lm", "--synthetic", "--seed", "3", "--batch-size", "4",
            "--synthetic-utts", "12", "--ckpt-dir", str(tmp_path)]
    captured = {}
    monkeypatch.setattr(jax_train_lm, "train_lm",
                        lambda lmcfg, tcfg, batches, **kw: captured.update(
                            batches=batches, vocab=lmcfg.vocab_size))
    jax_cli._lm_main(jax_cli.build_parser().parse_args(argv))
    batches, vocab = cli._lm_label_batches(cli.build_parser().parse_args(argv))
    assert vocab == captured["vocab"]
    for _ in range(2):  # two epochs continue one stream
        want = list(captured["batches"]())
        got = list(batches())
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape == (4, 10)
            np.testing.assert_array_equal(g, w)


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """Without a card the training and decoding entry points raise unless
    the caller asks for the CPU."""
    from robust_e2e_gan_torch.config import LMConfig, TrainConfig
    from robust_e2e_gan_torch.decode import cli as decode_cli
    from robust_e2e_gan_torch.train import cli, loop
    from robust_e2e_gan_torch.train.lm import load_lm, train_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TrainConfig(checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(configs.tiny_config(12), tcfg, lambda: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm(LMConfig(), tcfg, lambda: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_lm(str(tmp_path))
    for mode in ("joint", "lm"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--mode", mode, "--synthetic", "--ckpt-dir",
                      str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        decode_cli.main(["--ckpt-dir", str(tmp_path), "--manifest", "m"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_cli.load_experiment(str(tmp_path))
    assert not os.listdir(tmp_path)  # refused before writing anything
    assert loop.resolve_device("cpu") == torch.device("cpu")
