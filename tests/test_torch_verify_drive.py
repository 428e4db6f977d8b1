"""The port's verify drive ``robust_e2e_gan_torch.tools.verify_drive``
against ``scripts/verify_drive.py`` on the CPU: its configurations equal
the JAX script's field for field (read from the script's source, which is
not imported: it enables a JAX compile cache at import), and its data,
loop and checkpoint section passes."""

import ast
import dataclasses
import os

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import synthetic as jax_synthetic  # noqa: E402
from robust_e2e_gan_torch.tools import verify_drive  # noqa: E402

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                      "verify_drive.py")


@pytest.fixture
def one_thread():
    """Tiny eager training steps run on one thread: beside the suite's
    other workers, thread hand-offs would cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script_constants():
    """VOCAB, JCFG, SCFG and TCFG as the JAX script builds them."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    names = ("VOCAB", "JCFG", "SCFG", "TCFG")
    assigns = [node for node in tree.body if isinstance(node, ast.Assign)
               and node.targets[0].id in names]
    scope = {**vars(jax_config),
             "SyntheticConfig": jax_synthetic.SyntheticConfig}
    exec(compile(ast.Module(body=assigns, type_ignores=[]), SCRIPT, "exec"),
         scope)
    return {n: scope[n] for n in names}


def test_configs_match_the_jax_script():
    want = _script_constants()
    assert verify_drive.VOCAB == want["VOCAB"]
    for name in ("JCFG", "TCFG"):
        port = getattr(verify_drive, name)
        assert jax_config.from_dict(type(want[name]),
                                    dataclasses.asdict(port)) == want[name]
    # the port's synthetic task equals the script's field for field, and
    # the script sets none of the hard task's fields
    scfg = dataclasses.asdict(verify_drive.SCFG)
    jax_scfg = dataclasses.asdict(want["SCFG"])
    assert scfg == jax_scfg
    defaults = dataclasses.asdict(jax_synthetic.SyntheticConfig())
    hard = set(jax_scfg) - {"vocab_size", "sample_rate", "tone_ms",
                            "min_tokens", "max_tokens", "base_freq",
                            "freq_step", "noise_snr_db"}
    assert hard and all(jax_scfg[k] == defaults[k] for k in hard)
    # the drive runs the BLSTM layers on the kernels
    jcfg = verify_drive.kernel_config(verify_drive.JCFG)
    assert (jcfg.e2e.encoder.lstm_impl, jcfg.enhancer.lstm_impl) == (
        "auto", "auto")
    e2e = jcfg.e2e
    assert dataclasses.replace(
        jcfg, e2e=dataclasses.replace(e2e, encoder=dataclasses.replace(
            e2e.encoder, lstm_impl="scan")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="scan")) == (
        verify_drive.JCFG)


def test_drive_loop_and_data_on_the_cpu(one_thread):
    assert verify_drive.drive_loop_and_data(device="cpu") == [2, 4]
