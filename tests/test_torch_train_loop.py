"""The port's training entry point and loop on the CPU at tiny widths:
``train.cli --synthetic --mode joint`` writes checkpoints and resumes from
them; a resumed run continues the step count, the optimizer state and the
random streams (it ends bit-identical to an uninterrupted run); dropout
and scheduled sampling fire at their rates; ``--mode lm`` trains, resumes
and reloads the RNNLM; ``--mode asr --fused-frontend`` trains through the
fused frontend. Every run asks for the CPU (``--device cpu``)."""

import dataclasses
import json
import os

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import TrainConfig  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.models.decoder import Decoder  # noqa: E402
from robust_e2e_gan_torch.models.rnn import dropout  # noqa: E402
from robust_e2e_gan_torch.ops.fbank_fused import fbank_fused_plain  # noqa: E402
from robust_e2e_gan_torch.pipeline import RobustE2E  # noqa: E402
from robust_e2e_gan_torch.train import cli, loop  # noqa: E402
from robust_e2e_gan_torch.train.lm import load_lm  # noqa: E402

TINY = ["--n-mels", "24", "--enc-layers", "1", "--enc-hidden", "32",
        "--enc-proj", "32", "--att-dim", "24", "--dec-hidden", "32",
        "--dec-embed", "16", "--enh-layers", "1", "--enh-hidden", "32",
        "--batch-size", "2", "--synthetic-utts", "4", "--log-every", "1",
        "--device", "cpu"]


def _latest(ckpt_dir):
    with open(os.path.join(ckpt_dir, "checkpoints.json")) as f:
        return json.load(f)["latest"]


def test_cli_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "exp")
    argv = ["--mode", "joint", "--synthetic", "--ckpt-dir", ckpt, *TINY]
    cli.main(argv + ["--epochs", "1"])
    first = _latest(ckpt)
    assert first["step"] == 2 and first["extra"]["epoch_complete"]
    assert os.path.exists(os.path.join(ckpt, "config.json"))
    cli.main(argv + ["--epochs", "2"])  # resumes: one more epoch
    assert _latest(ckpt)["step"] == 4
    saved = torch.load(os.path.join(ckpt, "ckpt_4.pt"), weights_only=True)
    assert saved["step"] == 4 and set(saved["rngs"]) == {"dropout",
                                                         "sampling"}


@pytest.mark.parametrize("argv", [
    ["--train-noisy-scp", "wav.scp"],
    ["--synthetic", "--cmvn", "global"],
], ids=["corpus", "global_cmvn"])
def test_cli_refuses_unported_sources(tmp_path, argv):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        cli.main(argv + ["--ckpt-dir", str(tmp_path)])


def test_cli_trains_the_lm_resumes_and_reloads(tmp_path):
    ckpt = str(tmp_path / "lm")
    argv = ["--mode", "lm", "--synthetic", "--ckpt-dir", ckpt,
            "--optimizer", "adam", "--lr", "1e-3", *TINY]
    cli.main(argv + ["--epochs", "1"])
    assert _latest(ckpt)["step"] == 2
    cli.main(argv + ["--epochs", "2"])  # resumes: one more epoch
    assert _latest(ckpt)["step"] == 4
    with open(os.path.join(ckpt, "config.json")) as f:
        saved_cfg = json.load(f)
    assert saved_cfg["mode"] == "lm"
    assert saved_cfg["lm"]["embed_dim"] == 16
    assert saved_cfg["lm"]["hidden_dim"] == 32

    lm = load_lm(ckpt, device="cpu")  # "best": the lowest last-step loss
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        best = json.load(f)["best"]
    saved = torch.load(os.path.join(ckpt, best["path"]), weights_only=True)
    assert not lm.training
    assert all(p.dtype == torch.float32 for p in lm.parameters())
    for k, v in lm.state_dict().items():
        assert torch.equal(v, saved["lm"][k]), k
    # the reloaded LM steps on token ids
    with torch.no_grad():
        (h, c), logits = lm.step(lm.initial_carry(3),
                                 torch.tensor([1, 2, 3]))
    assert logits.shape == (3, 12) and bool(torch.isfinite(logits).all())


def test_cli_trains_through_the_fused_frontend(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "asr")
    calls = fbank_fused_plain.calls
    power_calls = []
    split = RobustE2E.noisy_power
    monkeypatch.setattr(RobustE2E, "noisy_power", lambda self, *a: (
        power_calls.append(1), split(self, *a))[1])
    cli.main(["--mode", "asr", "--fused-frontend", "--synthetic",
              "--ckpt-dir", ckpt, "--epochs", "1", *TINY])
    assert _latest(ckpt)["step"] == 2
    # 2 train steps and a dev batch per epoch, none through the split chain
    assert fbank_fused_plain.calls - calls == 3 and not power_calls


def _loop_run(ckpt_dir, epochs):
    jcfg = configs.tiny_config(12)
    e2e = jcfg.e2e
    jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(
        e2e, encoder=dataclasses.replace(e2e.encoder, dropout_rate=0.3),
        decoder=dataclasses.replace(e2e.decoder, sampling_probability=0.4)))
    tcfg = TrainConfig(num_epochs=epochs, checkpoint_dir=ckpt_dir,
                       log_every=100)
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=3)

    def batches():
        rng = np.random.default_rng(7)
        return (make_batch(2, scfg, rng) for _ in range(2))

    return loop.train(jcfg, tcfg, batches, dev_batches=batches,
                      device="cpu")


def test_resume_continues_the_random_streams(tmp_path):
    straight = _loop_run(str(tmp_path / "a"), 2)
    _loop_run(str(tmp_path / "b"), 1)
    resumed = _loop_run(str(tmp_path / "b"), 2)
    assert straight.step == resumed.step == 4
    for name, g in straight.rngs.items():
        assert torch.equal(g.get_state(), resumed.rngs[name].get_state())
    for (k, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_dropout_rate():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.3, gen)
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - 0.3) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))


def test_scheduled_sampling_rate():
    """Gold tokens are 3 and the readout always predicts 5, so a fed 5 is a
    sampled step; step 0 never samples."""
    jcfg = configs.tiny_config(12)
    dcfg = dataclasses.replace(jcfg.e2e.decoder, sampling_probability=0.4)
    dec = Decoder(dcfg, jcfg.e2e.attention, 32)
    with torch.no_grad():
        for p in dec.parameters():
            p.normal_(0, 0.1)
        dec.step_mod.output.bias[5] = 100.0
    fed = []
    step = dec.step_mod.forward

    def record(carry, tok, *args):
        fed.append(tok.clone())
        return step(carry, tok, *args)

    dec.step_mod.forward = record
    b, s, t = 400, 6, 5
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        dec(torch.randn(b, t, 32), torch.ones(b, t),
            torch.full((b, s), 3), deterministic=False, gen=gen)
    fed = torch.stack(fed, 1)
    assert (fed[:, 0] == 3).all()
    rate = (fed[:, 1:] == 5).float().mean().item()
    assert abs(rate - 0.4) < 0.03
