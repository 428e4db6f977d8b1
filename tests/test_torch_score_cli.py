"""The port's scoring CLI ``robust_e2e_gan_torch.decode.score_cli`` and
``ops/editdistance.py::bootstrap_wer_ci`` against the JAX package's on the
CPU: the same intervals for the same seeds, and the same report JSON and
printed lines on a ref/hyp pair with missing and extra utterances."""

import json

import pytest

pytest.importorskip("jax")

from robust_e2e_gan_tpu.decode import score_cli as jax_score  # noqa: E402
from robust_e2e_gan_tpu.ops import editdistance as jax_ed  # noqa: E402
from robust_e2e_gan_torch.decode import score_cli  # noqa: E402
from robust_e2e_gan_torch.ops import editdistance as ed  # noqa: E402

REFS = {"u1": "the cat sat", "u2": "on the mat", "u3": "a dog", "u4": "",
        "u5": "hello world again", "u6": "missing from the hyps"}
HYPS = {"u1": "the cat sat", "u2": "on a mat mat", "u3": "dog", "u4": "oops",
        "u5": "hello word again", "u7": "no such reference"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("score")
    for name, d in (("ref", REFS), ("hyp", HYPS)):
        (root / name).write_text("".join(f"{k} {v}\n".replace(" \n", "\n")
                                         for k, v in d.items()) + "\n")
    return root


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bootstrap_matches_jax(seed):
    refs = [t.split() for t in REFS.values()]
    hyps = [HYPS.get(k, "").split() for k in REFS]
    want = jax_ed.bootstrap_wer_ci(refs, hyps, n_resamples=300, seed=seed)
    assert ed.bootstrap_wer_ci(refs, hyps, n_resamples=300, seed=seed) == want
    assert want["ci_low"] <= want["error_rate"] <= want["ci_high"]


def test_score_cli_matches_jax(pair, capsys):
    argv = ["--ref", str(pair / "ref"), "--hyp", str(pair / "hyp"),
            "--per-utt", "--bootstrap", "200"]
    assert score_cli.read_trn(str(pair / "hyp")) == jax_score.read_trn(
        str(pair / "hyp"))
    assert score_cli.score_files(str(pair / "ref"), str(pair / "hyp"),
                                 per_utt=True, bootstrap=200) == (
        jax_score.score_files(str(pair / "ref"), str(pair / "hyp"),
                              per_utt=True, bootstrap=200))
    printed, reports = [], []
    for main in (jax_score.main, score_cli.main):
        main(argv + ["--out", str(pair / "report.json")])
        printed.append(capsys.readouterr())
        reports.append(json.loads((pair / "report.json").read_text()))
    assert printed[0] == printed[1]
    assert "95% CI" in printed[1].out
    assert "1 refs without hyps, 1 hyps without refs" in printed[1].err
    assert reports[0] == reports[1]
    assert reports[1]["n_utts"] == 5 and len(reports[1]["per_utt"]) == 5


def test_strict_raises_as_jax(pair):
    argv = ["--ref", str(pair / "ref"), "--hyp", str(pair / "hyp"),
            "--strict"]
    messages = []
    for main in (jax_score.main, score_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        messages.append(str(exc.value))
    assert messages[0] == messages[1] == (
        "--strict: 1 refs without hyps, 1 hyps without refs")
