"""The port's paper-claim protocols, ``robust_e2e_gan_torch.tools.
adversarial_benefit`` and ``tools.lm_benefit``, against
``scripts/adversarial_benefit.py`` and ``scripts/lm_benefit.py`` on the
CPU: their constants equal the JAX scripts' field for field (read from
the scripts' source, which is not imported: it enables a JAX compile
cache at import), each tool draws the batches the JAX data module gives in
the script's order, and each tool's ``main`` at a tiny budget returns
finite error rates and every key of the script's summary."""

import ast
import dataclasses
import math
import os

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import synthetic as jax_synthetic  # noqa: E402
from robust_e2e_gan_tpu.models import lm as jax_lm  # noqa: E402
from robust_e2e_gan_torch import config  # noqa: E402
from robust_e2e_gan_torch.tools import (  # noqa: E402
    adversarial_benefit,
    lm_benefit,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
TOOLS = {"adversarial_benefit": adversarial_benefit, "lm_benefit": lm_benefit}
# what each tool adds to the JAX script's summary
EXTRA_KEYS = {"ms_per_step", "synthesis_seconds", "card", "device"}
# JAX config fields the port leaves out (test_torch_guards.py::LEFT_OUT),
# e.g. the reference scale's scan unrolling
LEFT_OUT = ("scan_unroll", "remat", "subsample_factor")


def _tree(name):
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        return ast.parse(f.read())


def _scope():
    return {**vars(jax_config), "hard_task": jax_synthetic.hard_task,
            "dataclasses": dataclasses, "LMConfig": jax_lm.LMConfig}


def _script_constants(name, names):
    """The module-level assignments and functions ``names`` of the JAX
    script, executed without the script's imports."""
    tree = _tree(name)
    nodes = [node for node in tree.body
             if (isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) in names)
             or (isinstance(node, ast.FunctionDef) and node.name in names)]
    scope = _scope()
    exec(compile(ast.Module(body=nodes, type_ignores=[]), name, "exec"),
         scope)
    return scope


def _calls(name, func):
    """Every call of ``func`` in the JAX script's source."""
    return [node for node in ast.walk(_tree(name))
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            == func]


def _port(cfg):
    """The port's config of a JAX config (the left-out fields dropped)."""
    return config.from_dict(getattr(config, type(cfg).__name__),
                            dataclasses.asdict(cfg))


def _without_left_out(tree):
    if isinstance(tree, dict):
        return {k: _without_left_out(v) for k, v in tree.items()
                if k not in LEFT_OUT}
    return tree


def test_adversarial_benefit_constants_match_the_jax_script():
    want = _script_constants("adversarial_benefit",
                             ("SCFG", "VOCAB", "jcfg_for", "TCFG", "PAD_TO"))
    ab = adversarial_benefit
    assert dataclasses.asdict(ab.SCFG) == dataclasses.asdict(want["SCFG"])
    assert (ab.VOCAB, ab.PAD_TO) == (want["VOCAB"], want["PAD_TO"])
    assert _port(want["TCFG"]) == ab.TCFG
    for scale in ("toy", "reference"):
        theirs = want["jcfg_for"](scale)
        assert _port(theirs) == ab.jcfg_for(scale), scale
        # nothing but the left-out fields is lost on the way
        assert dataclasses.asdict(ab.jcfg_for(scale)) == _without_left_out(
            dataclasses.asdict(theirs))
    # the cascade's stage-(b) loss weights (inside the script's main)
    (call,) = [c for c in _calls("adversarial_benefit", "replace")
               if {k.arg for k in c.keywords} == {"lambda_adv", "mu_enh"}]
    assert {k.arg: ast.literal_eval(k.value) for k in call.keywords} == (
        ab.CASCADE_WEIGHTS)
    jcfg = ab.jcfg_for("toy")
    assert ab.jcfg_cascade(jcfg) == dataclasses.replace(
        jcfg, **ab.CASCADE_WEIGHTS)


def test_lm_benefit_constants_match_the_jax_script():
    want = _script_constants("lm_benefit", ("SCFG", "VOCAB", "JCFG"))
    assert dataclasses.asdict(lm_benefit.SCFG) == dataclasses.asdict(
        want["SCFG"])
    assert lm_benefit.VOCAB == want["VOCAB"]
    assert _port(want["JCFG"]) == lm_benefit.JCFG
    assert dataclasses.asdict(lm_benefit.JCFG) == _without_left_out(
        dataclasses.asdict(want["JCFG"]))


@pytest.mark.parametrize("name", list(TOOLS))
def test_lm_and_beam_configs_match_the_jax_script(name):
    """The LMs' ``LMConfig`` (adversarial_benefit.py:161, lm_benefit.py:96)
    and the decodes' beam configs at each LM weight."""
    tool = TOOLS[name]
    scope = {**_scope(), "VOCAB": tool.VOCAB,
             "SCFG": jax_synthetic.hard_task(32)}
    (lm_call,) = _calls(name, "LMConfig")
    theirs = eval(compile(ast.Expression(lm_call), name, "eval"), scope)
    assert dataclasses.asdict(tool.LM_CFG) == dataclasses.asdict(theirs)
    (beam_call,) = _calls(name, "BeamSearchConfig")
    for w in (0.0, 0.2, 0.3, 0.4):
        theirs = eval(compile(ast.Expression(beam_call), name, "eval"),
                      {**scope, "lm_weight": w, "beta": w})
        assert adversarial_benefit.beam_config(tool.SCFG, w) == _port(theirs)


def _summary_keys(name):
    """The keys of the JAX script's summary: its dict literal and every
    key assigned after it."""
    keys = set()
    for node in ast.walk(_tree(name)):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "summary"):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "summary"):
            keys.add(node.targets[0].slice.value)
    return keys


def _jax_stream(name, seed, bs, steps_a, steps_c, eval_utts, lm_steps,
                route_batches):
    """What the JAX script draws, in the order the tool draws it:
    ("batch", batch) and ("transcript", tokens) items."""
    J = jax_synthetic
    if name == "adversarial_benefit":
        scfg = J.hard_task(vocab_size=32)
        train_bs, lm_bs, n_train = bs, 64, 1 + steps_a
    else:
        scfg = dataclasses.replace(J.hard_task(vocab_size=32),
                                   lexicon_size=50)
        train_bs, lm_bs, n_train = 16, 32, 1 + steps_a
    rng = np.random.default_rng(seed)

    def batches(n, b, r):
        return [("batch", J.make_batch(b, scfg, r,
                                       pad_to_samples=scfg.max_samples,
                                       ignore_id=-1)) for _ in range(n)]

    def transcripts(n, r):
        return [("transcript", J.sample_transcript(scfg, r))
                for _ in range(n)]

    out = batches(n_train, train_bs, rng)
    eval_rng = np.random.default_rng(999)
    if name == "adversarial_benefit":
        out += batches(1, eval_utts, eval_rng)
        out += batches(3 * steps_c, train_bs, rng)
        out += transcripts(lm_steps * lm_bs, rng)
        out += batches(route_batches, bs, eval_rng)
    else:
        out += transcripts(lm_steps * lm_bs, np.random.default_rng(1))
        out += batches(1, eval_utts, eval_rng)
    return out


@pytest.fixture(scope="module")
def tiny_runs():
    """Each tool's ``main(device="cpu")`` at a tiny budget on one thread,
    with what it drew: (summary, [(kind, value), ...]) by tool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for name, kw in (
                ("adversarial_benefit", dict(
                    steps_a=1, steps_c=1, with_lm=True, bs=2, eval_utts=2,
                    seed=1, lm_steps=1, route_batches=1)),
                ("adversarial_benefit_no_lm", dict(
                    steps_a=1, steps_c=0, bs=2, eval_utts=2, seed=2,
                    route_batches=1)),
                ("lm_benefit", dict(asr_steps=1, lm_steps=1))):
            tool = TOOLS[name.replace("_no_lm", "")]
            drawn = []
            ab = adversarial_benefit
            make_batch, sample_transcript = ab.make_batch, ab.sample_transcript

            def record_batch(*a, **k):
                drawn.append(("batch", make_batch(*a, **k)))
                return drawn[-1][1]

            def record_transcript(*a, **k):
                drawn.append(("transcript", sample_transcript(*a, **k)))
                return drawn[-1][1]

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(lm_benefit, "EVAL_UTTS", 2)  # the script's 64
                mp.setattr(ab, "make_batch", record_batch)
                mp.setattr(ab, "sample_transcript", record_transcript)
                summary = tool.main(device="cpu", check_claim=False, **kw)
            runs[name] = (summary, drawn, kw)
    finally:
        torch.set_num_threads(n)
    return runs


def _assert_same_stream(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for i, ((kind, g), (_, w)) in enumerate(zip(got, want)):
        if kind == "transcript":
            np.testing.assert_array_equal(g, w, err_msg=str(i))
            continue
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg=f"{i} {key}")


@pytest.mark.parametrize("run", ["adversarial_benefit",
                                 "adversarial_benefit_no_lm", "lm_benefit"])
def test_tool_draws_the_jax_scripts_batches(tiny_runs, run):
    _, drawn, kw = tiny_runs[run]
    name = run.replace("_no_lm", "")
    with_lm = name == "lm_benefit" or kw.get("with_lm", False)
    want = _jax_stream(
        name, kw.get("seed", 0), kw.get("bs", 16),
        kw.get("steps_a", kw.get("asr_steps")), kw.get("steps_c", 0),
        kw.get("eval_utts", 2), kw["lm_steps"] if with_lm else 0,
        kw.get("route_batches", 0))
    _assert_same_stream(drawn, want)


@pytest.mark.parametrize("run", ["adversarial_benefit",
                                 "adversarial_benefit_no_lm", "lm_benefit"])
def test_tool_main_on_the_cpu(tiny_runs, run):
    summary, _, kw = tiny_runs[run]
    name = run.replace("_no_lm", "")
    keys = _summary_keys(name)
    if not kw.get("with_lm", name == "lm_benefit"):
        keys -= {"noisy_wer_joint_plus_lm", "lm_ppl"}
    assert keys | EXTRA_KEYS <= set(summary)
    assert summary["synthesis_seconds"] > 0 and summary["card"] is None
    # a stage that took no step (steps_c=0) has no rate
    rates = summary["ms_per_step"]
    assert [k for k, v in rates.items() if v is None] == (
        ["gan_pretrain", "joint"] if kw.get("steps_c") == 0 else [])
    assert all(math.isfinite(v) and v >= 0
               for v in rates.values() if v is not None)
    if name == "lm_benefit":
        assert set(summary["results"]) == {
            f"lm_weight_{w}" for w in lm_benefit.LM_WEIGHTS}
        rates = [v for r in summary["results"].values() for v in r.values()]
    else:
        assert {"routes", "wer_ci95"} <= set(summary)
        assert set(summary["routes"]) == {"default", "fused step",
                                          "pallas prefix", "blstm row_tiled",
                                          "blstm cluster"}
        assert all(r["n"] == kw["bs"] * kw["route_batches"]
                   for r in summary["routes"].values())
        rates = adversarial_benefit.finite_wers(summary) + [
            r["wer"] for r in summary["routes"].values()]
        assert summary["eval_set"]["utterances"] == kw["eval_utts"]
    assert rates and all(math.isfinite(r) for r in rates)
