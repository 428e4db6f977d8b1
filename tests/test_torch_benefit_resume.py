"""The resume of ``robust_e2e_gan_torch.tools.adversarial_benefit``
(``--ckpt-dir``, ``--save-every``), its seed summary
``tools/summarize_seeds.py`` and the route gates' plan fit, against
``scripts/adversarial_benefit.py`` and ``scripts/summarize_seeds.py`` on
the CPU: a toy run cut inside stage (b) and run again ends bit-equal to
the uncut run, with the same rates and the decoded stage reused; other
run args, a corrupt sidecar and a JAX checkpoint are handled as the JAX
script handles them; the stream after a skip is the JAX script's; the
summary's statistics are the JAX script's on the JAX record."""

import ast
import glob
import json
import os
import shutil
import sys

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.data import synthetic as jax_synthetic  # noqa: E402
from robust_e2e_gan_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from robust_e2e_gan_torch.ops import blstm  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402
from robust_e2e_gan_torch.tools import (  # noqa: E402
    adversarial_benefit as ab,
    summarize_seeds,
    verify_drive as vd,
)
from robust_e2e_gan_torch.utils import checkpoint as ckpt  # noqa: E402
from robust_e2e_gan_torch.utils.impl import SMEM_LIMIT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import summarize_seeds as jax_summarize  # noqa: E402

# 2 + 2 x 2 + 2 = 8 global steps, saved after steps 4 and 8; the cut
# comes before global step 5 of stage (b) (global steps 2-5)
RUN = dict(steps_a=2, steps_c=2, bs=2, eval_utts=2, route_batches=1, seed=1,
           save_every=4, device="cpu", check_claim=False)
CUT = 5
LAST = 8
RATES = ("noisy_wer_no_enhancement", "noisy_wer_cascade_enhancement",
         "noisy_wer_joint_adversarial", "token_error_rates", "wer_ci95")
STAGES = ["noisy_raw", "cascade", "joint"]


class Cut(Exception):
    pass


def _run(ckpt_dir, cut=None, **kw):
    """``main`` with ``RUN`` into ``ckpt_dir`` on one thread; (summary or
    None where cut, {global step: the noisy waveforms it trained on},
    decodes run)."""
    seen, decodes = {}, []

    def hook(gstep, batch, state):
        if gstep == cut:
            raise Cut
        seen[gstep] = batch["noisy_wav"].copy()

    decode_wer = ab.decode_wer

    def counted(*a, **k):
        decodes.append(a[3])
        return decode_wer(*a, **k)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ab, "decode_wer", counted)
            out = ab.main(ckpt_dir=str(ckpt_dir), step_hook=hook,
                          **{**RUN, **kw})
    except Cut:
        out = None
    finally:
        torch.set_num_threads(n)
    return out, seen, decodes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uncut run, then a run cut before global step ``CUT`` and the
    same run again, each into its own checkpoint dir."""
    root = tmp_path_factory.mktemp("benefit_resume")
    uncut = _run(root / "uncut")
    cut = _run(root / "cut", cut=CUT)
    resumed = _run(root / "cut")
    return {"root": root, "uncut": uncut, "cut": cut, "resumed": resumed}


def _state(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                      weights_only=True)


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_cut_and_resumed_run_equals_the_uncut_run(runs):
    uncut, _, _ = runs["uncut"]
    cut, cut_seen, _ = runs["cut"]
    resumed, seen, decodes = runs["resumed"]
    assert cut is None and max(cut_seen) == CUT - 1
    root = runs["root"]
    # the resumed run saved global step 7 last
    assert ckpt.read_extra(root / "cut")["global_step"] == LAST - 1
    # every parameter, optimizer moment and generator of the last save
    _assert_equal_trees(_state(root / "uncut", LAST),
                        _state(root / "cut", LAST))
    for key in RATES:
        assert resumed[key] == uncut[key], key
    assert resumed["routes"] == uncut["routes"]
    # the resumed run took global steps 4-7 on the uncut run's batches
    assert sorted(seen) == list(range(RUN["save_every"], LAST))
    for g, wav in seen.items():
        np.testing.assert_array_equal(wav, runs["uncut"][1][g], str(g))
    # the no-enhancement decode came from the sidecar
    assert resumed["resume"]["stages_reused"] == ["noisy_raw"]
    assert decodes == [True, True]  # the cascade and joint decodes
    assert resumed["resume"]["restored_global_step"] == RUN["save_every"] - 1
    assert resumed["resume"]["steps_run"] == {"asr": 0, "gan": 2, "joint": 2}
    assert uncut["resume"]["steps_run"] == {"asr": 2, "gan": 4, "joint": 2}
    # a stage that the resume skipped whole has no rate
    assert resumed["ms_per_step"]["asr_pretrain"] is None
    assert all(np.isfinite(v) for k, v in resumed["ms_per_step"].items()
               if k != "asr_pretrain")


@pytest.mark.parametrize("sidecar", ["intact", "corrupt"])
def test_finished_run_reuses_or_redecodes_its_stages(runs, tmp_path,
                                                     sidecar):
    """A run restarted after its last save trains nothing; it reuses the
    sidecar's stages (the same rates), or, where the sidecar is corrupt,
    decodes every stage again from the restored state, as the JAX script
    does: the joint stage, decoded from that state in both runs, keeps
    its rates."""
    d = tmp_path / "run"
    shutil.copytree(runs["root"] / "uncut", d)
    if sidecar == "corrupt":
        with open(d / ab.PARTIAL, "w") as f:
            f.write('{"noisy_raw": {"ter": 0.')
    out, seen, decodes = _run(d)
    assert not seen
    # no stage ran a step, so none has a rate
    assert out["ms_per_step"] == dict.fromkeys(
        ("asr_pretrain", "gan_pretrain", "joint"))
    uncut = runs["uncut"][0]
    keys = RATES if sidecar == "intact" else (
        "noisy_wer_joint_adversarial",)
    for key in keys:
        assert out[key] == uncut[key], key
    assert (out["token_error_rates"]["joint"]
            == uncut["token_error_rates"]["joint"])
    want = STAGES if sidecar == "intact" else []
    assert out["resume"]["stages_reused"] == want
    assert decodes == [False, True, True][:3 - len(want)]
    with open(d / ab.PARTIAL) as f:
        assert sorted(json.load(f)) == sorted(STAGES)


@pytest.mark.parametrize("key,value", [("lr", 3e-4), ("seed", 2),
                                       ("eval_utts", 3)])
def test_changed_run_args_are_refused(runs, tmp_path, key, value):
    d = tmp_path / "run"
    shutil.copytree(runs["root"] / "uncut", d)
    with pytest.raises(SystemExit, match=f"'{key}'") as exc:
        _run(d, **{key: value})
    assert str(exc.value).startswith("[resume] relaunch args differ")


def test_jax_checkpoint_dir_is_refused(tmp_path):
    """The JAX script's own checkpoint dir (``ckpt_<step>.msgpack`` with
    its extra) of the same run args."""
    run_args = {k: RUN[k] for k in ("bs", "steps_a", "steps_c",
                                    "eval_utts", "seed")}
    run_args.update(scale="toy", lr=1e-3, warmup=0, optimizer="adam")
    rng = np.random.default_rng(RUN["seed"])
    jax_checkpoint.save_checkpoint(
        str(tmp_path), {"step": np.asarray(4, np.int32)}, 4, keep=1,
        extra={"global_step": 3, "run_args": run_args,
               "rng_state": rng.bit_generator.state})
    with pytest.raises(NotImplementedError) as exc:
        _run(tmp_path)
    assert str(exc.value) == ckpt.JAX_RESUME


def _jax_batches():
    """The JAX script's ``batches``, executed from its source with the JAX
    data module (the script itself is not imported: it enables a JAX
    compile cache at import)."""
    import jax.numpy as jnp

    with open(os.path.join(ROOT, "scripts", "adversarial_benefit.py")) as f:
        tree = ast.parse(f.read())
    nodes = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "batches"]
    scfg = jax_synthetic.hard_task(vocab_size=32)
    scope = {"make_batch": jax_synthetic.make_batch, "SCFG": scfg,
             "PAD_TO": scfg.max_samples, "jnp": jnp}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), "batches", "exec"),
         scope)
    return scope["batches"]


@pytest.mark.parametrize("restored", [False, True])
def test_stream_skip_matches_the_jax_scripts_batches(restored):
    """``Stream.batches(skip_first=k)`` yields the JAX script's batches
    after its first k: by making the skipped batches again, or, from a
    restored generator state, without them."""
    n, k, bs, seed = 4, 2, 2, 3
    want = list(_jax_batches()(np.random.default_rng(seed), n, bs=bs,
                               skip_first=k))
    rng = np.random.default_rng(seed)
    if restored:  # the state a checkpoint after k batches recorded
        ahead = np.random.default_rng(seed)
        for _ in range(k):
            ab.Stream(ab.SCFG).batch(bs, ahead)
        rng.bit_generator.state = ahead.bit_generator.state
    stream = ab.Stream(ab.SCFG)
    got = list(stream.batches(n, bs, rng, skip_first=k,
                              synth_skipped=not restored))
    assert [g is None for g in got] == [w is None for w in want] == (
        [True] * k + [False] * (n - k))
    for g, w in zip(got[k:], want[k:]):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], np.asarray(w[key]), key)
    assert stream.seconds > 0


# an H100 SXM: 132 SMs, sm_90's opt-in shared memory, and the clusters
# the runtime places at once, one block an SM, whatever the block's shared
# memory (15 of 8 blocks and 7 of 16, as the card answered; an SM count's
# worth below)
H100 = (132, SMEM_LIMIT,
        lambda c, smem: {8: 15, 16: 7}.get(c, 132 // c))


@pytest.mark.parametrize("scale,b,routes,misfit", [
    ("toy", 16, ["cluster"] * 3, None),
    ("drive", 16, ["cluster"] * 2, None),
    ("reference", 32, ["cluster"] * 5, None),
])
def test_route_gates_ask_the_cluster_plan(scale, b, routes, misfit):
    """Which ``blstm_infer`` route each inference BLSTM layer takes on an
    H100 (``ops/blstm.py::infer_route``, the wrapper's rule) and whether
    the forced cluster route is run: at H = 512 (the reference scale)
    clusters of 16 blocks of 32 units take every layer."""
    jcfg = vd.JCFG if scale == "drive" else ab.jcfg_for(scale)
    model = build_model(vd.bf16_config(vd.kernel_config(jcfg)))
    layers = vd.infer_layers(model, b)
    fits = [blstm.infer_route(b, d, h, torch.finfo(dt).bits // 8, *H100)
            is not None for d, h, dt in layers]
    assert ["cluster" if f else "row_tiled" for f in fits] == routes
    assert vd.route_misfit("blstm cluster", layers, fits, b) == misfit
    for name in ("fused step", "pallas prefix", "blstm row_tiled"):
        assert vd.route_misfit(name, layers, fits, b) is None
    # on the CPU no plan is asked: every route runs its plain versions
    assert vd.cluster_fits(layers, b, torch.device("cpu")) is None
    assert vd.route_misfit("blstm cluster", layers, None, b) is None


def test_route_gates_report_a_route_that_does_not_fit(monkeypatch):
    """``route_gates`` where the cluster plan fits no layer (the card's
    answer stood in for on the CPU): the cluster route is reported as not
    run with the plan's reason, every other route runs."""
    jcfg = vd.kernel_config(ab.jcfg_for("toy"))
    model = build_model(jcfg)
    stream = ab.Stream(ab.SCFG)
    batches = [stream.batch(2, np.random.default_rng(5))]
    monkeypatch.setattr(vd, "cluster_fits",
                        lambda layers, b, dev: [False] * len(layers))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = vd.route_gates(jcfg, model.state_dict(), batches,
                             torch.device("cpu"),
                             bcfg=ab.beam_config(ab.SCFG))
    finally:
        torch.set_num_threads(n)
    assert out["blstm cluster"] == {
        "not_run": "ops/blstm.py::cluster_plan does not fit H=96, 128 at B=2"}
    assert set(out) == {"default", *vd.ROUTES}
    assert all(out[k]["n"] == 2 for k in out if k != "blstm cluster")


def _jax_records():
    res = os.path.join(ROOT, "results")
    return {
        "toy": jax_summarize._collect(
            os.path.join(res, "adversarial_benefit_seed*.json"),
            os.path.join(res, "adversarial_benefit.json")),
        "adadelta": [jax_summarize._load(
            os.path.join(res, "adversarial_benefit_adadelta.json"))],
        "reference": jax_summarize._collect(
            os.path.join(res, "adversarial_benefit_reference_seed*.json"),
            os.path.join(res, "adversarial_benefit_reference.json")),
    }


@pytest.mark.parametrize("group", ["toy", "adadelta", "reference"])
def test_summarize_seeds_stats_equal_the_jax_scripts(group):
    runs = _jax_records()[group]
    assert runs and all(r is not None for r in runs)
    assert summarize_seeds._stats(runs) == jax_summarize._stats(runs)


def test_summarize_seeds_main_on_the_ports_records(tmp_path):
    """``main`` over a copy of the port's records: the toy seeds of
    ``results/torch_h100`` and the JAX record's reference runs renamed as
    the port names them, summarised as the JAX script summarises them."""
    for p in glob.glob(os.path.join(summarize_seeds.RESULTS,
                                    "adversarial_benefit_seed*.json")):
        shutil.copy(p, tmp_path)
    ref = _jax_records()["reference"]
    for i, r in enumerate(ref):
        with open(tmp_path / f"adversarial_benefit_reference_seed{i}.json",
                  "w") as f:
            json.dump(r, f)
    out = summarize_seeds.main(str(tmp_path))
    toy = [jax_summarize._load(p) for p in sorted(glob.glob(os.path.join(
        summarize_seeds.RESULTS, "adversarial_benefit_seed*.json")))]
    assert out == {"toy_scale": jax_summarize._stats(toy),
                   "toy_scale_adadelta": None,
                   "reference_scale": jax_summarize._stats(ref)}
    with open(tmp_path / summarize_seeds.SUMMARY) as f:
        assert json.load(f) == out
