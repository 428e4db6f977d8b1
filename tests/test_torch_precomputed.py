"""The port's Kaldi sources and precomputed features against the JAX
package's on the CPU, at toy widths: the Kaldi datasets (waveform scp,
feats.scp with and without ``utt2num_frames`` and an index cache, a
CM-compressed ark, paired spectra) and their ``BucketBatcher`` batches
with speaker-CMVN stats, equal; the pipeline's entry points on
precomputed features and spectra (log domain included) and the waveform
ones with per-speaker CMVN, at rtol 1e-4 / atol 1e-5; one training step
of each precomputed input kind, parameters at atol 1e-6; the beam
searcher on features and on spectra with speaker CMVN, token-exact;
``train.cli``'s Kaldi batches, ``config.json`` and refusals against the
JAX CLI's; and short training runs on each Kaldi source that decode
through ``decode.cli``."""

import dataclasses
import json
import os

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import cmvn as jax_cmvn  # noqa: E402
from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_tpu.decode.beam import (  # noqa: E402
    make_beam_searcher as jax_make_beam_searcher,
)
from robust_e2e_gan_tpu.models.enhancement import (  # noqa: E402
    Discriminator as JaxDiscriminator,
)
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_tpu.train import cli as jax_train_cli  # noqa: E402
from robust_e2e_gan_tpu.train import loop as jax_loop  # noqa: E402
from robust_e2e_gan_tpu.train import steps as jax_steps  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import (  # noqa: E402
    BeamSearchConfig,
    TrainConfig,
)
from robust_e2e_gan_torch.convert import (  # noqa: E402
    from_flax,
    init_params,
    to_flax,
)
from robust_e2e_gan_torch.data import cmvn, dataset, kaldi_io  # noqa: E402
from robust_e2e_gan_torch.data.cmvn_cli import compute_stats  # noqa: E402
from robust_e2e_gan_torch.data.featbin_cli import frontend  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    synth_utterance,
)
from robust_e2e_gan_torch.decode import cli as decode_cli  # noqa: E402
from robust_e2e_gan_torch.decode.beam import make_beam_searcher  # noqa: E402
from robust_e2e_gan_torch.models.enhancement import Discriminator  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402
from robust_e2e_gan_torch.train import cli as train_cli  # noqa: E402
from robust_e2e_gan_torch.train import loop, steps  # noqa: E402

ALPHABET = "abcdefghij"
N_UTTS = 6
N_MELS = 24
RTOL, ATOL = 1e-4, 1e-5
PARAM_ATOL = 1e-6
WAV_BUCKETS = "8000,16000"
FRAME_BUCKETS = "50,100"
TINY = ["--n-mels", "24", "--enc-layers", "1", "--enc-hidden", "32",
        "--enc-proj", "32", "--att-dim", "24", "--dec-hidden", "32",
        "--dec-embed", "16", "--enh-layers", "1", "--enh-hidden", "32",
        "--batch-size", "3", "--log-every", "1", "--device", "cpu"]


@pytest.fixture
def one_thread():
    """Tiny eager steps run on one thread: beside the suite's other
    workers, thread hand-offs would cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six synthetic utterances as a Kaldi recipe: noisy and clean wav.scp
    of (1, N) vectors, ``text``, ``utt2spk`` (two speakers),
    ``utt2num_samples``; their log-mel (24 mels, no CMVN) as a float
    feats.scp and a CM-compressed one with ``utt2num_frames``; their noisy
    and clean log power spectra; per-speaker and global CMVN arks of the
    log-mel. The clean speech is dithered: its silent stretches would put
    log-mel values at the log floor, where float32 sums in another order
    flip the discriminator's leaky-ReLU slopes."""
    root = tmp_path_factory.mktemp("kaldi")
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(11)
    noisy, clean, texts = {}, {}, {}
    for i in range(N_UTTS):
        toks = rng.integers(2, 12, size=(int(rng.integers(2, 5)),))
        c, n = synth_utterance(toks.astype(np.int32), scfg, rng)
        key = f"u{i}"
        noisy[key] = n
        clean[key] = c + (0.1 * rng.standard_normal(len(c))).astype(
            np.float32)
        texts[key] = "".join(ALPHABET[t - 2] for t in toks)
    p = {k: str(root / k) for k in (
        "wav.scp", "clean_wav.scp", "text", "utt2spk", "utt2num_samples",
        "feats.scp", "feats_cm.scp", "utt2num_frames", "spec.scp",
        "clean_spec.scp", "spk_cmvn.ark", "cmvn.ark")}
    for name, wavs in (("wav", noisy), ("clean_wav", clean)):
        kaldi_io.write_ark_scp(((k, v[None]) for k, v in wavs.items()),
                               str(root / f"{name}.ark"), p[f"{name}.scp"])

    def write_map(name, values):
        with open(p[name], "w") as f:
            f.writelines(f"{k} {v}\n" for k, v in values.items())

    write_map("text", texts)
    utt2spk = {k: f"s{i % 2}" for i, k in enumerate(noisy)}
    write_map("utt2spk", utt2spk)
    write_map("utt2num_samples", {k: len(v) for k, v in noisy.items()})

    cfg = configs.tiny_config().e2e.frontend

    def extract(wavs, kind):
        out = {}
        for k, v in wavs.items():
            f, m = frontend(torch.from_numpy(v[None]),
                            torch.tensor([len(v)]), cfg, kind)
            out[k] = f[0][m[0] > 0].numpy()
        return out

    mel = extract(noisy, "fbank")
    kaldi_io.write_ark_scp(iter(mel.items()), str(root / "feats.ark"),
                           p["feats.scp"])
    kaldi_io.write_ark_scp(iter(mel.items()), str(root / "feats_cm.ark"),
                           p["feats_cm.scp"], compress=1)
    write_map("utt2num_frames", {k: len(v) for k, v in mel.items()})
    for name, wavs in (("spec", noisy), ("clean_spec", clean)):
        kaldi_io.write_ark_scp(iter(extract(wavs, "spectrogram").items()),
                               str(root / f"{name}.ark"), p[f"{name}.scp"])
    with open(p["spk_cmvn.ark"], "wb") as f:
        for spk, st in compute_stats(iter(mel.items()), utt2spk).items():
            kaldi_io.write_mat(f, spk, st)
    cmvn.save_cmvn_ark(compute_stats(iter(mel.items()))["global"],
                       p["cmvn.ark"])
    return {"root": root, "paths": p, "texts": texts, "utt2spk": utt2spk}


# ---------------------------------------------------------------------------
# datasets and batches
# ---------------------------------------------------------------------------

# name -> (builder of either package's dataset, batcher buckets)
DATASETS = {
    "wav": (lambda m, p, c: m.AudioTextDataset.from_kaldi(
        p["wav.scp"], p["text"], p["clean_wav.scp"]), WAV_BUCKETS),
    "wav_lengths": (lambda m, p, c: m.AudioTextDataset.from_kaldi(
        p["wav.scp"], p["text"], lengths_path=p["utt2num_samples"]),
        WAV_BUCKETS),
    "wav_index_cache": (lambda m, p, c: m.AudioTextDataset.from_kaldi(
        p["wav.scp"], p["text"], index_cache=c), WAV_BUCKETS),
    "feats": (lambda m, p, c: m.AudioTextDataset.from_kaldi_feats(
        p["feats.scp"], p["text"]), FRAME_BUCKETS),
    "feats_utt2num_frames": (lambda m, p, c: m.AudioTextDataset
                             .from_kaldi_feats(
                                 p["feats.scp"], p["text"],
                                 utt2num_frames=p["utt2num_frames"]),
                             FRAME_BUCKETS),
    "feats_index_cache": (lambda m, p, c: m.AudioTextDataset.from_kaldi_feats(
        p["feats.scp"], p["text"], index_cache=c), FRAME_BUCKETS),
    "feats_compressed": (lambda m, p, c: m.AudioTextDataset.from_kaldi_feats(
        p["feats_cm.scp"], p["text"], index_cache=c), FRAME_BUCKETS),
    "spec_pair": (lambda m, p, c: m.AudioTextDataset.from_kaldi_feats(
        p["spec.scp"], p["text"], clean_scp=p["clean_spec.scp"]),
        FRAME_BUCKETS),
}
# the port's numpy reader against the JAX package's numpy path
DATASETS["feats_compressed_plain"] = DATASETS["feats_compressed"]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["utt_ids"] == w["utt_ids"]
        for k in g:
            if k != "utt_ids":
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", list(DATASETS))
def test_kaldi_datasets_and_batches_match_jax(corpus, tmp_path, monkeypatch,
                                              name):
    """Either package's dataset and batches of each source, equal: the
    feature batches read by both packages' C++ readers, and in the
    ``_plain`` case by the port's numpy reader and the JAX package's numpy
    path."""
    from robust_e2e_gan_tpu.utils import native as jax_native

    build, buckets = DATASETS[name]
    p = corpus["paths"]
    if name.endswith("_plain"):
        monkeypatch.setattr(jax_native, "native_load_kaldi_feats_batch",
                            lambda *a, **kw: None)
        monkeypatch.setattr(dataset, "_plain_collation", True)
    else:
        assert jax_native.get_lib() is not None  # its reader, not numpy
    cache = {t: str(tmp_path / f"{t}.json") for t in ("port", "jax")}
    got = build(dataset, p, cache["port"])
    want = build(jax_dataset, p, cache["jax"])
    assert [dataclasses.astuple(u) for u in got.utts] == [
        dataclasses.astuple(u) for u in want.utts]
    assert got.tokenizer.chars == want.tokenizer.chars
    if "index_cache" in name or name == "feats_compressed":
        # one cache each, the same lengths under the same fingerprint; a
        # rebuild from the other package's cache probes no ark header
        with open(cache["port"]) as a, open(cache["jax"]) as b:
            assert json.load(a) == json.load(b)

        def no_probe(*a):
            raise AssertionError("probed an ark header")

        monkeypatch.setattr(dataset, "_probe_shape", no_probe)
        again = build(dataset, p, cache["jax"])
        assert [u.n_samples for u in again.utts] == [
            u.n_samples for u in got.utts]

    buckets = tuple(int(x) for x in buckets.split(","))
    spk = {m: m.SpeakerCmvn.load(p["spk_cmvn.ark"], p["utt2spk"])
           for m in (cmvn, jax_cmvn)}
    for pad_final, speaker in ((False, None), (True, "speaker")):
        batchers = [
            m.BucketBatcher(ds, 4, buckets, max_label_len=3, seed=2,
                            pad_final=pad_final,
                            speaker_cmvn=spk[c] if speaker else None)
            for m, ds, c in ((dataset, got, cmvn),
                             (jax_dataset, want, jax_cmvn))]
        for shuffle in (True, True, False):  # each epoch reshuffles
            _assert_batches_equal(list(batchers[0].epoch(shuffle)),
                                  list(batchers[1].epoch(shuffle)))
    batch = next(batchers[0].epoch(False))
    keys = {"feats", "feat_lengths"} if "feats" in name or "spec" in name \
        else {"noisy_wav", "clean_wav", "wav_lengths"}
    assert keys | {"labels", "utt_ids", "cmvn_mean", "cmvn_inv_std"} <= set(
        batch)
    assert ("clean_feats" in batch) == (name == "spec_pair")


# ---------------------------------------------------------------------------
# the pipeline's entry points
# ---------------------------------------------------------------------------


def _batch(corpus, kind, n=3):
    """The first ``n`` utterances as one batch of ``kind`` ("wav",
    "feats" or "spec"), with their speakers' CMVN stats."""
    p = corpus["paths"]
    if kind == "wav":
        ds = dataset.AudioTextDataset.from_kaldi(
            p["wav.scp"], p["text"], p["clean_wav.scp"],
            lengths_path=p["utt2num_samples"])
        buckets = (16000,)
    else:
        ds = dataset.AudioTextDataset.from_kaldi_feats(
            p["feats.scp" if kind == "feats" else "spec.scp"], p["text"],
            utt2num_frames=p["utt2num_frames"],
            clean_scp=p["clean_spec.scp"] if kind == "spec" else None)
        buckets = (100,)
    spk = cmvn.SpeakerCmvn.load(p["spk_cmvn.ark"], p["utt2spk"])
    batcher = dataset.BucketBatcher(ds, n, buckets, max_label_len=5,
                                    speaker_cmvn=spk)
    return next(batcher.epoch(shuffle=False))


def _global_stats(corpus):
    return cmvn.stats_to_mean_inv_std(
        cmvn.load_cmvn_ark(corpus["paths"]["cmvn.ark"]))


def _cfg(mode="utterance", lstm="auto"):
    jcfg = configs.tiny_config()
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(
            e2e, frontend=dataclasses.replace(e2e.frontend, cmvn=mode),
            encoder=dataclasses.replace(e2e.encoder, lstm_impl=lstm)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl=lstm))


# name -> (input kind, cmvn mode, JAX method name, its arguments from a
# batch, keyword arguments)
ENTRY_POINTS = {
    "asr_forward_feats": ("feats", "speaker", "asr_forward_feats",
                          ("feats", "feat_lengths", "labels"), {}),
    "encode_for_decode_feats": ("feats", "global", "encode_for_decode_feats",
                                ("feats", "feat_lengths"), {}),
    "joint_forward_spec_log": ("spec", "speaker", "joint_forward_spec",
                               ("feats", "clean_feats", "feat_lengths",
                                "labels"), {"log_domain": True}),
    "asr_forward_spec_linear": ("spec", "utterance", "asr_forward_spec",
                                ("linear", "feat_lengths", "labels"),
                                {"use_enhancer": True}),
    "encode_for_decode_spec_log": ("spec", "none", "encode_for_decode_spec",
                                   ("feats", "feat_lengths"),
                                   {"log_domain": True}),
    "asr_forward_speaker": ("wav", "speaker", "asr_forward",
                            ("noisy_wav", "wav_lengths", "labels"),
                            {"use_enhancer": True}),
    "joint_forward_speaker": ("wav", "speaker", "joint_forward",
                              ("noisy_wav", "clean_wav", "wav_lengths",
                               "labels"), {}),
    "encode_for_decode_speaker": ("wav", "speaker", "encode_for_decode",
                                  ("noisy_wav", "wav_lengths"), {}),
}


def _close(got, want, name):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_pipeline_entry_points_match_jax(corpus, name):
    kind, mode, method, arg_keys, kw = ENTRY_POINTS[name]
    batch = _batch(corpus, kind)
    batch["linear"] = np.exp(batch["feats"]) if kind == "spec" else None
    stats = _global_stats(corpus) if mode == "global" else None
    jcfg = _cfg(mode)
    params = init_params(jcfg, 5)
    cmvn_batch = (batch["cmvn_mean"], batch["cmvn_inv_std"])
    if mode != "speaker":
        cmvn_batch = None

    jmodel = JaxRobustE2E(_jax(jcfg), cmvn_stats=stats)
    want = jmodel.apply(
        {"params": params}, *(jnp.asarray(batch[k]) for k in arg_keys),
        cmvn_batch=None if cmvn_batch is None else tuple(
            jnp.asarray(x) for x in cmvn_batch),
        method=getattr(JaxRobustE2E, method), **kw)

    model = build_model(jcfg, cmvn_stats=stats)
    model.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = getattr(model, method)(
            *(torch.from_numpy(batch[k]) for k in arg_keys),
            cmvn_batch=None if cmvn_batch is None else tuple(
                torch.from_numpy(x) for x in cmvn_batch), **kw)
    if isinstance(want, dict):
        keys = [k for k in want if want[k] is not None]
        assert keys == [k for k in got if got[k] is not None]
        for k in keys:
            _close(torch.as_tensor(got[k]), want[k], k)
    else:  # (hs, hmask, hlens, ctc_logits, enc_proj)
        for k, g, w in zip(("hs", "hmask", "hlens", "ctc_logits",
                            "enc_proj"), got, want):
            _close(g, w, k)


def test_spectrogram_width_is_checked():
    model = build_model(_cfg())
    spec = torch.zeros(1, 5, 80)
    with pytest.raises(ValueError, match="n_fft//2\\+1 = 257"):
        model.encode_for_decode_spec(spec, torch.tensor([5]))
    with pytest.raises(ValueError, match='cmvn="speaker" needs'):
        build_model(_cfg("speaker")).encode_for_decode_feats(
            torch.zeros(1, 5, N_MELS), torch.tensor([5]))


# ---------------------------------------------------------------------------
# training steps and the searcher
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close_trees(got, want, before=None):
    """``got`` at ``want``; parameters the JAX tree lacks (the enhancer of
    a feats run, which the port's model always holds) at ``before``."""
    got, want = dict(_flat(got)), dict(_flat(want))
    for k in set(got) - set(want):
        assert k.startswith("enhancer."), k
        np.testing.assert_array_equal(got.pop(k), dict(_flat(before))[k])
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["feats", "spec"])
def test_train_step_matches_jax(corpus, kind, one_thread):
    """feats: the clean-ASR step and the dev eval on log-mel with speaker
    CMVN; spec: the joint step and the enhanced dev eval on log power
    spectra. One step from the same parameters, Adadelta."""
    batch = _batch(corpus, kind)
    if kind == "spec":
        batch.pop("cmvn_mean")  # utterance CMVN
        batch.pop("cmvn_inv_std")
    jcfg = _cfg("speaker" if kind == "feats" else "utterance")
    tcfg = TrainConfig()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "utt_ids"}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "utt_ids"}
    jjcfg = _jax(jcfg)
    jmodel = JaxRobustE2E(jjcfg)
    jstate, opt_g, opt_d = jax_steps.init_train_state(
        jmodel, JaxDiscriminator(jjcfg.discriminator), _jax(tcfg), jbatch,
        seed=0, input_kind=None if kind == "feats" else "spec",
        log_domain=True)
    model = build_model(jcfg)
    # a feats run's JAX tree has no enhancer: the port's keeps its draw
    full = from_flax(init_params(jcfg, 0))
    full.update(from_flax(jax.tree_util.tree_map(np.asarray,
                                                 jstate.params_g)))
    model.load_state_dict(full)
    before = to_flax(full)
    params_d = jax.tree_util.tree_map(np.asarray, jstate.params_d)
    disc = Discriminator(dataclasses.replace(
        jcfg.discriminator, input_dim=N_MELS))
    disc.load_state_dict(from_flax(params_d))
    state = steps.init_train_state(model, disc, tcfg)

    if kind == "feats":
        jeval = jax_steps.make_eval_step(jmodel, use_enhancer=False)
        ours = steps.make_eval_step(False, "feats")
        jstep = jax_steps.make_asr_pretrain_step(jmodel, opt_g)
        step = steps.make_asr_pretrain_step(input_kind="feats")
    else:
        jeval = jax_steps.make_eval_step(jmodel, True, "spec", True)
        ours = steps.make_eval_step(True, "spec", True)
        jstep = jax_steps.make_joint_train_step(
            jmodel, JaxDiscriminator(jjcfg.discriminator), jjcfg, opt_g,
            opt_d, input_kind="spec", log_domain=True)
        step = steps.make_joint_train_step(jcfg, input_kind="spec",
                                           log_domain=True)
    _close_metrics(ours(state.model, tbatch), jeval(jstate.params_g, jbatch))
    jstate, want = jstep(jstate, jbatch)
    _close_metrics(step(state, tbatch), want)
    _close_trees(to_flax(state.model.state_dict()), jstate.params_g, before)
    _close_trees(to_flax(state.discriminator.state_dict()), jstate.params_d)


@pytest.mark.parametrize("kind", ["feats", "spec"])
def test_beam_searcher_matches_jax(corpus, kind):
    """Speaker CMVN on both: the log-mel features straight into the
    encoder, the log spectra through the enhancer."""
    batch = _batch(corpus, kind)
    jcfg = _cfg("speaker")
    bcfg = BeamSearchConfig(beam_size=3, ctc_weight=0.3, max_steps=6,
                            early_exit=False)
    params = init_params(jcfg, 9)
    x, lens = batch["feats"], batch["feat_lengths"]
    cmvn_batch = (batch["cmvn_mean"], batch["cmvn_inv_std"])
    want = jax_make_beam_searcher(
        JaxRobustE2E(_jax(jcfg)), _jax(jcfg.e2e), _jax(bcfg),
        use_enhancer=True, input_kind=kind, log_domain=True)(
        params, jnp.asarray(x), jnp.asarray(lens),
        tuple(jnp.asarray(c) for c in cmvn_batch))
    model = build_model(jcfg)
    model.load_state_dict(from_flax(params))
    got = make_beam_searcher(model, jcfg.e2e, bcfg, use_enhancer=True,
                             input_kind=kind, log_domain=True)(
        torch.from_numpy(x), torch.from_numpy(lens),
        tuple(torch.from_numpy(c) for c in cmvn_batch))
    np.testing.assert_array_equal(got.beam_tokens.numpy(),
                                  np.asarray(want.beam_tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# train.cli
# ---------------------------------------------------------------------------

# name -> train.cli arguments (paths by corpus key) and the input kind
CLI_SOURCES = {
    "wav_speaker": (["--train-noisy-scp", "wav.scp", "--train-clean-scp",
                     "clean_wav.scp", "--cmvn", "speaker", "--cmvn-ark",
                     "spk_cmvn.ark", "--utt2spk", "utt2spk",
                     "--length-buckets", WAV_BUCKETS], "wav"),
    "wav_global_index_cache": (["--train-noisy-scp", "wav.scp", "--cmvn",
                                "global", "--cmvn-ark", "cmvn.ark",
                                "--length-buckets", WAV_BUCKETS,
                                "--index-cache", "@cache"], "wav"),
    "feats_compressed": (["--mode", "asr", "--train-feats-scp",
                          "feats_cm.scp", "--utt2num-frames",
                          "utt2num_frames", "--length-buckets",
                          FRAME_BUCKETS], "feats"),
    "log_spectra_joint": (["--train-feats-scp", "spec.scp", "--feats-kind",
                           "log-spectrogram", "--train-clean-feats-scp",
                           "clean_spec.scp", "--length-buckets",
                           FRAME_BUCKETS], "spec"),
}


def _cli_args(corpus, tmp_path, args, tag):
    p = corpus["paths"]
    out = ["--train-text", p["text"], "--batch-size", "2", "--seed", "3",
           "--max-label-len", "3", "--lstm-impl", "scan", "--ckpt-dir",
           str(tmp_path / tag)]
    for a in args:
        out.append(p.get(a, str(tmp_path / f"{tag}_cache.json")
                         if a == "@cache" else a))
    return out


@pytest.mark.parametrize("name", list(CLI_SOURCES))
def test_train_cli_kaldi_sources_match_jax(corpus, tmp_path, monkeypatch,
                                           name):
    """Both CLIs up to their training loop: the same train batches two
    epochs running, the same config.json (the port's fields), the same
    cmvn.ark in the run dir, and the same input kind and CMVN stats
    handed to the loop."""
    args, kind = CLI_SOURCES[name]
    captured = {}
    for tag, cli, mod, extra in (
            ("jax", jax_train_cli, jax_loop, []),
            ("port", train_cli, loop, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "train", lambda *a, _t=tag, **kw:
                            captured.__setitem__(_t, (a, kw)))
        cli.main(_cli_args(corpus, tmp_path, args, tag) + extra)
    (ja, jkw), (pa, pkw) = captured["jax"], captured["port"]
    assert pkw["input_kind"] == jkw["input_kind"] == kind
    assert pkw["log_domain"] == jkw["log_domain"] == (kind == "spec")
    if jkw["cmvn_stats"] is None:
        assert pkw["cmvn_stats"] is None
    else:
        for g, w in zip(pkw["cmvn_stats"], jkw["cmvn_stats"]):
            np.testing.assert_array_equal(g, w)
    for _ in range(2):
        _assert_batches_equal(list(pa[2]()), list(ja[2]()))

    def saved(tag):
        with open(tmp_path / tag / "config.json") as f:
            return json.load(f)

    got, want = saved("port"), saved("jax")
    assert set(got) == set(want) == {"joint", "train", "mode", "input_kind",
                                     "spec_log_domain"}
    for key in ("mode", "input_kind", "spec_log_domain"):
        assert got[key] == want[key], key
    for tag, train in (("port", got["train"]), ("jax", want["train"])):
        assert train.pop("checkpoint_dir") == str(tmp_path / tag)
    assert got["train"] == want["train"]
    jcfg = jax_config.from_dict(jax_config.JointConfig, got["joint"])
    assert jax_config.from_dict(jax_config.JointConfig, want["joint"]) == (
        dataclasses.replace(jcfg, e2e=dataclasses.replace(
            jcfg.e2e, encoder=dataclasses.replace(
                jcfg.e2e.encoder, scan_unroll=4),
            decoder=dataclasses.replace(jcfg.e2e.decoder, scan_unroll=4)),
            enhancer=dataclasses.replace(jcfg.enhancer, scan_unroll=4)))
    arks = [tmp_path / t / "cmvn.ark" for t in ("port", "jax")]
    assert arks[0].exists() == arks[1].exists() == ("--cmvn-ark" in args)
    if arks[0].exists():
        assert arks[0].read_bytes() == arks[1].read_bytes()


# name -> the arguments that both CLIs refuse with the same SystemExit
CLI_REFUSALS = {
    "mel_feats_joint": ["--train-feats-scp", "feats.scp"],
    "spectra_joint_without_clean": ["--train-feats-scp", "spec.scp",
                                    "--feats-kind", "spectrogram"],
    "speaker_without_utt2spk": ["--train-noisy-scp", "wav.scp", "--cmvn",
                                "speaker", "--cmvn-ark", "spk_cmvn.ark"],
    "global_without_ark": ["--train-noisy-scp", "wav.scp", "--cmvn",
                           "global"],
}


@pytest.mark.parametrize("name", list(CLI_REFUSALS))
def test_train_cli_refusals_match_jax(corpus, tmp_path, monkeypatch, name):
    messages = []
    for tag, cli, mod, extra in (
            ("jax", jax_train_cli, jax_loop, []),
            ("port", train_cli, loop, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "train", None)  # never reached
        with pytest.raises(SystemExit) as exc:
            cli.main(_cli_args(corpus, tmp_path, CLI_REFUSALS[name], tag)
                     + extra)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# short runs through the entry points
# ---------------------------------------------------------------------------

# name -> (train.cli arguments, decode.cli arguments), paths by corpus key
RUNS = {
    "asr_feats_speaker": (
        ["--mode", "asr", "--train-feats-scp", "feats_cm.scp", "--cmvn",
         "speaker", "--cmvn-ark", "spk_cmvn.ark", "--utt2spk", "utt2spk",
         "--length-buckets", FRAME_BUCKETS],
        ["--feats-scp", "feats_cm.scp", "--utt2spk", "utt2spk",
         "--length-buckets", FRAME_BUCKETS]),
    "joint_log_spectra": (
        ["--mode", "joint", "--train-feats-scp", "spec.scp", "--feats-kind",
         "log-spectrogram", "--train-clean-feats-scp", "clean_spec.scp",
         "--length-buckets", FRAME_BUCKETS],
        ["--feats-scp", "spec.scp", "--utt2num-frames", "utt2num_frames",
         "--length-buckets", FRAME_BUCKETS]),
    "asr_wav_global": (
        ["--mode", "asr", "--train-noisy-scp", "wav.scp", "--cmvn",
         "global", "--cmvn-ark", "cmvn.ark", "--length-buckets",
         WAV_BUCKETS],
        ["--noisy-scp", "wav.scp", "--length-buckets", WAV_BUCKETS]),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_kaldi_runs_train_and_decode(corpus, tmp_path, one_thread, name):
    """One epoch (two steps of three) through ``train.cli`` on the CPU,
    then ``decode.cli`` of the run from its Kaldi source: every utterance
    decoded, finite rates, the stats ark in the run dir."""
    p = corpus["paths"]
    train_args, decode_args = RUNS[name]
    exp = str(tmp_path / "exp")
    train_cli.main([p.get(a, a) for a in train_args] + TINY + [
        "--train-text", p["text"], "--ckpt-dir", exp, "--epochs", "1"])
    with open(os.path.join(exp, "checkpoints.json")) as f:
        assert json.load(f)["latest"]["step"] == 2
    assert os.path.exists(os.path.join(exp, "cmvn.ark")) == (
        "--cmvn-ark" in train_args)
    out = str(tmp_path / "decode")
    decode_cli.main([p.get(a, a) for a in decode_args] + [
        "--text", p["text"], "--ckpt-dir", exp, "--out", out,
        "--batch-size", "4", "--beam-size", "2", "--max-steps", "4",
        "--device", "cpu"])
    with open(os.path.join(out, "wer.json")) as f:
        report = json.load(f)
    assert report["n_utts"] == N_UTTS
    assert np.isfinite(report["wer"]["error_rate"])
    with open(os.path.join(out, "hyp.txt")) as f:
        assert sorted(line.split()[0] for line in f if line.strip()) == (
            sorted(corpus["texts"]))
