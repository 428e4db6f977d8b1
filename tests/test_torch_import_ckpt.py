"""The port's reference-checkpoint importer
(``robust_e2e_gan_torch/tools/import_reference_ckpt.py``) against the JAX
package's (``tools/import_reference_ckpt.py``), on reference-layout state
dicts built from real ``torch.nn`` modules: the same parameters bit for
bit, the same CTC logits as the JAX model on them, ``export_state_dict``
its exact inverse, the VGG2L flatten permutation against a real
Conv2d -> flatten -> LSTM chain, and the CLI with ``--units`` writing an
experiment that the port's ``decode.cli`` decodes."""

import dataclasses
import json
import os

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params  # noqa: E402
from robust_e2e_gan_torch.data.dataset import (  # noqa: E402
    TableTokenizer,
    load_tokenizer,
)
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.decode import cli as decode_cli  # noqa: E402
from robust_e2e_gan_torch.models.encoder import VGG2L  # noqa: E402
from robust_e2e_gan_torch.models.rnn import BLSTM  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402
from robust_e2e_gan_torch.tools import import_reference_ckpt as port_tool  # noqa: E402
from tools import import_reference_ckpt as jax_tool  # noqa: E402

VOCAB = 12
# name -> (enhancer keys present, mlp_enc has a bias, z-only readout)
CASES = {"enhancer_z_only": (True, False, True),
         "asr_only_enc_bias": (False, True, False),
         "enhancer_enc_bias": (True, True, True)}


def _jcfg(enc_proj_bias=False):
    """The tiny model with two encoder and two enhancer layers (the layer
    indices of both BLSTM stacks are exercised)."""
    jcfg = configs.tiny_config(VOCAB)
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(
            e2e,
            encoder=dataclasses.replace(e2e.encoder, num_layers=2),
            attention=dataclasses.replace(e2e.attention,
                                          enc_proj_bias=enc_proj_bias)),
        enhancer=dataclasses.replace(jcfg.enhancer, num_layers=2))


def _jax(cfg):
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def reference_state_dict(jcfg, enhancer, enc_bias, z_only, seed=0):
    """A random ESPnet-era state dict of real torch modules: VGG2L convs,
    bidirectional LSTM layers and their projections, AttLoc (with a gvec
    bias), the decoder's LSTMCells and readout, CTC, and the enhancer's
    multi-layer LSTM and mask Linear."""
    torch.manual_seed(seed)
    ecfg, acfg, dcfg = jcfg.e2e.encoder, jcfg.e2e.attention, jcfg.e2e.decoder
    mods = {}
    c_in = 1
    for i, ch in enumerate(ecfg.vgg_channels):
        mods[f"enc.enc1.conv{i + 1}_1"] = nn.Conv2d(c_in, ch, 3, padding=1)
        mods[f"enc.enc1.conv{i + 1}_2"] = nn.Conv2d(ch, ch, 3, padding=1)
        c_in = ch
    d = ((ecfg.input_dim + 1) // 2 + 1) // 2 * ecfg.vgg_channels[-1]
    for layer in range(ecfg.num_layers):
        mods[f"enc.enc2.bilstm{layer}"] = nn.LSTM(
            d, ecfg.hidden_dim, 1, batch_first=True, bidirectional=True)
        mods[f"enc.enc2.bt{layer}"] = nn.Linear(2 * ecfg.hidden_dim,
                                                ecfg.proj_dim)
        d = ecfg.proj_dim
    e = ecfg.proj_dim
    mods["att.mlp_enc"] = nn.Linear(e, acfg.dim, bias=enc_bias)
    mods["att.mlp_dec"] = nn.Linear(dcfg.hidden_dim, acfg.dim, bias=False)
    mods["att.mlp_att"] = nn.Linear(acfg.conv_channels, acfg.dim, bias=False)
    mods["att.gvec"] = nn.Linear(acfg.dim, 1)
    mods["att.loc_conv"] = nn.Conv2d(1, acfg.conv_channels,
                                     (1, acfg.conv_kernel), bias=False)
    mods["dec.embed"] = nn.Embedding(dcfg.vocab_size, dcfg.embed_dim)
    d = dcfg.embed_dim + e
    for layer in range(dcfg.num_layers):
        mods[f"dec.decoder.{layer}"] = nn.LSTMCell(d, dcfg.hidden_dim)
        d = dcfg.hidden_dim
    mods["dec.output"] = nn.Linear(
        dcfg.hidden_dim + (0 if z_only else e), dcfg.vocab_size)
    mods["ctc.ctc_lo"] = nn.Linear(e, dcfg.vocab_size)
    if enhancer:
        h = jcfg.enhancer.hidden_dim
        mods["enh.lstm"] = nn.LSTM(jcfg.enhancer.input_dim, h,
                                   jcfg.enhancer.num_layers,
                                   batch_first=True, bidirectional=True)
        mods["enh.mask_out"] = nn.Linear(2 * h, jcfg.enhancer.input_dim)
    return {f"model.{prefix}.{k}": v for prefix, mod in mods.items()
            for k, v in mod.state_dict().items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("case", list(CASES))
def test_importer_matches_the_jax_importer(case):
    """Both importers give the same tree bit for bit; the model on it gives
    the JAX model's CTC logits; exporting and importing again gives the
    tree back exactly."""
    enhancer, enc_bias, z_only = CASES[case]
    jcfg = _jcfg(enc_proj_bias=enc_bias)
    sd = reference_state_dict(jcfg, enhancer, enc_bias, z_only)
    got = port_tool.import_state_dict(sd, jcfg)
    want = jax_tool.import_state_dict(sd, _jax(jcfg))
    _assert_bit_equal(got, want)
    assert ("enhancer" in got) is enhancer
    out_w = got["asr"]["decoder"]["step_mod"]["output"]["kernel"]
    assert (not out_w[jcfg.e2e.decoder.hidden_dim:].any()) is z_only

    port_tool.validate_against_template(got, init_params(jcfg, 0))
    back = port_tool.import_state_dict(
        port_tool.export_state_dict(got, jcfg), jcfg)
    _assert_bit_equal(back, got)

    # the whole generator: the fresh enhancer where none was imported
    params = init_params(jcfg, 1)
    params.update(got)
    batch = make_batch(2, SyntheticConfig(vocab_size=VOCAB, min_tokens=2,
                                          max_tokens=3),
                       np.random.default_rng(4))
    args = (batch["noisy_wav"], batch["wav_lengths"])
    w_enc = JaxRobustE2E(_jax(jcfg)).apply(
        {"params": params}, *map(jnp.asarray, args), True,
        method=JaxRobustE2E.encode_for_decode)
    model = build_model(jcfg)
    model.load_state_dict(from_flax(params))
    with torch.no_grad():
        g_enc = model.encode_for_decode(*map(torch.from_numpy, args), True)
    for g, w in zip(g_enc[3:], w_enc[3:]):  # CTC logits, enc projection
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_export_inverts_the_import_of_a_port_tree():
    jcfg = _jcfg(enc_proj_bias=True)
    params = init_params(jcfg, 2)
    sd = port_tool.export_state_dict(params, jcfg)
    _assert_bit_equal(port_tool.import_state_dict(sd, jcfg), params)
    _assert_bit_equal(jax_tool.export_state_dict(params, _jax(jcfg)), sd)


@pytest.mark.parametrize("variant", ["add", "dot"])
def test_content_attention_imports(variant):
    """AttAdd keeps mlp_dec and gvec, AttDot mlp_dec alone: the import of
    a reference without the location conv, and its export, fit the
    variant's tree."""
    jcfg = _jcfg()
    jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(
        jcfg.e2e, attention=dataclasses.replace(jcfg.e2e.attention,
                                                variant=variant)))
    params = init_params(jcfg, 3)
    sd = port_tool.export_state_dict(params, jcfg)
    assert not any("loc_conv" in k or "mlp_att" in k for k in sd)
    back = port_tool.import_state_dict(sd, jcfg)
    _assert_bit_equal(back, {k: params[k] for k in back})
    port_tool.validate_against_template(back, params)


def test_vgg_permutation_against_a_torch_chain():
    """The importer's conv map and row permutation reproduce a reference
    Conv2d x 4 -> ceil max-pools -> channel-major flatten -> nn.LSTM
    chain through the port's VGG2L and BLSTM."""
    channels, d, h = (4, 8), 20, 16
    torch.manual_seed(3)
    convs, c_in = [], 1
    for ch in channels:
        convs.append((nn.Conv2d(c_in, ch, 3, padding=1),
                      nn.Conv2d(ch, ch, 3, padding=1)))
        c_in = ch
    fp = (((d + 1) // 2) + 1) // 2
    lstm = nn.LSTM(fp * channels[-1], h, 1, batch_first=True,
                   bidirectional=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 9, d)).astype(np.float32))
    with torch.no_grad():
        y = x[:, None]
        for c1, c2 in convs:
            y = F.max_pool2d(torch.relu(c2(torch.relu(c1(y)))), 2, 2,
                             ceil_mode=True)
        b, c, t, f = y.shape
        want, _ = lstm(y.transpose(1, 2).reshape(b, t, c * f))

    sd = {f"enc1.conv{i + 1}_{j}.{w}": getattr(conv, w)
          for i, pair in enumerate(convs) for j, conv in ((1, pair[0]),
                                                          (2, pair[1]))
          for w in ("weight", "bias")}
    sd.update({f"enc2.lstm.{k}": v for k, v in lstm.state_dict().items()})
    vgg = VGG2L(channels, torch.float32)
    vgg.load_state_dict(from_flax({
        f"conv{i}_{j}": {
            "kernel": np.transpose(port_tool._get(
                sd, f"conv{i + 1}_{j}.weight"), (2, 3, 1, 0)),
            "bias": port_tool._get(sd, f"conv{i + 1}_{j}.bias")}
        for i in range(2) for j in (1, 2)}))
    p = port_tool._bilstm(sd, "lstm")
    p["wx"] = p["wx"][:, port_tool.vgg_flatten_permutation(d, channels[-1])]
    blstm = BLSTM(fp * channels[-1], h, torch.float32)
    blstm.load_state_dict(from_flax(p))
    with torch.no_grad():
        got = blstm(vgg(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_cli_with_units_writes_a_decodable_experiment(tmp_path):
    """``--units`` (10 units at ids 1-10): a ``TableTokenizer`` of vocab
    12 with sos = eos = 11 in the patched config, the imported parameters
    in ``ckpt_0.pt``, and ``decode.cli`` decodes the experiment."""
    jcfg = _jcfg()
    sd = reference_state_dict(jcfg, True, True, True, seed=5)
    pth = tmp_path / "ref.pth"
    torch.save({"model": sd}, pth)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(jcfg)))
    units = tmp_path / "units.txt"
    units.write_text("\n".join(f"{c} {i + 1}"
                               for i, c in enumerate("abcdefghij")))
    out = tmp_path / "exp"
    port_tool.main([str(pth), str(out), "--config", str(cfg_path),
                    "--units", str(units)])

    saved = json.loads((out / "config.json").read_text())
    e2e = saved["joint"]["e2e"]
    assert (e2e["blank_id"], e2e["sos_id"], e2e["eos_id"]) == (0, 11, 11)
    assert e2e["attention"]["enc_proj_bias"]  # patched: mlp_enc.bias
    tok = load_tokenizer(str(out / "tokenizer.json"))
    assert isinstance(tok, TableTokenizer) and tok.vocab_size == VOCAB
    model, jcfg2, tok2, step, _, _ = decode_cli.load_experiment(
        str(out), device="cpu")
    assert step == 0 and jcfg2.e2e.eos_id == 11
    imported = port_tool.import_state_dict(sd, jcfg2)
    state = model.state_dict()
    for name, value in from_flax(imported).items():
        assert torch.equal(state[name], value), name

    batch = make_batch(3, SyntheticConfig(vocab_size=VOCAB, min_tokens=2,
                                          max_tokens=3),
                       np.random.default_rng(6))
    entries = []
    for i in range(3):
        path = tmp_path / f"u{i}.npy"
        np.save(path, batch["noisy_wav"][i, :batch["wav_lengths"][i]])
        entries.append({"utt_id": f"u{i}", "noisy": str(path),
                        "n_samples": int(batch["wav_lengths"][i]),
                        "text": tok.decode(batch["labels"][i])})
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("\n".join(json.dumps(e) for e in entries) + "\n")
    decode_cli.main(["--manifest", str(manifest), "--ckpt-dir", str(out),
                     "--device", "cpu", "--batch-size", "3",
                     "--beam-size", "2", "--max-steps", "5", "--nbest", "1",
                     "--out", str(tmp_path / "dec")])
    report = json.loads((tmp_path / "dec" / "wer.json").read_text())
    assert report["n_utts"] == 3 and "wer" in report and "cer" in report
    hyps = (tmp_path / "dec" / "hyp.txt").read_text().splitlines()
    assert [line.split()[0] for line in hyps] == ["u0", "u1", "u2"]
    for row in map(json.loads, open(tmp_path / "dec" / "nbest.jsonl")):
        toks = row["nbest"][0]["tokens"]
        assert all(0 < t < 11 for t in toks)  # no blank, no sos/eos
