"""Import a reference-layout PyTorch checkpoint into a port experiment.

    python -m robust_e2e_gan_torch.tools.import_reference_ckpt ref.pth \\
        out_dir --config exp/config.json [--units units.txt]

The port's copy of the top-level ``tools/import_reference_ckpt.py``. It
maps an ESPnet-era ``state_dict`` (Encoder/VGG2L/BLSTMP, AttLoc,
Decoder, CTC, and optionally the enhancer) onto the parameter tree in the
flax layout, the names the port's modules keep (``convert.py``), and
writes an experiment directory that the port's ``decode.cli`` decodes:
``config.json`` (the given config, patched), ``tokenizer.json`` and
``ckpt_0.pt``. It is a host-side file conversion: it runs on the CPU.

The layout it knows:

* a torch ``Linear.weight`` is (out, in); a Dense kernel is (in, out);
* torch packs an LSTM's gates (i, f, g, o) along the first axis of its
  (4H, D) weights, the order the port's cells split them in, and carries
  two biases, summed here; a bidirectional layer's ``..._reverse`` keys
  are direction 1 of the stacked (2, D, 4H) weights;
* a torch ``Conv2d.weight`` is (out, in, kh, kw); the flax tree's 2-D
  kernels are (kh, kw, in, out) (``convert.from_flax`` gives the port's
  ``F.conv2d`` layout back);
* the reference VGG2L flattens (B, C, T', F') channel-major into
  (B, T', C * F'), the port's freq-major into (B, T', F' * C): the first
  encoder BLSTM's input rows are permuted (``vgg_flatten_permutation``);
* AttLoc's ``mlp_att`` is ``mlp_loc``; ``loc_conv`` (C, 1, 1, K) is the
  1-D (K, 1, C); ``gvec.bias`` is dropped (a constant shift of every score
  leaves the softmax as it is); a ``mlp_enc.bias`` sets
  ``AttentionConfig.enc_proj_bias``; AttAdd has no location conv and
  AttDot no ``gvec`` either (``AttentionConfig.variant``);
* a reference-era readout reads the LSTM state alone (V, dunits): it lands
  in the z rows of the port's (dunits + eprojs, V) readout, the context
  rows zero;
* the enhancer (optional): a multi-layer bidirectional ``nn.LSTM`` and its
  (F, 2H) mask ``Linear``.

``export_state_dict`` is the exact inverse. ``--units`` builds a
``TableTokenizer`` from a Kaldi/ESPnet ``units.txt`` and sets the config's
special ids to the reference's (blank 0, sos = eos = V - 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np

# ---------------------------------------------------------------------------
# state_dict access
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    """A torch tensor or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _find(sd: Dict[str, np.ndarray], suffix: str,
          optional: bool = False) -> Optional[str]:
    """The one key ending in ``suffix``, whatever prefix a reference
    wrapper nests the model under; a match at a "." boundary wins."""
    hits = [k for k in sd if k == suffix or k.endswith(suffix)]
    exact = [k for k in hits if k == suffix or k.endswith("." + suffix)]
    hits = exact or hits
    if len(hits) == 1:
        return hits[0]
    if not hits:
        if optional:
            return None
        raise KeyError(f"no state_dict key matching *{suffix}")
    raise KeyError(f"ambiguous state_dict suffix *{suffix}: {sorted(hits)}")


def _get(sd, suffix, optional=False):
    k = _find(sd, suffix, optional=optional)
    return None if k is None else _np(sd[k])


def _linear(sd, name, bias=True, optional=False):
    """(kernel (in, out), bias or None) of the Linear ``name``."""
    w = _get(sd, f"{name}.weight", optional=optional)
    if w is None:
        return None, None
    b = _get(sd, f"{name}.bias", optional=not bias)
    return w.T.astype(np.float32), (None if b is None
                                    else b.astype(np.float32))


def _cell(w_ih, w_hh, b_ih, b_hh):
    """One direction of a torch LSTM -> the port's (wx, wh, bias)."""
    bias = np.zeros(w_ih.shape[0], np.float32)
    for b in (b_ih, b_hh):
        if b is not None:
            bias = bias + b
    return (w_ih.T.astype(np.float32), w_hh.T.astype(np.float32),
            bias.astype(np.float32))


def _lstm_dir(sd, base, layer=0, reverse=False):
    sfx = f"l{layer}" + ("_reverse" if reverse else "")
    return _cell(*(_get(sd, f"{base}.{w}_{sfx}", optional=w.startswith("b"))
                   for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))


def _bilstm(sd, base, layer=0):
    """Both directions of layer ``layer`` of the torch LSTM ``base`` -> the
    stacked (2, D, 4H) / (2, H, 4H) / (2, 4H) parameters."""
    fwd = _lstm_dir(sd, base, layer, reverse=False)
    bwd = _lstm_dir(sd, base, layer, reverse=True)
    return {name: np.stack([f, b])
            for name, f, b in zip(("wx", "wh", "bias"), fwd, bwd)}


def _ceil2(n: int) -> int:
    return (n + 1) // 2


def vgg_flatten_permutation(input_dim: int, channels: int) -> np.ndarray:
    """perm[j]: the reference column that feeds the port's column j.

    The port's column j (freq-major) is d * C + c; the reference's
    (channel-major) is c * F' + d, F' the twice ceil-pooled freq dim."""
    fp = _ceil2(_ceil2(input_dim))
    j = np.arange(fp * channels)
    d, c = j // channels, j % channels
    return c * fp + d


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------


def _attention(sd, jcfg) -> Dict:
    """The attention subtree of ``AttentionConfig.variant``."""
    variant = jcfg.e2e.attention.variant
    dec_w, _ = _linear(sd, "mlp_dec", bias=False)
    att = {"mlp_dec": {"kernel": dec_w}}
    if variant in ("location", "add"):
        gvec_w, _ = _linear(sd, "gvec", bias=False)  # the bias is dropped
        att["gvec"] = {"kernel": gvec_w}
    if variant == "location":
        loc_w, _ = _linear(sd, "mlp_att", bias=False)
        conv_w = _get(sd, "loc_conv.weight")  # (C, 1, 1, K)
        att["mlp_loc"] = {"kernel": loc_w}
        att["loc_conv"] = {"kernel": np.transpose(conv_w, (3, 2, 1, 0))
                           [:, 0, :, :].astype(np.float32)}
    return att


def import_state_dict(sd: Dict[str, np.ndarray], jcfg,
                      with_enhancer="auto") -> Dict:
    """A reference ``state_dict`` -> the generator's parameter tree in the
    flax layout (``asr``, and ``enhancer`` where imported).
    ``with_enhancer``: "auto" imports the enhancer where its keys are
    present; True or False forces or skips it."""
    sd = dict(sd)
    ecfg, dcfg = jcfg.e2e.encoder, jcfg.e2e.decoder

    vgg = {}
    for i in range(len(ecfg.vgg_channels)):
        for j in (1, 2):
            w = _get(sd, f"conv{i + 1}_{j}.weight")
            b = _get(sd, f"conv{i + 1}_{j}.bias")
            vgg[f"conv{i}_{j}"] = {
                "kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
                "bias": b.astype(np.float32)}

    blstmp = {}
    perm = vgg_flatten_permutation(ecfg.input_dim, ecfg.vgg_channels[-1])
    for layer in range(ecfg.num_layers):
        p = _bilstm(sd, f"bilstm{layer}")
        if layer == 0:
            p["wx"] = p["wx"][:, perm, :]
        blstmp[f"blstm{layer}"] = p
        pw, pb = _linear(sd, f"bt{layer}")
        blstmp[f"proj{layer}"] = {"kernel": pw, "bias": pb}

    enc_w, enc_b = _linear(sd, "mlp_enc", bias=False)
    mlp_enc = {"kernel": enc_w}
    if enc_b is not None:
        if not jcfg.e2e.attention.enc_proj_bias:
            raise ValueError(
                "reference mlp_enc has a bias; set "
                "AttentionConfig.enc_proj_bias=True in the target config "
                "(the CLI does this itself)")
        mlp_enc["bias"] = enc_b

    step = {"embed": {"embedding": _get(sd, "embed.weight")
                      .astype(np.float32)},
            "att": _attention(sd, jcfg)}
    for layer in range(dcfg.num_layers):
        wx, wh, bias = _cell(*(
            _get(sd, f"decoder.{layer}.{w}", optional=w.startswith("b"))
            for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
        step[f"lstm{layer}"] = {"wx": wx, "wh": wh, "bias": bias}
    out_w, out_b = _linear(sd, "output")
    hdim, e_dim = dcfg.hidden_dim, ecfg.proj_dim
    if out_w.shape[0] == hdim:  # a z-only readout: zero context rows
        full = np.zeros((hdim + e_dim, out_w.shape[1]), np.float32)
        full[:hdim] = out_w
        out_w = full
    elif out_w.shape[0] != hdim + e_dim:
        raise ValueError(
            f"decoder output weight in-dim {out_w.shape[0]} matches "
            f"neither dunits={hdim} nor dunits+eprojs={hdim + e_dim}")
    step["output"] = {"kernel": out_w, "bias": out_b}

    ctc_w, ctc_b = _linear(sd, "ctc_lo")
    params = {"asr": {
        "encoder": {"vgg": vgg, "blstmp": blstmp},
        "ctc": {"ctc_lo": {"kernel": ctc_w, "bias": ctc_b}},
        "decoder": {"enc_projection": {"mlp_enc": mlp_enc},
                    "step_mod": step},
    }}

    has_enh = any(re.search(r"(^|\.)lstm\.weight_ih_l0$", k) for k in sd)
    if has_enh if with_enhancer == "auto" else bool(with_enhancer):
        params["enhancer"] = _enhancer(sd, jcfg.enhancer)
    return params


def _enhancer(sd, ecfg) -> Dict:
    enh = {f"blstm{layer}": _bilstm(sd, "lstm", layer=layer)
           for layer in range(ecfg.num_layers)}
    mw = mb = None
    for cand in ("mask_out", "affine", "linear", "fc", "mask"):
        mw, mb = _linear(sd, cand, optional=True)
        if mw is not None:
            break
    if mw is None:
        # by shape: the one (F, 2H) Linear
        f, h2 = ecfg.input_dim, 2 * ecfg.hidden_dim
        cands = [k for k, v in sd.items()
                 if k.endswith(".weight") and _np(v).shape == (f, h2)]
        if len(cands) != 1:
            raise KeyError(f"cannot locate the enhancer mask Linear (F={f}, "
                           f"2H={h2}); candidates: {cands}")
        mw = _np(sd[cands[0]]).T.astype(np.float32)
        bk = cands[0][:-len(".weight")] + ".bias"
        mb = (_np(sd[bk]).astype(np.float32) if bk in sd
              else np.zeros(f, np.float32))
    enh["mask_out"] = {"kernel": mw, "bias": mb}
    return enh


# ---------------------------------------------------------------------------
# export: the exact inverse, in reference-layout names
# ---------------------------------------------------------------------------


def _export_bilstm(sd, base, p, layer=0, perm=None):
    wx, wh, bias = _np(p["wx"]), _np(p["wh"]), _np(p["bias"])
    if perm is not None:
        wx = wx[:, perm, :]
    for z, sfx in ((0, f"l{layer}"), (1, f"l{layer}_reverse")):
        sd[f"{base}.weight_ih_{sfx}"] = wx[z].T
        sd[f"{base}.weight_hh_{sfx}"] = wh[z].T
        sd[f"{base}.bias_ih_{sfx}"] = bias[z]
        sd[f"{base}.bias_hh_{sfx}"] = np.zeros_like(bias[z])


def export_state_dict(params: Dict, jcfg) -> Dict[str, np.ndarray]:
    """The parameter tree (flax layout) -> a reference-layout
    ``state_dict``; ``import_state_dict`` of it gives the tree back."""
    ecfg, dcfg = jcfg.e2e.encoder, jcfg.e2e.decoder
    sd: Dict[str, np.ndarray] = {}
    asr = params["asr"]
    for i in range(len(ecfg.vgg_channels)):
        for j in (1, 2):
            p = asr["encoder"]["vgg"][f"conv{i}_{j}"]
            sd[f"enc.enc1.conv{i + 1}_{j}.weight"] = np.transpose(
                _np(p["kernel"]), (3, 2, 0, 1))
            sd[f"enc.enc1.conv{i + 1}_{j}.bias"] = _np(p["bias"])

    inv = np.argsort(vgg_flatten_permutation(ecfg.input_dim,
                                             ecfg.vgg_channels[-1]))
    for layer in range(ecfg.num_layers):
        _export_bilstm(sd, f"enc.enc2.bilstm{layer}",
                       asr["encoder"]["blstmp"][f"blstm{layer}"],
                       perm=inv if layer == 0 else None)
        pr = asr["encoder"]["blstmp"][f"proj{layer}"]
        sd[f"enc.enc2.bt{layer}.weight"] = _np(pr["kernel"]).T
        sd[f"enc.enc2.bt{layer}.bias"] = _np(pr["bias"])

    mlp_enc = asr["decoder"]["enc_projection"]["mlp_enc"]
    sd["att.mlp_enc.weight"] = _np(mlp_enc["kernel"]).T
    if "bias" in mlp_enc:
        sd["att.mlp_enc.bias"] = _np(mlp_enc["bias"])
    step = asr["decoder"]["step_mod"]
    att = step["att"]
    sd["att.mlp_dec.weight"] = _np(att["mlp_dec"]["kernel"]).T
    if "gvec" in att:
        sd["att.gvec.weight"] = _np(att["gvec"]["kernel"]).T
    if "mlp_loc" in att:
        sd["att.mlp_att.weight"] = _np(att["mlp_loc"]["kernel"]).T
        sd["att.loc_conv.weight"] = np.transpose(
            _np(att["loc_conv"]["kernel"])[:, None, :, :], (3, 2, 1, 0))

    sd["dec.embed.weight"] = _np(step["embed"]["embedding"])
    for layer in range(dcfg.num_layers):
        p = step[f"lstm{layer}"]
        sd[f"dec.decoder.{layer}.weight_ih"] = _np(p["wx"]).T
        sd[f"dec.decoder.{layer}.weight_hh"] = _np(p["wh"]).T
        sd[f"dec.decoder.{layer}.bias_ih"] = _np(p["bias"])
        sd[f"dec.decoder.{layer}.bias_hh"] = np.zeros_like(_np(p["bias"]))
    sd["dec.output.weight"] = _np(step["output"]["kernel"]).T
    sd["dec.output.bias"] = _np(step["output"]["bias"])
    sd["ctc.ctc_lo.weight"] = _np(asr["ctc"]["ctc_lo"]["kernel"]).T
    sd["ctc.ctc_lo.bias"] = _np(asr["ctc"]["ctc_lo"]["bias"])

    if "enhancer" in params:
        enh = params["enhancer"]
        for layer in range(jcfg.enhancer.num_layers):
            _export_bilstm(sd, "enh.lstm", enh[f"blstm{layer}"], layer)
        sd["enh.mask_out.weight"] = _np(enh["mask_out"]["kernel"]).T
        sd["enh.mask_out.bias"] = _np(enh["mask_out"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------


def _tree_paths(t, prefix=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree_paths(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.shape(t)


def validate_against_template(imported: Dict, template: Dict) -> None:
    """Every imported leaf must be in the template, at its shape (a config
    that does not match the reference's architecture fails here)."""
    tpl = dict(_tree_paths(template))
    errs = []
    for path, shape in _tree_paths(imported):
        if path not in tpl:
            errs.append(f"{path}: not in the model's parameter tree")
        elif tuple(tpl[path]) != tuple(shape):
            errs.append(f"{path}: imported {shape} != model {tpl[path]}")
    if errs:
        raise ValueError("imported checkpoint does not fit the config:\n  "
                         + "\n  ".join(errs))


def _replace_e2e(jcfg, **kw):
    return dataclasses.replace(jcfg, e2e=dataclasses.replace(jcfg.e2e, **kw))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Import a reference-layout PyTorch checkpoint into a "
        "port experiment dir (decodable with `decode.cli --ckpt-dir`).")
    ap.add_argument("state_dict", help=".pth/.pt torch state_dict (or a "
                    "dict with a 'model'/'state_dict' entry)")
    ap.add_argument("out_dir", help="experiment dir to create")
    ap.add_argument("--config", required=True,
                    help="JointConfig JSON matching the reference "
                    "architecture (a train CLI's config.json also works)")
    ap.add_argument("--tokenizer", default=None,
                    help="optional tokenizer.json to copy alongside")
    ap.add_argument("--units", default=None,
                    help="reference Kaldi/ESPnet units.txt ('token id' "
                    "lines); emits a table tokenizer in the reference's "
                    "own id layout and patches vocab/sos/eos ids")
    return ap


def main(argv=None) -> None:
    import torch

    from robust_e2e_gan_torch import config as cfg_lib
    from robust_e2e_gan_torch.config import JointConfig, TrainConfig
    from robust_e2e_gan_torch.convert import from_flax, init_params, to_flax
    from robust_e2e_gan_torch.data.dataset import TableTokenizer
    from robust_e2e_gan_torch.train.loop import init_state
    from robust_e2e_gan_torch.utils.checkpoint import save_checkpoint

    args = build_parser().parse_args(argv)
    raw = torch.load(args.state_dict, map_location="cpu", weights_only=False)
    for k in ("model", "state_dict", "model_state_dict"):
        if isinstance(raw, dict) and isinstance(raw.get(k), dict):
            raw = raw[k]
            break
    sd = {k: _np(v) for k, v in raw.items()}

    with open(args.config) as f:
        saved = json.load(f)
    if "joint" in saved:  # a train CLI's config.json
        jcfg = cfg_lib.from_dict(JointConfig, saved["joint"])
        tcfg = cfg_lib.from_dict(TrainConfig, saved["train"])
    else:
        jcfg = cfg_lib.from_dict(JointConfig, saved)
        tcfg = TrainConfig()

    tok = None
    if args.units:
        tok = TableTokenizer.from_units(args.units)
        v = tok.vocab_size
        emb_v = _get(sd, "embed.weight").shape[0]
        if v != emb_v:
            raise ValueError(
                f"units.txt implies vocab {v} (blank 0 + units + sos/eos "
                f"{tok.sos_eos_id}) but the embedding has {emb_v} rows")
        # the reference's id layout: blank 0, one sos/eos at V - 1
        jcfg = _replace_e2e(
            jcfg, blank_id=tok.blank_id, sos_id=tok.sos_eos_id,
            eos_id=tok.sos_eos_id,
            decoder=dataclasses.replace(jcfg.e2e.decoder, vocab_size=v))
        print(f"units.txt: vocab {v}, blank {tok.blank_id}, "
              f"sos/eos {tok.sos_eos_id}")
    if (_find(sd, "mlp_enc.bias", optional=True) is not None
            and not jcfg.e2e.attention.enc_proj_bias):
        jcfg = _replace_e2e(jcfg, attention=dataclasses.replace(
            jcfg.e2e.attention, enc_proj_bias=True))
        print("note: reference mlp_enc has a bias -> enc_proj_bias=True")

    params = import_state_dict(sd, jcfg)
    validate_against_template(params, init_params(jcfg, seed=0))
    # a fresh state of seed 0 with the imported generator parameters over
    # it; its optimizer starts fresh: the import is for decoding and fine
    # tuning, not for continuing the reference's optimizer
    state = init_state(jcfg, dataclasses.replace(tcfg, seed=0), "cpu")
    merged = to_flax(state.model.state_dict())
    merged["asr"] = params["asr"]
    if "enhancer" in params:
        merged["enhancer"] = params["enhancer"]
    else:
        print("note: no enhancer keys in the state_dict; the enhancer keeps "
              "its fresh draw (an ASR-only import)")
    state.model.load_state_dict(from_flax(merged))

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump({"joint": dataclasses.asdict(jcfg),
                   "train": dataclasses.asdict(tcfg), "mode": "joint",
                   "input_kind": "wav", "spec_log_domain": False,
                   "imported_from": os.path.abspath(args.state_dict)},
                  f, indent=2)
    if args.tokenizer:
        shutil.copy(args.tokenizer,
                    os.path.join(args.out_dir, "tokenizer.json"))
    elif tok is not None:
        tok.save(os.path.join(args.out_dir, "tokenizer.json"))
    save_checkpoint(args.out_dir, state, step=0)
    n = sum(int(np.prod(s)) for _, s in _tree_paths(params))
    print(f"imported {n / 1e6:.1f}M reference params -> {args.out_dir} "
          "(decode with: python -m robust_e2e_gan_torch decode "
          f"--ckpt-dir {args.out_dir} ...)")


if __name__ == "__main__":
    main()
