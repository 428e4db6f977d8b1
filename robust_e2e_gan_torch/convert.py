"""Parameters between the flax layout and the port's state dict.

The port keeps the flax parameter names and layouts, so a state-dict key is
the flax path joined with dots (``asr.decoder.step_mod.lstm0.wx``) and
dense and LSTM weights copy as they are. Convolution kernels are the one
exception: they are transposed once, to the layout ``F.conv2d`` and
``F.conv1d`` take.

``init_params`` (the generator, ``RobustE2E``), ``init_disc_params`` (the
discriminator) and ``init_lm_params`` (the RNNLM) build trees in the flax
layout with numpy alone, drawn from the same distributions as the flax
initialisers (``models/rnn.py``, flax's lecun-normal dense and conv
kernels, normal embeddings), so a caller without JAX gets weights at the
real scale. ``to_flax`` is the inverse of
``from_flax``: gradients and updated parameters compare in flax layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from robust_e2e_gan_torch.config import (
    DiscriminatorConfig,
    JointConfig,
    LMConfig,
)


def _flatten(tree, prefix=""):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, key + ".")
        else:
            yield key, value


def is_conv_kernel(key: str, ndim: int) -> bool:
    """Whether state-dict leaf ``key`` of rank ``ndim`` is a convolution
    kernel, stored transposed from its flax layout."""
    return key.endswith("loc_conv.kernel") or (key.endswith(".kernel")
                                               and ndim == 4)


def from_flax(params) -> Dict[str, torch.Tensor]:
    """Nested numpy tree of ``model.init(...)["params"]`` -> state dict.

    Conv kernels: 2-D ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``;
    the 1-D ``loc_conv`` ``(K, 1, C)`` -> ``(C, 1, K)``.
    """
    state = {}
    for key, value in _flatten(params):
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if key.endswith("loc_conv.kernel"):
            arr = arr.transpose(2, 1, 0)
        elif key.endswith(".kernel") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def to_flax(state) -> dict:
    """State dict (or any name -> tensor mapping) -> nested numpy tree in
    the flax layout; the inverse of ``from_flax``."""
    tree: dict = {}
    for key, value in state.items():
        arr = value.detach().float().cpu().numpy().copy()
        if key.endswith("loc_conv.kernel"):
            arr = arr.transpose(2, 1, 0)
        elif key.endswith(".kernel") and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        node = tree
        *path, leaf = key.split(".")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


# ---------------------------------------------------------------------------
# numpy initialisers, matching the flax ones in distribution
# ---------------------------------------------------------------------------


def _xavier_uniform(rng, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-limit, limit, shape)


def _orthogonal(rng, shape):
    rows, cols = shape
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    return q.T if rows < cols else q


def _lecun_normal(rng, shape, fan_in):
    # truncated at two standard deviations, rescaled to unit variance
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = rng.standard_normal(shape)
    while np.any(np.abs(x) > 2.0):
        bad = np.abs(x) > 2.0
        x[bad] = rng.standard_normal(int(bad.sum()))
    return x * std


def _embedding(rng, vocab, dim):
    # flax nn.Embed: variance scaling 1.0, fan_in = dim, normal
    return rng.standard_normal((vocab, dim)) / np.sqrt(dim)


def _lstm_cell(rng, d, h):
    return {"bias": _lstm_bias(h), "wh": _orthogonal(rng, (h, 4 * h)),
            "wx": _xavier_uniform(rng, (d, 4 * h))}


def _lstm_bias(h):
    b = np.zeros((4 * h,))
    b[h:2 * h] = 1.0  # forget gate
    return b


def blstm_params(rng, d, h):
    return {
        "bias": np.stack([_lstm_bias(h)] * 2),
        "wh": np.stack([_orthogonal(rng, (h, 4 * h)) for _ in range(2)]),
        "wx": np.stack([_xavier_uniform(rng, (d, 4 * h)) for _ in range(2)]),
    }


def dense_params(rng, d_in, d_out, bias=True):
    p = {"kernel": _lecun_normal(rng, (d_in, d_out), d_in)}
    if bias:
        p["bias"] = np.zeros((d_out,))
    return p


def _conv2d(rng, c_in, c_out, kh=3, kw=3):
    return {
        "bias": np.zeros((c_out,)),
        "kernel": _lecun_normal(rng, (kh, kw, c_in, c_out), kh * kw * c_in),
    }


def init_disc_params(dcfg: DiscriminatorConfig, seed: int = 0) -> dict:
    """Flax-layout parameter tree of ``Discriminator(dcfg)``: one strided
    conv per channel count, then the (D' * C, 1) score projection."""
    rng = np.random.default_rng(seed)
    tree = {}
    c_in, d = 1, dcfg.input_dim
    for i, ch in enumerate(dcfg.channels):
        tree[f"conv{i}"] = _conv2d(rng, c_in, ch, *dcfg.kernel)
        c_in, d = ch, (d + 1) // 2
    tree["out"] = dense_params(rng, d * c_in, 1)
    return _as_f32(tree)


def init_params(jcfg: JointConfig, seed: int = 0) -> dict:
    """Flax-layout parameter tree of ``RobustE2E(jcfg)``, made with numpy."""
    rng = np.random.default_rng(seed)
    enh, e2e = jcfg.enhancer, jcfg.e2e
    enc, att, dec = e2e.encoder, e2e.attention, e2e.decoder

    enhancer = {}
    d = enh.input_dim
    for i in range(enh.num_layers):
        enhancer[f"blstm{i}"] = blstm_params(rng, d, enh.hidden_dim)
        d = 2 * enh.hidden_dim
    enhancer["mask_out"] = dense_params(rng, d, enh.input_dim)

    vgg = {}
    c_in = 1
    for i, ch in enumerate(enc.vgg_channels):
        vgg[f"conv{i}_1"] = _conv2d(rng, c_in, ch)
        vgg[f"conv{i}_2"] = _conv2d(rng, ch, ch)
        c_in = ch
    blstmp = {}
    d = ((enc.input_dim + 1) // 2 + 1) // 2 * enc.vgg_channels[-1]
    for i in range(enc.num_layers):
        blstmp[f"blstm{i}"] = blstm_params(rng, d, enc.hidden_dim)
        blstmp[f"proj{i}"] = dense_params(rng, 2 * enc.hidden_dim,
                                          enc.proj_dim)
        d = enc.proj_dim
    e_dim = enc.proj_dim

    # the attention subtree of ``att.variant``, drawn in the flax tree's
    # key order: AttLoc gvec, loc_conv, mlp_dec, mlp_loc; AttAdd gvec,
    # mlp_dec; AttDot mlp_dec
    attn = {}
    if att.variant in ("location", "add"):
        attn["gvec"] = dense_params(rng, att.dim, 1, bias=False)
    if att.variant == "location":
        attn["loc_conv"] = {"kernel": _lecun_normal(
            rng, (att.conv_kernel, 1, att.conv_channels), att.conv_kernel)}
    attn["mlp_dec"] = dense_params(rng, dec.hidden_dim, att.dim, bias=False)
    if att.variant == "location":
        attn["mlp_loc"] = dense_params(rng, att.conv_channels, att.dim,
                                       bias=False)
    step = {
        "att": attn,
        "embed": {"embedding": _embedding(rng, dec.vocab_size, dec.embed_dim)},
        "output": dense_params(rng, dec.hidden_dim + e_dim, dec.vocab_size),
    }
    d = dec.embed_dim + e_dim
    for i in range(dec.num_layers):
        step[f"lstm{i}"] = _lstm_cell(rng, d, dec.hidden_dim)
        d = dec.hidden_dim

    tree = {
        "asr": {
            "ctc": {"ctc_lo": dense_params(rng, e_dim, dec.vocab_size)},
            "decoder": {
                "enc_projection": {
                    "mlp_enc": dense_params(rng, e_dim, att.dim,
                                      bias=att.enc_proj_bias)
                },
                "step_mod": step,
            },
            "encoder": {"blstmp": blstmp, "vgg": vgg},
        },
        "enhancer": enhancer,
    }
    return _as_f32(tree)


def init_lm_params(lmcfg: LMConfig, seed: int = 0) -> dict:
    """Flax-layout parameter tree of ``RNNLM(lmcfg)``, made with numpy."""
    rng = np.random.default_rng(seed)
    step = {"embed": {"embedding": _embedding(rng, lmcfg.vocab_size,
                                              lmcfg.embed_dim)}}
    d = lmcfg.embed_dim
    for i in range(lmcfg.num_layers):
        step[f"lstm{i}"] = _lstm_cell(rng, d, lmcfg.hidden_dim)
        d = lmcfg.hidden_dim
    step["output"] = dense_params(rng, lmcfg.hidden_dim, lmcfg.vocab_size)
    return _as_f32({"step_mod": step})


def _as_f32(tree):
    return {
        k: _as_f32(v) if isinstance(v, dict) else v.astype(np.float32)
        for k, v in tree.items()
    }
