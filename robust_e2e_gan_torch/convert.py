"""Parameters between the flax layout and the port's state dict.

The port keeps the flax parameter names and layouts, so a state-dict key is
the flax path joined with dots (``asr.decoder.step_mod.lstm0.wx``) and
dense and LSTM weights copy as they are. Convolution kernels are the one
exception: they are transposed once, to the layout ``F.conv2d`` and
``F.conv1d`` take.

``init_params`` builds a tree in the flax layout with numpy alone, drawn
from the same distributions as the flax initialisers (``models/rnn.py``,
flax's lecun-normal dense and conv kernels, normal embeddings), so a caller
without JAX gets weights at the real scale.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from robust_e2e_gan_torch.config import JointConfig


def _flatten(tree, prefix=""):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, key + ".")
        else:
            yield key, value


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


def _conv2d(rng, c_in, c_out):
    return {
        "bias": np.zeros((c_out,)),
        "kernel": _lecun_normal(rng, (3, 3, c_in, c_out), 9 * c_in),
    }


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

    step = {
        "att": {
            "gvec": dense_params(rng, att.dim, 1, bias=False),
            "loc_conv": {
                "kernel": _lecun_normal(
                    rng, (att.conv_kernel, 1, att.conv_channels),
                    att.conv_kernel,
                )
            },
            "mlp_dec": dense_params(rng, dec.hidden_dim, att.dim, bias=False),
            "mlp_loc": dense_params(rng, att.conv_channels, att.dim,
                                    bias=False),
        },
        "embed": {
            "embedding": rng.standard_normal((dec.vocab_size, dec.embed_dim))
            / np.sqrt(dec.embed_dim)
        },
        "output": dense_params(rng, dec.hidden_dim + e_dim, dec.vocab_size),
    }
    d = dec.embed_dim + e_dim
    for i in range(dec.num_layers):
        step[f"lstm{i}"] = {
            "bias": _lstm_bias(dec.hidden_dim),
            "wh": _orthogonal(rng, (dec.hidden_dim, 4 * dec.hidden_dim)),
            "wx": _xavier_uniform(rng, (d, 4 * dec.hidden_dim)),
        }
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


def _as_f32(tree):
    return {
        k: _as_f32(v) if isinstance(v, dict) else v.astype(np.float32)
        for k, v in tree.items()
    }
