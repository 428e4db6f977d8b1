"""Weights from a seed, in the port's state-dict layout.

``layout(cfg)`` lists every parameter of the generator (enhancer + ASR),
the discriminator and the RNNLM with its shape and fan-in, from a
configuration file's fields alone: the benchmark imports nothing of the
program to make them. ``make(...)`` draws all of one model's values in one
call of a ``torch.Generator`` on the device, uniform in +-1/sqrt(fan-in)
(PyTorch's default for its LSTM and linear layers), float32 as the
program keeps its master weights. The program and the reference are both
handed these tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], int]  # key, shape, fan-in


def _blstm(prefix: str, d: int, h: int) -> List[Leaf]:
    return [(f"{prefix}.wx", (2, d, 4 * h), d),
            (f"{prefix}.wh", (2, h, 4 * h), h),
            (f"{prefix}.bias", (2, 4 * h), h)]


def _dense(prefix: str, d: int, n: int, bias: bool = True) -> List[Leaf]:
    out = [(f"{prefix}.kernel", (d, n), d)]
    if bias:
        out.append((f"{prefix}.bias", (n,), d))
    return out


def _conv(prefix: str, c_in: int, c_out: int, kh: int, kw: int) -> List[Leaf]:
    fan = c_in * kh * kw
    return [(f"{prefix}.kernel", (c_out, c_in, kh, kw), fan),
            (f"{prefix}.bias", (c_out,), fan)]


def _cell(prefix: str, d: int, h: int) -> List[Leaf]:
    return [(f"{prefix}.wx", (d, 4 * h), h), (f"{prefix}.wh", (h, 4 * h), h),
            (f"{prefix}.bias", (4 * h,), h)]


def generator_layout(cfg: dict) -> List[Leaf]:
    """The generator's leaves (``RobustE2E.state_dict()`` order)."""
    enh, e2e = cfg["enhancer"], cfg["e2e"]
    enc, att, dec = e2e["encoder"], e2e["attention"], e2e["decoder"]
    out: List[Leaf] = []
    d = enh["input_dim"]
    for i in range(enh["num_layers"]):
        out += _blstm(f"enhancer.blstm{i}", d, enh["hidden_dim"])
        d = 2 * enh["hidden_dim"]
    out += _dense("enhancer.mask_out", d, enh["input_dim"])
    c_in = 1
    for i, ch in enumerate(enc["vgg_channels"]):
        out += _conv(f"asr.encoder.vgg.conv{i}_1", c_in, ch, 3, 3)
        out += _conv(f"asr.encoder.vgg.conv{i}_2", ch, ch, 3, 3)
        c_in = ch
    d = ((enc["input_dim"] + 1) // 2 + 1) // 2 * enc["vgg_channels"][-1]
    for i in range(enc["num_layers"]):
        out += _blstm(f"asr.encoder.blstmp.blstm{i}", d, enc["hidden_dim"])
        out += _dense(f"asr.encoder.blstmp.proj{i}", 2 * enc["hidden_dim"],
                      enc["proj_dim"])
        d = enc["proj_dim"]
    e, v = enc["proj_dim"], dec["vocab_size"]
    out += _dense("asr.ctc.ctc_lo", e, v)
    out += _dense("asr.decoder.enc_projection.mlp_enc", e, att["dim"],
                  att["enc_proj_bias"])
    p = "asr.decoder.step_mod"
    out.append((f"{p}.embed.embedding", (v, dec["embed_dim"]), 1))
    d = dec["embed_dim"] + e
    for i in range(dec["num_layers"]):
        out += _cell(f"{p}.lstm{i}", d, dec["hidden_dim"])
        d = dec["hidden_dim"]
    out += _dense(f"{p}.output", dec["hidden_dim"] + e, v)
    out.append((f"{p}.att.loc_conv.kernel",
                (att["conv_channels"], 1, att["conv_kernel"]),
                att["conv_kernel"]))
    out += _dense(f"{p}.att.mlp_loc", att["conv_channels"], att["dim"], False)
    out += _dense(f"{p}.att.mlp_dec", dec["hidden_dim"], att["dim"], False)
    out += _dense(f"{p}.att.gvec", att["dim"], 1, False)
    return out


def discriminator_layout(cfg: dict) -> List[Leaf]:
    dcfg = cfg["discriminator"]
    kh, kw = dcfg["kernel"]
    out: List[Leaf] = []
    c_in, d = 1, dcfg["input_dim"]
    for i, ch in enumerate(dcfg["channels"]):
        out += _conv(f"conv{i}", c_in, ch, kh, kw)
        c_in, d = ch, (d + 1) // 2
    return out + _dense("out", d * c_in, 1)


def lm_layout(lm: dict, vocab: int) -> List[Leaf]:
    """The RNNLM's leaves (``RNNLM.state_dict()``), for ``lm`` the traffic
    file's LMConfig fields."""
    p = "step_mod"
    out: List[Leaf] = [(f"{p}.embed.embedding", (vocab, lm["embed_dim"]), 1)]
    d = lm["embed_dim"]
    for i in range(lm["num_layers"]):
        out += _cell(f"{p}.lstm{i}", d, lm["hidden_dim"])
        d = lm["hidden_dim"]
    return out + _dense(f"{p}.output", lm["hidden_dim"], vocab)


def seed64(seed: int) -> int:
    """A seed of any size as the 64 bits a ``torch.Generator`` takes."""
    return int(seed) % (1 << 64)


# streams of one seed: the generator, the discriminator, the RNNLM
STREAMS = {"generator": 0, "discriminator": 1, "lm": 2}


def make(leaves: List[Leaf], seed: int, device, stream: str = "generator"
         ) -> Dict[str, torch.Tensor]:
    """Every leaf's values from ``seed``: one uniform draw on ``device``
    for the whole model, split into leaves and scaled by 1/sqrt(fan-in).
    Each model of a cell draws from its own stream of the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed64(seed) + STREAMS[stream] * 0x9E3779B97F4A7C15)
                    % (1 << 64))
    total = sum(_numel(shape) for _, shape, _ in leaves)
    flat = torch.rand(total, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for key, shape, fan in leaves:
        n = _numel(shape)
        out[key] = flat[at:at + n].view(shape).mul_(fan ** -0.5)
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
