"""Operations and bytes the model's work needs, counted from a cell's
shapes and valid frames, and the card's peaks.

A kernel's roofline bound is max(operations / the peak of its operands'
type, bytes / HBM bandwidth), each input read once and each output written
once, over the frames these inputs have (not the padded ones); a share is
the bound's sum over the calls divided by the device time of the kernels
that computed them. Model FLOPs are the products and convolutions of the
forward (and, for a train step, its backward) at the same frames. The
counts do not depend on which route or kernel computes them.
"""

from __future__ import annotations

from typing import List, Sequence

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------

def stft_frames(wav_lengths: Sequence[int], fcfg: dict) -> List[int]:
    flen, shift = fcfg["frame_length"], fcfg["frame_shift"]
    return [max((n - flen) // shift + 1, 0) for n in wav_lengths]


def enc_frames(frames: Sequence[int]) -> List[int]:
    """Frames after the two ceil-mode 2x2 pools."""
    return [((n + 1) // 2 + 1) // 2 for n in frames]


# --------------------------------------------------------------------------
# kernel functions: (flops, bytes)
# --------------------------------------------------------------------------

def blstm_infer(frames: Sequence[int], d: int, h: int, x_itemsize: int,
                itemsize: int = 2):
    """One inference BLSTM layer, both directions: x @ W_x + h @ W_h a
    frame; x, W_x, W_h, bias in, y out."""
    n = sum(frames)
    flops = n * 2 * 2 * (d + h) * 4 * h
    nbytes = (n * d * x_itemsize + 2 * (d + h) * 4 * h * itemsize
              + 2 * 4 * h * 4 + len(frames) * 4 + n * 2 * h * itemsize)
    return flops, nbytes


def blstm_train(frames: Sequence[int], d: int, h: int, x_itemsize: int,
                dx: bool, itemsize: int = 2):
    """One training BLSTM layer, forward and backward, both directions:
    the forward's products, the backward's recurrent product, dW_h, dW_x
    and (where the input needs it) dx; x, weights, bias, dy in, y and the
    gradients out."""
    n = sum(frames)
    per = 2 * 2 * 4 * h
    flops = n * per * ((d + h) + (h + h + d) + (d if dx else 0))
    nbytes = (n * d * x_itemsize + 2 * (d + h) * 4 * h * itemsize
              + 2 * 4 * h * 4 + n * 2 * h * itemsize * 2
              + (n * d * x_itemsize if dx else 0)
              + 2 * (d + h) * 4 * h * itemsize + 2 * 4 * h * 4)
    return flops, nbytes


def att_loc_step(hframes: Sequence[int], k: int, c: int, a: int, e: int,
                 itemsize: int = 2):
    """One beam step of location attention over K hypotheses an
    utterance: the location projection, the score's dot with g, the
    context; location features, enc_proj, enc, dec, W_loc, g and the mask
    in, the float32 context and alignment out."""
    n = sum(hframes)
    b = len(hframes)
    flops = k * n * 2 * (c * a + a + e)
    nbytes = ((k * n * c + n * a + n * e + b * k * a + c * a + a + n)
              * itemsize + b * k * e * 4 + k * n * 4)
    return flops, nbytes


def lm_step(lanes: int, e: int, h: int, v: int, layers: int = 1,
            itemsize: int = 4):
    """One RNNLM step over ``lanes`` hypotheses: the cells' gate products
    and the readout; the embedding rows, weights and state in, the state
    and logits out."""
    flops = lanes * (2 * (e + h) * 4 * h + 2 * (layers - 1) * 2 * h * 4 * h
                     + 2 * h * v)
    weights = ((e + h) * 4 * h + (layers - 1) * 2 * h * 4 * h
               + layers * 4 * h + h * v + v)
    nbytes = (lanes * 4 + min(lanes, v) * e * itemsize + weights * itemsize
              + 4 * lanes * layers * h * itemsize + lanes * v * itemsize)
    return flops, nbytes


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------

def _vgg(frames: Sequence[int], d: int, chans: Sequence[int]) -> float:
    total, c_in = 0.0, 1
    t = list(frames)
    for ch in chans:
        pos = sum(t) * d
        total += pos * 2 * 9 * (c_in * ch + ch * ch)
        t = [(x + 1) // 2 for x in t]
        d = (d + 1) // 2
        c_in = ch
    return total


def _enhancer(frames, cfg) -> float:
    ecfg = cfg["enhancer"]
    n, h, d = sum(frames), ecfg["hidden_dim"], ecfg["input_dim"]
    total = 0.0
    for _ in range(ecfg["num_layers"]):
        total += n * 2 * 2 * (d + h) * 4 * h
        d = 2 * h
    return total + n * 2 * d * ecfg["input_dim"]


def _frontend(frames, fcfg) -> float:
    n = sum(frames)
    nf = fcfg["n_fft"] // 2 + 1
    return n * (2 * 2 * fcfg["frame_length"] * nf + 2 * nf * fcfg["n_mels"])


def vgg_out_dim(enc: dict) -> int:
    """The width of the first BLSTMP layer's input: the mel bins after the
    two ceil-mode pools, times the last VGG block's channels."""
    return ((enc["input_dim"] + 1) // 2 + 1) // 2 * enc["vgg_channels"][-1]


def _encoder(frames, cfg) -> float:
    enc = cfg["e2e"]["encoder"]
    hf = enc_frames(frames)
    n = sum(hf)
    total = _vgg(frames, enc["input_dim"], enc["vgg_channels"])
    d = vgg_out_dim(enc)
    h, p = enc["hidden_dim"], enc["proj_dim"]
    for _ in range(enc["num_layers"]):
        total += n * (2 * 2 * (d + h) * 4 * h + 2 * 2 * h * p)
        d = p
    return total


def _dec_step(hframes, k, cfg) -> float:
    """One decoder step over K hypotheses an utterance."""
    e2e = cfg["e2e"]
    att, dec = e2e["attention"], e2e["decoder"]
    e, a, c = e2e["encoder"]["proj_dim"], att["dim"], att["conv_channels"]
    h, v, emb = dec["hidden_dim"], dec["vocab_size"], dec["embed_dim"]
    n, b = sum(hframes), len(hframes)
    attn = k * n * 2 * (c * att["conv_kernel"] + c * a + a + e)
    cell = b * k * (2 * h * a + 2 * (emb + e + h) * 4 * h
                    + (dec["num_layers"] - 1) * 2 * 2 * h * 4 * h
                    + 2 * (h + e) * v)
    return attn + cell


def decode_batch_flops(wav_lengths: Sequence[int], cfg: dict, beam: dict,
                       use_enhancer: bool, lm: dict = None) -> float:
    """One batch through the searcher: frontend, enhancer, encoder, CTC
    and encoder projections, then ``max_steps`` beam steps over B x K
    hypotheses (attention, decoder cell, readout, and the LM's step)."""
    fcfg = cfg["e2e"]["frontend"]
    frames = stft_frames(wav_lengths, fcfg)
    hf = enc_frames(frames)
    e2e = cfg["e2e"]
    p = e2e["encoder"]["proj_dim"]
    total = _frontend(frames, fcfg) + _encoder(frames, cfg)
    if use_enhancer:
        total += _enhancer(frames, cfg)
    total += sum(hf) * 2 * p * (e2e["decoder"]["vocab_size"]
                                + e2e["attention"]["dim"])
    k, steps = beam["beam_size"], beam["max_steps"]
    per_step = _dec_step(hf, k, cfg)
    if lm is not None and beam.get("lm_weight", 0.0) != 0.0:
        per_step += lm_step(len(hf) * k, lm["embed_dim"], lm["hidden_dim"],
                            e2e["decoder"]["vocab_size"],
                            lm["num_layers"])[0]
    return total + steps * per_step


def _disc(frames, cfg) -> float:
    dcfg = cfg["discriminator"]
    kh, kw = dcfg["kernel"]
    t, d, c_in, total = list(frames), dcfg["input_dim"], 1, 0.0
    for ch in dcfg["channels"]:
        t, d = [(x + 1) // 2 for x in t], (d + 1) // 2
        total += sum(t) * d * 2 * kh * kw * c_in * ch
        c_in = ch
    return total + len(frames) * 2 * d * c_in


def train_step_flops(wav_lengths: Sequence[int], label_lengths: Sequence[int],
                     cfg: dict) -> float:
    """One joint step: 3 x the G-step's forward (frontend of the noisy and
    clean speech, enhancer, the ASR forward with its teacher-forced
    decoder, the discriminator on the enhanced and clean maps), plus the
    D-step's generator forward and its discriminator forward and backward
    on both maps."""
    fcfg = cfg["e2e"]["frontend"]
    frames = stft_frames(wav_lengths, fcfg)
    hf = enc_frames(frames)
    e2e = cfg["e2e"]
    p, v = e2e["encoder"]["proj_dim"], e2e["decoder"]["vocab_size"]
    gen = 2 * _frontend(frames, fcfg) + _enhancer(frames, cfg)
    disc = 2 * _disc(frames, cfg)
    asr = (_encoder(frames, cfg)
           + sum(hf) * 2 * p * (v + e2e["attention"]["dim"])
           + (max(label_lengths) + 1) * _dec_step(hf, 1, cfg))
    return 3 * (gen + asr + disc) + gen + 3 * disc
