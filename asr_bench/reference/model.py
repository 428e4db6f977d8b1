"""The plain reference of the measured model, in PyTorch, from a weights
dict in the port's state-dict layout.

Written from the model's equations (ESPnet's VGG-BLSTMP encoder, AttLoc
attention, LSTM decoder and CTC head; the mask enhancer and the conv
discriminator of Robust_e2e_gan) with the port's conventions: Kaldi fbank
framing, gate order i, f, g, o, pad frames that leave a BLSTM's state
unchanged, the JAX layouts of flattened feature maps, SAME padding. It
imports nothing of the program and takes nothing the program made.

Every matrix product and convolution goes through ``Prec``: "f32" (the
reference: float32 with TF32 off), "bf16" or "fp8" (the control: every
parameter leaf, and the operands and results of the products, rounded to
float8 e4m3 with a per-tensor scale, gradients to e5m2, float32
accumulation). Elementwise arithmetic is float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MASK_MIN = -1e9


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

def _round(x: torch.Tensor, mode: str, grad: bool = False) -> torch.Tensor:
    if mode == "f32":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode != "fp8":
        raise ValueError(f"unknown precision {mode!r}")
    dt = torch.float8_e5m2 if grad else torch.float8_e4m3fn
    top = 57344.0 if grad else 448.0
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dt).float() * scale


class _Q(torch.autograd.Function):
    """Round a tensor forward (an operand, or a product's result as the
    program stores it in its compute dtype); round its gradient back."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _round(x, mode)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode, grad=True), None


class Prec:
    """Where the reference rounds: the parameters as it holds them, and
    the operands and results of its products."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def q(self, x):
        return x if self.mode == "f32" else _Q.apply(x, self.mode)

    def held(self, w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every parameter leaf rounded as a model held in this precision
        holds it (biases and tables too, as the program keeps them in its
        compute dtype)."""
        if w is None or self.mode == "f32":
            return w
        return {k: self.q(v) for k, v in w.items()}

    def mm(self, a, b):
        return self.q(self.q(a) @ self.q(b))

    def conv2d(self, x, w, **kw):
        return self.q(F.conv2d(self.q(x), self.q(w), **kw))

    def conv1d(self, x, w, **kw):
        return self.q(F.conv1d(self.q(x), self.q(w), **kw))


def no_tf32():
    """Float32 products in float32 (TF32 off); returns the old flags."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


# --------------------------------------------------------------------------
# frontend: Kaldi fbank (snip edges, DC removal, pre-emphasis 0.97, povey
# window, power spectrum, log mel, per-utterance CMVN)
# --------------------------------------------------------------------------

def num_frames(n: int, fcfg: dict) -> int:
    if n < fcfg["frame_length"]:
        return 0
    return 1 + (n - fcfg["frame_length"]) // fcfg["frame_shift"]


def frame_lengths(wav_lengths: torch.Tensor, fcfg: dict) -> torch.Tensor:
    return torch.clamp_min(torch.div(
        wav_lengths - fcfg["frame_length"], fcfg["frame_shift"],
        rounding_mode="floor") + 1, 0)


def length_mask(t: int, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None]).float()


def _window(fcfg: dict) -> np.ndarray:
    n = fcfg["frame_length"]
    x = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * x / (n - 1))
    kind = fcfg["window"]
    if kind == "povey":
        return hann ** 0.85
    if kind == "hann":
        return hann
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * x / (n - 1))
    raise ValueError(f"unknown window {kind!r}")


def _mel_fb(fcfg: dict) -> np.ndarray:
    """Triangular filters on the 1127 ln(1 + f/700) mel scale, (F, M)."""
    n_fft, sr = fcfg["n_fft"], fcfg["sample_rate"]
    f_max = fcfg["f_max"] if fcfg["f_max"] is not None else sr / 2.0

    def mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)

    fft_mel = mel(np.arange(n_fft // 2 + 1) * sr / n_fft)
    c = np.linspace(mel(fcfg["f_min"]), mel(f_max), fcfg["n_mels"] + 2)
    left, mid, right = c[:-2], c[1:-1], c[2:]
    up = (fft_mel[:, None] - left) / (mid - left)
    down = (right - fft_mel[:, None]) / (right - mid)
    return np.maximum(0.0, np.minimum(up, down))


def stft_power(p: Prec, wav: torch.Tensor, wav_lengths: torch.Tensor,
               fcfg: dict):
    """(B, N) -> (power (B, T, F) with pad frames zeroed, frame mask)."""
    flen, shift, n_fft = (fcfg["frame_length"], fcfg["frame_shift"],
                          fcfg["n_fft"])
    t = num_frames(wav.shape[-1], fcfg)
    frames = wav.float().unfold(-1, flen, shift)[:, :t]
    dev = wav.device
    if fcfg["remove_dc"]:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if fcfg["preemphasis"] > 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - fcfg["preemphasis"] * prev
    frames = frames * torch.tensor(_window(fcfg), dtype=torch.float32,
                                   device=dev)
    k = np.arange(flen, dtype=np.float64)[:, None]
    f = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    cos_m = torch.tensor(np.cos(ang), dtype=torch.float32, device=dev)
    sin_m = torch.tensor(np.sin(ang), dtype=torch.float32, device=dev)
    re, im = p.mm(frames, cos_m), p.mm(frames, sin_m)
    power = re * re + im * im
    if not fcfg["use_power"]:
        power = torch.sqrt(torch.clamp_min(power, 0.0))
    fmask = length_mask(t, frame_lengths(wav_lengths, fcfg))
    return power * fmask[..., None], fmask


def log_mel(p: Prec, power: torch.Tensor, fcfg: dict) -> torch.Tensor:
    fb = torch.tensor(_mel_fb(fcfg), dtype=torch.float32, device=power.device)
    return torch.log(torch.clamp_min(p.mm(power, fb), fcfg["log_floor"]))


def utterance_cmvn(feats: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
    m = fmask[..., None]
    denom = torch.clamp_min(m.sum(dim=-2, keepdim=True), 1.0)
    mean = (feats * m).sum(dim=-2, keepdim=True) / denom
    var = (torch.square(feats - mean) * m).sum(dim=-2, keepdim=True) / denom
    return (feats - mean) * torch.rsqrt(var + 1e-8) * m


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def dense(p: Prec, w: Dict[str, torch.Tensor], name: str,
          x: torch.Tensor) -> torch.Tensor:
    y = p.mm(x.reshape(-1, x.shape[-1]), w[f"{name}.kernel"])
    y = y.reshape(x.shape[:-1] + (y.shape[-1],))
    bias = w.get(f"{name}.bias")
    return y if bias is None else y + bias


def blstm(p: Prec, w, name: str, x: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H): both directions, the backward one over the
    flipped padded sequence, where the pad frames come first and leave the
    zero state alone."""
    wx, wh, bias = w[f"{name}.wx"], w[f"{name}.wh"], w[f"{name}.bias"]
    b, t, d = x.shape
    hdim = wh.shape[1]
    gx = p.mm(x.reshape(b * t, d), wx.permute(1, 0, 2).reshape(d, -1))
    gx = gx.view(b, t, 2, -1) + bias
    gxs = torch.stack([gx[:, :, 0], gx[:, :, 1].flip(1)])  # (2, B, T, 4H)
    ms = torch.stack([mask, mask.flip(1)])
    h = x.new_zeros((2, b, hdim))
    c = x.new_zeros((2, b, hdim))
    whq = p.q(wh)
    ys = []
    for i in range(t):
        gates = gxs[:, :, i] + p.q(torch.bmm(p.q(h), whq))
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        m = ms[:, :, i, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        ys.append(h * m)
    ys = torch.stack(ys, dim=2)
    return torch.cat([ys[0], ys[1].flip(1)], dim=-1)


def lstm_cell(p: Prec, w, name: str, carry, x):
    h, c = carry
    gates = (p.mm(x, w[f"{name}.wx"]) + p.mm(h, w[f"{name}.wh"])
             + w[f"{name}.bias"])
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h = torch.sigmoid(go) * torch.tanh(c)
    return h, c


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(p: Prec, w, name: str, x: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    kern = w[f"{name}.kernel"]
    (t0, t1), (f0, f1) = (_same(x.shape[2], kern.shape[2], stride),
                          _same(x.shape[3], kern.shape[3], stride))
    x = F.pad(x, (f0, f1, t0, t1))
    return p.conv2d(x, kern, stride=stride) + w[f"{name}.bias"][:, None, None]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def enhance(p: Prec, w, cfg: dict, power: torch.Tensor, fmask: torch.Tensor):
    """(enhanced power, T-F mask, the mask's logits before the sigmoid),
    pad frames of the first two zeroed."""
    ecfg = cfg["enhancer"]
    comp = ecfg["compression"]
    if comp == "log1p":
        h = torch.log1p(power)
    elif comp == "log":
        h = torch.log(torch.clamp_min(power, 1e-7))
    else:
        h = power
    for i in range(ecfg["num_layers"]):
        h = blstm(p, w, f"enhancer.blstm{i}", h, fmask)
    logits = dense(p, w, "enhancer.mask_out", h)
    mask = torch.sigmoid(logits)
    if ecfg["mask_floor"] > 0.0:
        mask = ecfg["mask_floor"] + (1.0 - ecfg["mask_floor"]) * mask
    fm = fmask[..., None]
    return mask * power * fm, mask * fm, logits


def features(p: Prec, w, cfg: dict, wav, wav_lengths, use_enhancer: bool):
    """-> (feats (B, T, M), fmask, the enhancer's mask logits or None): the
    encoder's input."""
    fcfg = cfg["e2e"]["frontend"]
    power, fmask = stft_power(p, wav, wav_lengths, fcfg)
    logits = None
    if use_enhancer:
        power, _, logits = enhance(p, w, cfg, power, fmask)
    feats = utterance_cmvn(log_mel(p, power, fcfg), fmask)
    return feats, fmask, logits


def encode(p: Prec, w, cfg: dict, feats: torch.Tensor, fmask: torch.Tensor):
    """VGG2L + BLSTMP -> (hs, hmask, hlens)."""
    enc = cfg["e2e"]["encoder"]
    h = feats[:, None]
    for i in range(len(enc["vgg_channels"])):
        h = F.relu(conv2d_same(p, w, f"asr.encoder.vgg.conv{i}_1", h))
        h = F.relu(conv2d_same(p, w, f"asr.encoder.vgg.conv{i}_2", h))
        h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    b, c, t, d = h.shape
    h = h.permute(0, 2, 3, 1).reshape(b, t, d * c)
    flens = fmask.sum(dim=1).long()
    hlens = torch.div(torch.div(flens + 1, 2, rounding_mode="floor") + 1, 2,
                      rounding_mode="floor")
    hmask = length_mask(t, hlens)
    h = h * hmask[..., None]
    for i in range(enc["num_layers"]):
        h = blstm(p, w, f"asr.encoder.blstmp.blstm{i}", h, hmask)
        h = torch.tanh(dense(p, w, f"asr.encoder.blstmp.proj{i}", h))
        h = h * hmask[..., None]
    return h, hmask, hlens


def ctc_logits(p: Prec, w, hs):
    return dense(p, w, "asr.ctc.ctc_lo", hs)


def decoder_teacher_forced(p: Prec, w, cfg: dict, hs, hmask, ys_in):
    """Logits (B, S, V) of the attention decoder fed ``ys_in`` (B, S)."""
    e2e = cfg["e2e"]
    att_cfg, dec = e2e["attention"], e2e["decoder"]
    pre = "asr.decoder.step_mod"
    enc_proj = dense(p, w, "asr.decoder.enc_projection.mlp_enc", hs)
    b, t, _ = hs.shape
    layers = dec["num_layers"]
    h = [hs.new_zeros((b, dec["hidden_dim"])) for _ in range(layers)]
    c = [hs.new_zeros((b, dec["hidden_dim"])) for _ in range(layers)]
    att = hmask / torch.clamp_min(hmask.sum(dim=-1, keepdim=True), 1.0)
    emb_table = w[f"{pre}.embed.embedding"]
    loc_k = w[f"{pre}.att.loc_conv.kernel"]
    g = w[f"{pre}.att.gvec.kernel"][:, 0]
    out = []
    for i in range(ys_in.shape[1]):
        emb = emb_table[torch.clamp_min(ys_in[:, i], 0).long()]
        feat = p.conv1d(att[:, None], loc_k, padding="same")  # (B, C, T)
        loc = dense(p, w, f"{pre}.att.mlp_loc", feat.transpose(1, 2))
        dz = dense(p, w, f"{pre}.att.mlp_dec", h[-1])
        e = (torch.tanh(enc_proj + loc + dz[:, None]) * g).sum(dim=-1)
        e = torch.where(hmask > 0, att_cfg["sharpening"] * e, MASK_MIN)
        att = torch.softmax(e, dim=-1) * hmask
        att = att / torch.clamp_min(att.sum(dim=-1, keepdim=True), 1e-8)
        ctx = torch.einsum("bt,bte->be", att, hs)
        x = torch.cat([emb, ctx], dim=-1)
        for li in range(layers):
            h[li], c[li] = lstm_cell(p, w, f"{pre}.lstm{li}", (h[li], c[li]),
                                     x)
            x = h[li]
        out.append(dense(p, w, f"{pre}.output", torch.cat([x, ctx], dim=-1)))
    return torch.stack(out, dim=1)


def lm_teacher_forced(p: Prec, w, lm: dict, ys_in):
    """RNNLM logits (B, S, V) fed ``ys_in`` (B, S)."""
    b = ys_in.shape[0]
    dev = ys_in.device
    h = [torch.zeros((b, lm["hidden_dim"]), device=dev)
         for _ in range(lm["num_layers"])]
    c = [x.clone() for x in h]
    out = []
    for i in range(ys_in.shape[1]):
        x = w["step_mod.embed.embedding"][torch.clamp_min(ys_in[:, i], 0)
                                          .long()]
        for li in range(lm["num_layers"]):
            h[li], c[li] = lstm_cell(p, w, f"step_mod.lstm{li}",
                                     (h[li], c[li]), x)
            x = h[li]
        out.append(dense(p, w, "step_mod.output", x))
    return torch.stack(out, dim=1)


def discriminator(p: Prec, w, cfg: dict, feats, fmask) -> torch.Tensor:
    """(B, T, D) log-mel maps -> (B,) scores, pad frames out of the
    pooling."""
    dcfg = cfg["discriminator"]
    h = (feats * fmask[..., None])[:, None]
    for i in range(len(dcfg["channels"])):
        h = conv2d_same(p, w, f"conv{i}", h, stride=2)
        h = torch.where(h >= 0, h, 0.2 * h)
    b, c, tt, dd = h.shape
    h = h.permute(0, 2, 3, 1).reshape(b, tt, dd * c)
    sub = fmask.sum(dim=1).long()
    for _ in dcfg["channels"]:
        sub = torch.div(sub + 1, 2, rounding_mode="floor")
    m = length_mask(tt, sub)
    pooled = (h * m[..., None]).sum(dim=1) / torch.clamp_min(
        m.sum(dim=1, keepdim=True), 1.0)
    return dense(p, w, "out", pooled)[..., 0]


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def add_sos_eos(ys: torch.Tensor, sos: int, eos: int, ignore: int):
    b, s = ys.shape
    lengths = (ys != ignore).sum(dim=1)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=ys.dtype,
                                  device=ys.device),
                       torch.where(ys == ignore, 0, ys)], dim=1)
    pos = torch.arange(s + 1, device=ys.device)[None, :]
    padded = torch.cat([ys, torch.full((b, 1), ignore, dtype=ys.dtype,
                                       device=ys.device)], dim=1)
    ys_out = torch.where(pos == lengths[:, None], eos, padded)
    ys_out = torch.where(pos > lengths[:, None], ignore, ys_out)
    return ys_in, ys_out


def asr_loss(p: Prec, w, cfg: dict, feats, fmask, ys):
    """(loss, loss_ctc, loss_att): mtlalpha * CTC (per label token, mean
    over the batch) + (1 - mtlalpha) * cross entropy per valid token."""
    e2e = cfg["e2e"]
    ignore = e2e["ignore_id"]
    hs, hmask, hlens = encode(p, w, cfg, feats, fmask)
    lp = torch.log_softmax(ctc_logits(p, w, hs), dim=-1)
    lab_len = (ys != ignore).sum(dim=1)
    nll = F.ctc_loss(lp.transpose(0, 1), torch.where(ys == ignore, 0, ys),
                     hlens, lab_len, blank=e2e["blank_id"], reduction="none")
    loss_ctc = (nll / torch.clamp_min(lab_len.float(), 1.0)).mean()
    ys_in, ys_out = add_sos_eos(ys, e2e["sos_id"], e2e["eos_id"], ignore)
    logits = decoder_teacher_forced(p, w, cfg, hs, hmask, ys_in)
    valid = (ys_out != ignore).float()
    lpa = torch.log_softmax(logits, dim=-1)
    tgt = torch.clamp_min(ys_out, 0).long()
    ce = -torch.gather(lpa, -1, tgt[..., None])[..., 0]
    loss_att = (ce * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    a = e2e["mtlalpha"]
    return a * loss_ctc + (1.0 - a) * loss_att, loss_ctc, loss_att


def enhancement_loss(enhanced, clean, fmask, kind: str) -> torch.Tensor:
    diff = (torch.log1p(torch.clamp_min(enhanced, 0.0))
            - torch.log1p(torch.clamp_min(clean, 0.0)))
    per = torch.abs(diff) if kind == "l1" else torch.square(diff)
    m = fmask[..., None]
    return (per * m).sum() / torch.clamp_min(m.sum() * per.shape[-1], 1.0)


def gan_losses(d_real, d_fake, kind: str):
    """(loss_D, loss_G_adv): lsgan halves, or sigmoid cross entropy."""
    if kind == "lsgan":
        return (0.5 * (torch.mean((d_real - 1.0) ** 2)
                       + torch.mean(d_fake ** 2)),
                0.5 * torch.mean((d_fake - 1.0) ** 2))
    if kind == "bce":
        return (torch.mean(F.softplus(-d_real))
                + torch.mean(F.softplus(d_fake)),
                torch.mean(F.softplus(-d_fake)))
    raise ValueError(f"unknown gan loss {kind!r}")


def joint_terms(p: Prec, wg, cfg: dict, noisy, clean, wav_lengths,
                with_asr: bool, ys: Optional[torch.Tensor] = None):
    """The generator's forward of the joint objective: enhanced, clean and
    noisy spectra, their log mels (no CMVN) and, with ``with_asr``, the
    ASR losses of the enhanced speech."""
    fcfg = cfg["e2e"]["frontend"]
    noisy_power, fmask = stft_power(p, noisy, wav_lengths, fcfg)
    clean_power, _ = stft_power(p, clean, wav_lengths, fcfg)
    enhanced = enhance(p, wg, cfg, noisy_power, fmask)[0]
    out = {"enhanced": enhanced, "clean": clean_power, "fmask": fmask,
           "enhanced_logmel": log_mel(p, enhanced, fcfg),
           "clean_logmel": log_mel(p, clean_power, fcfg)}
    if with_asr:
        feats = utterance_cmvn(out["enhanced_logmel"], fmask)
        out["loss_asr"], out["loss_ctc"], out["loss_att"] = asr_loss(
            p, wg, cfg, feats, fmask, ys)
    return out
