"""The paper's claim on the GPU: joint adversarial training beats both no
enhancement and a cascade of a separately trained enhancer and a clean ASR.

    python -m robust_e2e_gan_torch.tools.adversarial_benefit [steps_a]
        [steps_c] [--lm] [--seed N] [--eval-utts N]
        [--optimizer adam|adadelta] [--scale toy|reference] [--lr LR]
        [--warmup W] [--bs B] [--ckpt-dir D [--save-every N]]
        [--out f.json] [--device cuda|cpu]

Port of ``scripts/adversarial_benefit.py`` with its constants (``SCFG``,
``jcfg_for``, ``TCFG``, ``PAD_TO``, the cascade's loss weights) and its
data stream, run with the BLSTM layers on the kernels
(``verify_drive.kernel_config``). One ``TrainState`` runs through the
three stages, on batches of ``bs`` hard-task utterances from
``default_rng(seed)`` (one batch drawn first, as the JAX script's
initialisation batch):

(a) ``steps_a`` clean-ASR pretraining steps, then the no-enhancement
    decode of the noisy eval set (``eval_utts`` utterances from
    ``default_rng(999)``, the same for every seed);
(b) ``2 * steps_c`` enhancement-GAN steps (``with_asr=False``, loss
    weights ``lambda_adv=0.1``, ``mu_enh=10``), then the cascade decode
    through the enhancer;
(c) ``steps_c`` joint adversarial steps, then the joint decode;
then, with ``--lm``, a char RNNLM (``LM_CFG``, ``lm_steps`` steps of 64
transcripts from the training stream) and the joint decode fused with it
at weight 0.3. Each decode is beam 4, CTC weight 0.3, ``max_label_len +
2`` steps, scored by token error rate and by word WER with a 1,000-fold
bootstrap interval.

Then the bfloat16 route gates on the joint model
(``verify_drive.route_gates``): ``route_batches`` further batches of
``bs`` from the eval generator, each route's token error rate within
``BF16_MARGIN`` of the bfloat16 default's. The summary holds the JAX
script's keys plus the ms per step of each stage (host clock ending in a
device synchronisation, synthesis left out), the seconds spent
synthesising batches, the route results and the card's name and power
limit. It goes to ``--out`` when given. The gate is the paper's ordering:
the joint word WER below both baselines'; a failed gate raises
``DriveFailure``. ``main(watch=...)`` wraps each section in
``watch(name)`` ("asr", "no_enhancement", "gan", "cascade", "joint",
"joint_decode", "lm", "lm_decode", "routes"), as ``verify_drive.main``
does.

With ``--ckpt-dir`` the run resumes as the JAX script's does
(``Progress``): one global step counts through the three stages; every
``--save-every`` steps the state (both modules, both optimizers, the
torch generators) is saved with the run args and the training stream's
generator state; the decoded stages' results go to the
``partial_results.json`` sidecar. Run again with the same args, the
tool restores the latest checkpoint, skips the batches its state took
without making them again, reuses the decoded stages and trains the LM
again; other args are refused, and so is a JAX checkpoint. A resumed
stage's ms per step counts the steps it ran, and a stage it skipped whole
has none (null). A run resumes only while its checkpoint directory
lives: a job that starts from a fresh copy of the repository starts the
run again.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from robust_e2e_gan_torch.config import (
    AttentionConfig,
    BeamSearchConfig,
    DecoderConfig,
    DiscriminatorConfig,
    E2EConfig,
    EncoderConfig,
    EnhancerConfig,
    FrontendConfig,
    JointConfig,
    LMConfig,
    TrainConfig,
)
from robust_e2e_gan_torch.data.synthetic import (
    SyntheticConfig,
    hard_task,
    labels_to_list,
    make_batch,
    sample_transcript,
    split_words,
)
from robust_e2e_gan_torch.decode.beam import make_beam_searcher
from robust_e2e_gan_torch.ops.editdistance import bootstrap_wer_ci, wer_details
from robust_e2e_gan_torch.tools.verify_drive import (
    ROUTE_BATCHES,
    gate,
    kernel_config,
    route_gates,
    synchronize,
    token_lists,
)
from robust_e2e_gan_torch.train.lm import init_lm_state, make_lm_train_step
from robust_e2e_gan_torch.train.loop import (
    device_batch,
    init_state,
    resolve_device,
)
from robust_e2e_gan_torch.train.steps import (
    TrainState,
    make_asr_pretrain_step,
    make_joint_train_step,
)
from robust_e2e_gan_torch.utils import checkpoint as ckpt
from robust_e2e_gan_torch.utils.build import build

# the hard task: 32-token vocabulary, multi-word transcripts, duration
# jitter, SNR over [-3, +5] dB, reverberation, babble and channel tilt
SCFG = hard_task(vocab_size=32)
VOCAB = SCFG.vocab_size
TCFG = TrainConfig(optimizer="adam", learning_rate=1e-3)
PAD_TO = SCFG.max_samples
# stage (b)'s loss weights: the separately trained enhancer is MSE-dominant
CASCADE_WEIGHTS = dict(lambda_adv=0.1, mu_enh=10.0)
LM_CFG = LMConfig(vocab_size=VOCAB, embed_dim=64, hidden_dim=256)
LM_BATCH = 64
LM_WEIGHT = 0.3
EVAL_SEED = 999
BOOTSTRAP = 1000
# the resume sidecar of each decoded stage's result, in the checkpoint dir
PARTIAL = "partial_results.json"


def jcfg_for(scale: str) -> JointConfig:
    """"toy", the fast configuration, or "reference", the reference's
    widths (3 x 512 BLSTMP encoder, 512 attention and decoder, 2 x 512
    enhancer, 80 mels, bfloat16 compute)."""
    if scale == "reference":
        return JointConfig(
            e2e=E2EConfig(
                frontend=FrontendConfig(n_mels=80),
                encoder=EncoderConfig(input_dim=80, vgg_channels=(64, 128),
                                      num_layers=3, hidden_dim=512,
                                      proj_dim=512),
                attention=AttentionConfig(dim=512, conv_channels=10,
                                          conv_kernel=201),
                decoder=DecoderConfig(vocab_size=VOCAB, embed_dim=512,
                                      hidden_dim=512),
            ),
            enhancer=EnhancerConfig(input_dim=257, num_layers=2,
                                    hidden_dim=512),
            discriminator=DiscriminatorConfig(input_dim=80,
                                              channels=(32, 64, 128)),
            mu_enh=3.0,
            compute_dtype="bfloat16",
        )
    if scale != "toy":
        raise ValueError(f"unknown scale {scale!r}")
    return JointConfig(
        e2e=E2EConfig(
            frontend=FrontendConfig(n_mels=40),
            encoder=EncoderConfig(input_dim=40, vgg_channels=(8, 16),
                                  num_layers=1, hidden_dim=96, proj_dim=96),
            attention=AttentionConfig(dim=64, conv_channels=8,
                                      conv_kernel=31),
            decoder=DecoderConfig(vocab_size=VOCAB, embed_dim=48,
                                  hidden_dim=96),
        ),
        enhancer=EnhancerConfig(input_dim=257, num_layers=2, hidden_dim=128),
        discriminator=DiscriminatorConfig(input_dim=40, channels=(8, 16)),
        mu_enh=3.0,
    )


def jcfg_cascade(jcfg: JointConfig) -> JointConfig:
    return dataclasses.replace(jcfg, **CASCADE_WEIGHTS)


def beam_config(scfg: SyntheticConfig, lm_weight: float = 0.0
                ) -> BeamSearchConfig:
    return BeamSearchConfig(beam_size=4, ctc_weight=0.3,
                            max_steps=scfg.max_label_len + 2,
                            lm_weight=lm_weight)


class Stream:
    """The synthetic batches of a run, made from generators the caller
    passes, and the seconds spent making them."""

    def __init__(self, scfg: SyntheticConfig):
        self.scfg = scfg
        self.seconds = 0.0

    def batch(self, bs: int, rng: np.random.Generator
              ) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        b = make_batch(bs, self.scfg, rng,
                       pad_to_samples=self.scfg.max_samples, ignore_id=-1)
        self.seconds += time.perf_counter() - t0
        return b

    def batches(self, n: int, bs: int, rng: np.random.Generator,
                skip_first: int = 0, synth_skipped: bool = True
                ) -> Iterator[Optional[Dict[str, np.ndarray]]]:
        """``n`` batches; the first ``skip_first`` are yielded as None, and
        still made unless ``synth_skipped`` is False, so that ``rng``
        advances as it did in the run being resumed (the caller that
        restored ``rng``'s state passes False)."""
        for i in range(n):
            if i < skip_first:
                if synth_skipped:
                    self.batch(bs, rng)
                yield None
            else:
                yield self.batch(bs, rng)

    def labels(self, bs: int, rng: np.random.Generator) -> np.ndarray:
        """(bs, max_label_len) transcripts padded with -1: an LM batch."""
        t0 = time.perf_counter()
        ys = np.full((bs, self.scfg.max_label_len), -1, np.int32)
        for i in range(bs):
            toks = sample_transcript(self.scfg, rng)
            ys[i, :len(toks)] = toks
        self.seconds += time.perf_counter() - t0
        return ys


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    if not torch.cuda.is_available():
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None


class Progress:
    """The run's global step across the stages, its checkpoints and its
    per-stage WER records (``scripts/adversarial_benefit.py:205-306``).

    With a ``ckpt_dir`` the state is saved after every global step g with
    (g + 1) % ``save_every`` == 0 (``save_checkpoint(..., keep=1)``, extra:
    ``global_step`` g, ``run_args`` and ``rng_state``, the training
    stream's bit-generator state ``rng``), and each decode's result goes
    to ``partial_results.json`` (written atomically). ``restore`` resumes
    from the latest checkpoint there. Without one it counts the steps."""

    def __init__(self, rng: np.random.Generator,
                 ckpt_dir: Optional[str] = None, save_every: int = 500,
                 run_args: Optional[dict] = None):
        self.ckpt_dir, self.save_every = ckpt_dir, save_every
        self.run_args, self.rng = run_args, rng
        self.gstep = 0
        self.done = -1  # the last global step the restored state took
        self.rng_restored = False
        self.partial: Dict[str, dict] = {}
        self.reused: List[str] = []
        self.steps_run: Dict[str, int] = {}
        self.save_seconds = 0.0
        self.partial_path = (os.path.join(ckpt_dir, PARTIAL) if ckpt_dir
                             else None)

    def restore(self, state: TrainState) -> None:
        """Load the latest checkpoint of ``ckpt_dir`` into ``state``, if
        there is one: the run args must equal this run's (else
        ``SystemExit`` naming each key that differs), the training
        stream's generator takes its saved state, and the stages recorded
        in the sidecar are reused. A JAX checkpoint raises
        ``NotImplementedError`` (``JAX_RESUME``)."""
        if not (self.ckpt_dir and ckpt.has_checkpoint(self.ckpt_dir)):
            return
        if ckpt.is_jax_checkpoint(self.ckpt_dir):
            raise NotImplementedError(ckpt.JAX_RESUME)
        extra = ckpt.read_extra(self.ckpt_dir)
        saved_args = extra.get("run_args")
        if saved_args is not None and saved_args != self.run_args:
            diff = {k: (saved_args.get(k), v)
                    for k, v in self.run_args.items()
                    if saved_args.get(k) != v}
            raise SystemExit(
                f"[resume] relaunch args differ from the checkpointed run "
                f"(ckpt vs now): {diff} — resuming would silently "
                f"fast-forward against a different data stream/stage "
                f"layout. Relaunch with the original args or use a fresh "
                f"--ckpt-dir.")
        if saved_args is None:
            print("[resume] WARNING: checkpoint predates run-arg recording; "
                  "cannot validate relaunch args match", flush=True)
        _, done_step = ckpt.restore_checkpoint(self.ckpt_dir, state)
        # saved at step g + 1 ("steps done") with global_step g
        self.done = int(extra.get("global_step", done_step - 1))
        if "rng_state" in extra:
            self.rng.bit_generator.state = extra["rng_state"]
            self.rng_restored = True
            print("[resume] rng state restored (skipping batch "
                  "resynthesis)", flush=True)
        if os.path.exists(self.partial_path):
            try:
                with open(self.partial_path) as f:
                    self.partial = json.load(f)
            except ValueError:  # a truncated sidecar: decode again
                print(f"[resume] WARNING: corrupt {PARTIAL}; ignoring "
                      "(stages will re-decode)", flush=True)
                self.partial = {}
        print(f"[resume] restored global step {self.done}, stages done: "
              f"{sorted(self.partial)}", flush=True)

    def skip(self, n_steps: int) -> int:
        """How many of the next stage's ``n_steps`` the restored state
        already took."""
        return min(max(self.done + 1 - self.gstep, 0), n_steps)

    def stepped(self, state: TrainState) -> None:
        """After global step ``gstep``'s update: save where it is due."""
        if self.ckpt_dir and (self.gstep + 1) % self.save_every == 0:
            t0 = time.perf_counter()
            ckpt.save_checkpoint(
                self.ckpt_dir, state, self.gstep + 1, keep=1,
                extra={"global_step": self.gstep,
                       "run_args": self.run_args,
                       "rng_state": self.rng.bit_generator.state})
            self.save_seconds += time.perf_counter() - t0

    def stage_eval(self, key: str, fn: Callable[[], dict],
                   label: str) -> dict:
        """``fn()``'s decode once a run: a resumed run reuses the
        sidecar's record of stage ``key``."""
        if key in self.partial:
            print(f"{label} (resumed): {self.partial[key]}", flush=True)
            self.reused.append(key)
            return self.partial[key]
        out = fn()
        print(f"{label}: {out}", flush=True)
        self.partial[key] = out
        if self.partial_path:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.ckpt_dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(self.partial, f)
            os.replace(tmp, self.partial_path)
        return out


def run_stage(tag: str, state: TrainState, step_fn, n_steps: int, bs: int,
              log_every: int, fmt: Callable, stream: Stream, dev,
              progress: Progress, step_hook=None) -> Optional[float]:
    """``n_steps`` of ``step_fn`` on batches of ``bs`` from the training
    stream, those the restored state took skipped; returns the ms per step
    that ran (host clock ending in a device synchronisation, synthesis and
    checkpoint writes left out), None where the restore skipped them all."""
    synchronize(dev)
    t0, synth0 = time.perf_counter(), stream.seconds
    save0 = progress.save_seconds
    m, ran = None, 0
    batches = stream.batches(n_steps, bs, progress.rng,
                             skip_first=progress.skip(n_steps),
                             synth_skipped=not progress.rng_restored)
    for i, b in enumerate(batches):
        if b is not None:
            if step_hook is not None:
                step_hook(progress.gstep, b, state)
            m = step_fn(state, device_batch(b, dev))
            ran += 1
            if i % log_every == 0:
                print(f"[{tag}] step {i} " + fmt(m), flush=True)
            progress.stepped(state)
        progress.gstep += 1
    synchronize(dev)
    progress.steps_run[tag] = ran
    if not ran:
        return None
    ms = ((time.perf_counter() - t0 - (stream.seconds - synth0)
           - (progress.save_seconds - save0)) / ran * 1e3)
    print(f"[{tag}] final {fmt(m)}; {ms:.2f} ms/step over {ran} steps",
          flush=True)
    return ms


def decode_wer(model, jcfg: JointConfig, eval_b, use_enhancer: bool, dev,
               scfg: SyntheticConfig = SCFG, lm=None,
               lm_weight: float = 0.0) -> dict:
    """Token error rate, word WER, reference words and the word WER's 95%
    utterance-bootstrap interval of one beam decode of ``eval_b``."""
    search = make_beam_searcher(model, jcfg.e2e, beam_config(scfg, lm_weight),
                                use_enhancer=use_enhancer, lm=lm)
    res = search(torch.from_numpy(eval_b["noisy_wav"]).to(dev),
                 torch.from_numpy(eval_b["wav_lengths"]).to(dev))
    hyps = token_lists(res.tokens)
    refs = labels_to_list(eval_b["labels"])
    ref_w = [split_words(r, scfg.space_id) for r in refs]
    hyp_w = [split_words(h, scfg.space_id) for h in hyps]
    words = wer_details(ref_w, hyp_w)
    ci = bootstrap_wer_ci(ref_w, hyp_w, n_resamples=BOOTSTRAP)
    return {"ter": wer_details(refs, hyps)["error_rate"],
            "wer": words["error_rate"],
            "ref_words": int(words["ref_tokens"]),
            "wer_ci95": [round(ci["ci_low"], 4), round(ci["ci_high"], 4)]}


def train_char_lm(lmcfg: LMConfig, stream: Stream, rng, steps: int,
                  bs: int, seed: int, dev, log_every: int = 200):
    """A char RNNLM on the task's transcripts (Adam 1e-3); (LM in eval
    mode, last perplexity, ms per step)."""
    lm_state = init_lm_state(lmcfg, TCFG, dev, seed=seed)
    step = make_lm_train_step()
    synchronize(dev)
    t0, synth0 = time.perf_counter(), stream.seconds
    m = None
    for i in range(steps):
        m = step(lm_state, torch.from_numpy(stream.labels(bs, rng)).to(dev))
        if i % log_every == 0:
            print(f"[lm] step {i} ppl={float(m['ppl']):.2f}", flush=True)
    synchronize(dev)
    ms = ((time.perf_counter() - t0 - (stream.seconds - synth0))
          / max(steps, 1) * 1e3)
    ppl = float(m["ppl"]) if m is not None else float("nan")
    print(f"[lm] {steps} steps, ppl={ppl:.2f}; {ms:.2f} ms/step", flush=True)
    return lm_state.lm.eval(), ppl, ms


def finite_wers(summary: dict) -> List[float]:
    """Every word and token error rate of a summary."""
    return [v for k, v in summary.items() if k.startswith("noisy_wer")] + list(
        summary["token_error_rates"].values())


def main(steps_a: int = 400, steps_c: int = 400, scale: str = "toy",
         with_lm: bool = False, lr: float = 1e-3, warmup: int = 0,
         bs: int = 16, eval_utts: int = 64, ckpt_dir: Optional[str] = None,
         save_every: int = 500, out: Optional[str] = None,
         seed: int = 0, optimizer: str = "adam", device="cuda",
         lm_steps: int = 600, route_batches: int = ROUTE_BATCHES,
         check_claim: bool = True,
         watch: Optional[Callable[[str], contextlib.AbstractContextManager]]
         = None, step_hook=None) -> dict:
    """The protocol; returns its summary (written to ``out`` when
    given). ``check_claim`` False leaves out the ordering gate (a run too
    short to train); the route gates always run. ``ckpt_dir``: save every
    ``save_every`` global steps and resume from there (``Progress``).
    ``step_hook(global_step, host_batch, state)`` is called before each
    training step the run takes (a cut or a record of the stream)."""
    watch = watch or (lambda name: contextlib.nullcontext())
    dev = resolve_device(device)
    if dev.type == "cuda":  # the kernels' build stays out of the timing
        print(f"build: {build():.1f} s", flush=True)
    card = card_line()
    print(f"device: {dev} ({card}) scale={scale} lr={lr} warmup={warmup} "
          f"bs={bs} eval_utts={eval_utts} ckpt_dir={ckpt_dir} seed={seed} "
          f"optimizer={optimizer}", flush=True)
    tcfg = dataclasses.replace(TCFG, optimizer=optimizer, learning_rate=lr,
                               warmup_steps=warmup, batch_size=bs, seed=seed)
    jcfg = kernel_config(jcfg_for(scale))
    stream = Stream(SCFG)
    rng = np.random.default_rng(seed)
    stream.batch(bs, rng)  # the JAX script's initialisation batch
    # parameters from seed, the discriminator's from seed + 1
    state = init_state(jcfg, tcfg, dev)
    model = state.model
    # every value that shapes the stream, the stages, the parameters or
    # the eval set: a resume must see the same (the JAX script's keys)
    run_args = {"bs": bs, "steps_a": steps_a, "steps_c": steps_c,
                "scale": scale, "eval_utts": eval_utts, "lr": lr,
                "warmup": warmup, "seed": seed, "optimizer": optimizer}
    progress = Progress(rng, ckpt_dir, save_every, run_args)
    progress.restore(state)
    ms = {}

    def stage(tag, step_fn, n_steps, log_every, fmt):
        return run_stage(tag, state, step_fn, n_steps, bs, log_every, fmt,
                         stream, dev, progress, step_hook)

    # (a) clean-ASR pretraining, then the no-enhancement baseline
    with watch("asr"):
        ms["asr_pretrain"] = stage(
            "asr", make_asr_pretrain_step(use_enhancer=False), steps_a, 100,
            lambda m: f"acc={float(m['acc']):.3f}")
    eval_rng = np.random.default_rng(EVAL_SEED)
    eval_b = stream.batch(eval_utts, eval_rng)
    with watch("no_enhancement"):
        wer_raw = progress.stage_eval(
            "noisy_raw", lambda: decode_wer(model, jcfg, eval_b, False, dev),
            "noisy WER, no enhancement (baseline)")

    # (b) the enhancement GAN alone (no ASR term), then the cascade
    with watch("gan"):
        ms["gan_pretrain"] = stage(
            "gan", make_joint_train_step(jcfg_cascade(jcfg), with_asr=False),
            2 * steps_c, 200,
            lambda m: (f"d={float(m['loss_d']):.3f} "
                       f"enh={float(m['loss_enh']):.3f}"))
    with watch("cascade"):
        wer_cascade = progress.stage_eval(
            "cascade", lambda: decode_wer(model, jcfg, eval_b, True, dev),
            "noisy WER, cascade (separate enhancer + clean ASR)")

    # (c) joint adversarial fine-tuning from (a) + (b)
    with watch("joint"):
        ms["joint"] = stage(
            "joint", make_joint_train_step(jcfg, with_asr=True), steps_c,
            100, lambda m: (f"acc={float(m['acc']):.3f} "
                            f"d={float(m['loss_d']):.3f}"))
    with watch("joint_decode"):
        wer_joint = progress.stage_eval(
            "joint", lambda: decode_wer(model, jcfg, eval_b, True, dev),
            "noisy WER, joint adversarial enhancement")

    # the LM is trained again on a resumed run, as in the JAX script
    wer_lm = lm_ppl = None
    if with_lm:
        with watch("lm"):
            lm, lm_ppl, ms["lm"] = train_char_lm(LM_CFG, stream, rng,
                                                 lm_steps, LM_BATCH, seed, dev)
        with watch("lm_decode"):
            wer_lm = decode_wer(model, jcfg, eval_b, True, dev, lm=lm,
                                lm_weight=LM_WEIGHT)
        print(f"noisy WER, joint + LM shallow fusion ({LM_WEIGHT}): "
              f"{wer_lm}", flush=True)

    print(f"bf16 route gates on the joint model ({route_batches} x {bs} "
          "utterances):", flush=True)
    route_b = list(stream.batches(route_batches, bs, eval_rng))
    with watch("routes"):
        routes = route_gates(jcfg, model.state_dict(), route_b, dev,
                             bcfg=beam_config(SCFG))

    n_params = sum(p.numel() for p in model.parameters())
    summary = {
        "task": "hard_task v3 (vocab=32, words, jitter, SNR -3..+5 dB, "
                "reverb T60 0.25 s, 3-stream babble, channel tilt)",
        "scale": scale,
        "model_params_m": round(n_params / 1e6, 1),
        "noisy_wer_no_enhancement": round(wer_raw["wer"], 4),
        "noisy_wer_cascade_enhancement": round(wer_cascade["wer"], 4),
        "noisy_wer_joint_adversarial": round(wer_joint["wer"], 4),
        "token_error_rates": {
            "no_enhancement": round(wer_raw["ter"], 4),
            "cascade": round(wer_cascade["ter"], 4),
            "joint": round(wer_joint["ter"], 4),
        },
        "relative_improvement": round(
            1.0 - wer_joint["wer"] / max(wer_raw["wer"], 1e-9), 4),
        "steps": {"asr_pretrain": steps_a, "joint": steps_c},
        "recipe": {"optimizer": optimizer, "lr": lr, "warmup_steps": warmup,
                   "batch_size": bs, "seed": seed},
        "eval_set": {"utterances": int(eval_b["labels"].shape[0]),
                     "ref_words": wer_joint["ref_words"]},
        "snr_range_db": list(SCFG.snr_range_db),
        "reverb_t60": SCFG.reverb_t60,
        "babble_streams": SCFG.babble_streams,
        "channel_tilt": SCFG.channel_tilt,
        "wer_ci95": {"no_enhancement": wer_raw["wer_ci95"],
                     "cascade": wer_cascade["wer_ci95"],
                     "joint": wer_joint["wer_ci95"]},
        "ms_per_step": ms,
        "synthesis_seconds": stream.seconds,
        "routes": routes,
        "device": str(dev),
        "card": card,
    }
    if ckpt_dir:
        summary["resume"] = {"restored_global_step": progress.done,
                             "stages_reused": progress.reused,
                             "steps_run": progress.steps_run,
                             "checkpoint_write_seconds":
                                 progress.save_seconds}
    if wer_lm is not None:
        summary["noisy_wer_joint_plus_lm"] = round(wer_lm["wer"], 4)
        summary["lm_ppl"] = round(lm_ppl, 2)
        summary["token_error_rates"]["joint_plus_lm"] = round(wer_lm["ter"], 4)
        summary["wer_ci95"]["joint_plus_lm"] = wer_lm["wer_ci95"]
    print(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    gate(all(math.isfinite(w) for w in finite_wers(summary)),
         f"a WER is not finite: {summary}")
    if check_claim:
        gate(wer_joint["wer"] < min(wer_raw["wer"], wer_cascade["wer"]),
             f"joint word WER {wer_joint['wer']} is not below both "
             f"no enhancement's {wer_raw['wer']} and the cascade's "
             f"{wer_cascade['wer']}")
        print("ADVERSARIAL BENEFIT CONFIRMED")
    return summary


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps_a", nargs="?", type=int, default=400)
    ap.add_argument("steps_c", nargs="?", type=int, default=400)
    ap.add_argument("--scale", choices=("toy", "reference"), default="toy")
    ap.add_argument("--lm", action="store_true",
                    help="also decode with char-RNNLM shallow fusion")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear LR warmup steps (adam)")
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--eval-utts", type=int, default=64,
                    help="eval-set size (utterances); larger tightens the "
                         "WER confidence interval")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume directory: periodic atomic "
                         "saves + per-stage WER records, so a preempted "
                         "run restarts where it left off")
    ap.add_argument("--save-every", type=int, default=500,
                    help="checkpoint period in train steps (with --ckpt-dir)")
    ap.add_argument("--out", default=None, help="summary JSON path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initialisation and the training "
                         "stream (the eval set stays fixed)")
    ap.add_argument("--optimizer", choices=("adam", "adadelta"),
                    default="adam")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.steps_a, a.steps_c, scale=a.scale, with_lm=a.lm, lr=a.lr,
         warmup=a.warmup, bs=a.bs, eval_utts=a.eval_utts,
         ckpt_dir=a.ckpt_dir, save_every=a.save_every, out=a.out,
         seed=a.seed, optimizer=a.optimizer, device=a.device)
