"""The RNNLM shallow-fusion benefit on the hard task's lexicon variant, on
the GPU.

    python -m robust_e2e_gan_torch.tools.lm_benefit [asr_steps] [lm_steps]
        [--out f.json] [--device cuda|cpu]

Port of ``scripts/lm_benefit.py`` with its constants (``SCFG``: the hard
task with words from a fixed 50-entry lexicon, so the language has
structure an LM can learn; ``JCFG``): ``asr_steps`` of clean-ASR
pretraining at B=16 from ``default_rng(0)`` with the BLSTM layers on the
kernels (partial convergence leaves errors for the LM to fix); a char
RNNLM (``LM_CFG``) trained ``lm_steps`` on batches of 32 transcripts from
``default_rng(1)``; then the 64-utterance noisy eval set of
``default_rng(999)`` decoded without the enhancer (beam 4, CTC weight 0.3)
at LM weights 0.0, 0.2 and 0.4. The summary has the JAX script's keys
plus the ms per step of both trainings (host clock ending in a device
synchronisation, synthesis left out), the seconds spent synthesising and
the card's name and power limit. The gate is the script's: the best word
WER at most the WER at weight 0; a failed gate raises ``DriveFailure``.
``main(watch=...)`` wraps each section in ``watch(name)`` ("asr", "lm",
"decode").
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
from typing import Callable, Optional

import numpy as np

from robust_e2e_gan_torch.config import (
    AttentionConfig,
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
from robust_e2e_gan_torch.data.synthetic import hard_task
from robust_e2e_gan_torch.tools.adversarial_benefit import (
    EVAL_SEED,
    Progress,
    Stream,
    card_line,
    decode_wer,
    run_stage,
    train_char_lm,
)
from robust_e2e_gan_torch.tools.verify_drive import gate, kernel_config
from robust_e2e_gan_torch.train.loop import init_state, resolve_device
from robust_e2e_gan_torch.train.steps import make_asr_pretrain_step
from robust_e2e_gan_torch.utils.build import build

# the lexicon variant of the hard task
SCFG = dataclasses.replace(hard_task(vocab_size=32), lexicon_size=50)
VOCAB = SCFG.vocab_size
JCFG = JointConfig(
    e2e=E2EConfig(
        frontend=FrontendConfig(n_mels=40),
        encoder=EncoderConfig(input_dim=40, vgg_channels=(8, 16), num_layers=1,
                              hidden_dim=96, proj_dim=96),
        attention=AttentionConfig(dim=64, conv_channels=8, conv_kernel=31),
        decoder=DecoderConfig(vocab_size=VOCAB, embed_dim=48, hidden_dim=96),
    ),
    enhancer=EnhancerConfig(input_dim=257, num_layers=1, hidden_dim=64),
    discriminator=DiscriminatorConfig(input_dim=40, channels=(8, 16)),
)
TCFG = TrainConfig(optimizer="adam", learning_rate=1e-3)
LM_CFG = LMConfig(vocab_size=VOCAB, embed_dim=48, hidden_dim=128)
BATCH = 16
LM_BATCH = 32
EVAL_UTTS = 64
LM_WEIGHTS = (0.0, 0.2, 0.4)


def main(asr_steps: int = 700, lm_steps: int = 600, out: Optional[str] = None,
         device="cuda", check_claim: bool = True,
         watch: Optional[Callable[[str], contextlib.AbstractContextManager]]
         = None) -> dict:
    """The protocol; returns its summary (written to ``out`` when
    given). ``check_claim`` False leaves out the gate (a run too short to
    train)."""
    watch = watch or (lambda name: contextlib.nullcontext())
    dev = resolve_device(device)
    if dev.type == "cuda":  # the kernels' build stays out of the timing
        print(f"build: {build():.1f} s", flush=True)
    card = card_line()
    print(f"device: {dev} ({card})", flush=True)
    jcfg = kernel_config(JCFG)
    stream = Stream(SCFG)
    rng = np.random.default_rng(0)
    stream.batch(BATCH, rng)  # the JAX script's initialisation batch
    state = init_state(jcfg, dataclasses.replace(TCFG, seed=0), dev)
    ms = {}
    with watch("asr"):
        ms["asr_pretrain"] = run_stage(
            "asr", state, make_asr_pretrain_step(use_enhancer=False),
            asr_steps, BATCH, 100, lambda m: f"acc={float(m['acc']):.3f}",
            stream, dev, Progress(rng))

    # the char RNNLM on transcripts alone
    with watch("lm"):
        lm, ppl, ms["lm"] = train_char_lm(LM_CFG, stream,
                                          np.random.default_rng(1), lm_steps,
                                          LM_BATCH, 0, dev)
    print(f"[lm] final ppl={ppl:.2f} (uniform = {VOCAB})", flush=True)

    # the noisy eval set through the clean-trained ASR, no enhancer
    eval_b = stream.batch(EVAL_UTTS, np.random.default_rng(EVAL_SEED))
    results = {}
    with watch("decode"):
        for beta in LM_WEIGHTS:
            r = decode_wer(state.model, jcfg, eval_b, False, dev, scfg=SCFG,
                           lm=lm if beta else None, lm_weight=beta)
            results[f"lm_weight_{beta}"] = {"ter": round(r["ter"], 4),
                                            "wer": round(r["wer"], 4)}
            print(f"beta={beta}: ter={r['ter']:.4f} wer={r['wer']:.4f}",
                  flush=True)

    base = results["lm_weight_0.0"]
    best = min(results.values(), key=lambda r: r["wer"])
    summary = {
        "task": "hard_task(vocab=32, lexicon=50), noisy eval (-3..+5 dB), "
                "clean-trained ASR, no enhancer",
        "asr_steps": asr_steps, "lm_steps": lm_steps,
        "results": results,
        "wer_improvement_vs_no_lm": round(base["wer"] - best["wer"], 4),
        "lm_ppl": round(ppl, 2),
        "ms_per_step": ms,
        "synthesis_seconds": stream.seconds,
        "device": str(dev),
        "card": card,
    }
    print(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    gate(all(math.isfinite(r[k]) for r in results.values()
             for k in ("ter", "wer")), f"a WER is not finite: {results}")
    if check_claim:
        gate(best["wer"] <= base["wer"],
             f"no LM weight reaches the weight-0 word WER: {results}")
        print("LM FUSION BENEFIT" if best["wer"] < base["wer"]
              else "LM FUSION NEUTRAL")
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("asr_steps", nargs="?", type=int, default=700)
    ap.add_argument("lm_steps", nargs="?", type=int, default=600)
    ap.add_argument("--out", default=None, help="summary JSON path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args()
    main(a.asr_steps, a.lm_steps, out=a.out, device=a.device)
