"""A tiny cell of each kind for the CPU tests: the port's ``tiny_config``
in float32, a few short utterances, and limits set from its readings at
this size (the program reads about 1e-7 against the reference; the fused frontend's folded bases about
1e-3 on its features; a bfloat16 reference in the program's place, the
control of a float32 configuration, 1e-4 to 1e-2; the served choice is
exact)."""

from __future__ import annotations

import dataclasses
import time

import torch

from asr_bench import run as runmod

LIMITS = {"feats_rel": 3e-3, "enc_rel": 1e-3, "ctc_rel": 1e-3,
          "margin_mean_rel": 1e-5, "select_rel": 0.0, "loss_rel": 1e-4,
          "change_rel": 1e-4}


def config() -> dict:
    from robust_e2e_gan_torch.configs import tiny_config
    return dataclasses.asdict(tiny_config(12))


def decode_traffic(clean_lm: bool = False) -> dict:
    t = {"kind": "decode", "batch": 4, "pool_batches": 2, "warmup_batches": 1,
         "check_rounds": 1, "check_rows": 3, "profile_batches": 1,
         "synth": {"min_tokens": 3, "max_tokens": 5}, "pad_to_samples": None,
         "wav": "noisy_wav", "use_enhancer": True, "frontend_fused": False,
         "lm": None,
         "beam": {"beam_size": 3, "ctc_weight": 0.3, "max_steps": 8,
                  "early_exit": False, "lm_weight": 0.0}}
    if clean_lm:
        t.update(wav="clean_wav", use_enhancer=False, frontend_fused=True,
                 lm={"embed_dim": 16, "hidden_dim": 24, "num_layers": 1,
                     "step_impl": "auto"},
                 beam=dict(t["beam"], lm_weight=0.3))
    return t


def train_traffic() -> dict:
    return {"kind": "train", "batch": 4, "pool_batches": 4,
            "checked_steps": 3, "warmup_steps": 1, "profile_steps": 1,
            "synth": {"min_tokens": 2, "max_tokens": 4},
            "pad_to_samples": None,
            "optimizer": {"optimizer": "adam", "learning_rate": 1e-3,
                          "warmup_steps": 0, "grad_clip": 5.0}}


def run(cell: str, traffic: dict, program=None, trace: bool = False,
        seed: int = 2**31 + 12345, seconds: float = 0.5):
    """(result line, notes, checks) of a tiny run of ``cell`` on the CPU:
    the harness with its look for a card skipped."""
    torch.manual_seed(0)
    return runmod.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                           cfg=config(), traffic=traffic,
                           limits=limits_for(traffic), program=program,
                           t_start=time.perf_counter())


def limits_for(traffic: dict) -> dict:
    """The limits of the numbers a run of this traffic compares."""
    if traffic["kind"] == "train":
        names = ("loss_rel", "change_rel")
    else:
        names = ("feats_rel", "enc_rel", "ctc_rel", "margin_mean_rel",
                 "select_rel")
    return {k: LIMITS[k] for k in names}
