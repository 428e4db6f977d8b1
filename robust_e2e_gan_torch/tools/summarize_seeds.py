"""Aggregate the port's multi-seed paper-claim runs into one summary.

    python -m robust_e2e_gan_torch.tools.summarize_seeds [results_dir]

Port of ``scripts/summarize_seeds.py`` with its ``_collect`` and
``_stats``: the mean and spread of the joint word WER across seeds, and
whether the paper's ordering (joint below both the no-enhancement and the
cascade baseline) holds in every run. Reads whichever of the records of
``tools/adversarial_benefit.py`` exist in ``results_dir`` (by default the
port's, ``results/torch_h100``):

  adversarial_benefit.json                   (toy, seed 0)
  adversarial_benefit_seed<k>.json           (toy, seed k)
  adversarial_benefit_adadelta.json          (toy, the reference recipe)
  adversarial_benefit_reference.json         (reference scale, seed 0)
  adversarial_benefit_reference_seed<k>.json (reference scale, seed k)

and writes ``results_dir/adversarial_benefit_summary.json`` (the JAX
summary's keys) and prints it.
"""

from __future__ import annotations

import glob
import json
import os
import sys

RESULTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "results", "torch_h100")
SUMMARY = "adversarial_benefit_summary.json"


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None


def _collect(pattern_base, default_seed_file):
    runs = []
    d = _load(default_seed_file)
    if d is not None:
        runs.append(d)
    for p in sorted(glob.glob(pattern_base)):
        d = _load(p)
        if d is not None:
            runs.append(d)
    return runs


def _stats(runs):
    rows = []
    for r in runs:
        rows.append({
            "seed": (r.get("recipe") or {}).get("seed", 0),
            "optimizer": (r.get("recipe") or {}).get("optimizer", "adam"),
            "no_enh": r["noisy_wer_no_enhancement"],
            "cascade": r["noisy_wer_cascade_enhancement"],
            "joint": r["noisy_wer_joint_adversarial"],
            "ordering_holds": (
                r["noisy_wer_joint_adversarial"]
                < r["noisy_wer_cascade_enhancement"]
                and r["noisy_wer_joint_adversarial"]
                < r["noisy_wer_no_enhancement"]
            ),
        })
    joints = [x["joint"] for x in rows]
    out = {
        "n_runs": len(rows),
        "runs": rows,
        "all_orderings_hold": all(x["ordering_holds"] for x in rows),
    }
    if joints:
        out["joint_wer_mean"] = round(sum(joints) / len(joints), 4)
        out["joint_wer_min"] = round(min(joints), 4)
        out["joint_wer_max"] = round(max(joints), 4)
    return out


def main(results_dir: str = RESULTS) -> dict:
    """The summary of ``results_dir``'s records, written beside them."""
    toy = _collect(os.path.join(results_dir, "adversarial_benefit_seed*.json"),
                   os.path.join(results_dir, "adversarial_benefit.json"))
    ada = _load(os.path.join(results_dir, "adversarial_benefit_adadelta.json"))
    ref = _collect(
        os.path.join(results_dir, "adversarial_benefit_reference_seed*.json"),
        os.path.join(results_dir, "adversarial_benefit_reference.json"))
    summary = {
        "toy_scale": _stats(toy) if toy else None,
        "toy_scale_adadelta": _stats([ada]) if ada else None,
        "reference_scale": _stats(ref) if ref else None,
    }
    print(json.dumps(summary, indent=2))
    with open(os.path.join(results_dir, SUMMARY), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main(*sys.argv[1:2])
