"""Standalone WER/CER scoring CLI (Kaldi compute-wer / sclite parity).

Port of ``robust_e2e_gan_tpu/decode/score_cli.py``: scores any ref/hyp pair
in Kaldi ``<utt-id> <text>`` format (the `text` file layout) with the
word-WER, S/D/I breakdown and CER report the decode CLI writes
(``ops/editdistance.py::score_texts``), and with ``--bootstrap N`` a 95%
percentile-bootstrap interval on each rate. Pure Python and numpy: it
needs no device.

  python -m robust_e2e_gan_torch.decode.score_cli \\
      --ref data/test/text --hyp exp/decode/hyp.txt [--out report.json] \\
      [--per-utt] [--bootstrap 1000]

Missing and extra utterances are reported; scoring covers the
intersection (Kaldi compute-wer --mode=present). ``--strict`` fails
instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

from robust_e2e_gan_torch.ops.editdistance import (
    bootstrap_wer_ci,
    score_texts,
    wer_details,
)


def read_trn(path: str) -> Dict[str, str]:
    """Kaldi text format: one '<utt-id> <transcript...>' per line."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if parts:  # an empty transcript is legal
                out[parts[0]] = parts[1] if len(parts) == 2 else ""
    return out


def _ci(refs, hyps, n_resamples: int) -> dict:
    """The interval keys of ``bootstrap_wer_ci`` that a report carries."""
    return {k: v for k, v in bootstrap_wer_ci(
        refs, hyps, n_resamples=n_resamples).items()
        if k.startswith("ci") or k in ("confidence", "n_resamples")}


def score_files(ref_path: str, hyp_path: str, strict: bool = False,
                per_utt: bool = False, bootstrap: int = 0
                ) -> Tuple[dict, list]:
    """(report, per-utterance rows) of the utterances in both files."""
    refs = read_trn(ref_path)
    hyps = read_trn(hyp_path)
    common = [k for k in refs if k in hyps]
    missing = sorted(set(refs) - set(hyps))
    extra = sorted(set(hyps) - set(refs))
    if strict and (missing or extra):
        raise SystemExit(
            f"--strict: {len(missing)} refs without hyps, "
            f"{len(extra)} hyps without refs")
    if not common:
        raise SystemExit("no utterances in common between ref and hyp")
    ref_texts = [refs[k] for k in common]
    hyp_texts = [hyps[k] for k in common]
    report = score_texts(ref_texts, hyp_texts)
    if bootstrap > 0:
        report["wer"].update(_ci([t.split() for t in ref_texts],
                                 [t.split() for t in hyp_texts], bootstrap))
        report["cer"].update(_ci([list("".join(t.split())) for t in ref_texts],
                                 [list("".join(t.split())) for t in hyp_texts],
                                 bootstrap))
    report["n_utts"] = len(common)
    report["n_missing_hyp"] = len(missing)
    report["n_extra_hyp"] = len(extra)
    rows = []
    if per_utt:  # per-utterance alignments are O(len^2) each: opt-in
        for k, r, h in zip(common, ref_texts, hyp_texts):
            d = wer_details([r.split()], [h.split()])
            rows.append({"utt_id": k, "wer": d["error_rate"],
                         "n_ref_words": int(d["ref_tokens"])})
    return report, rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Score hypothesis transcripts against references "
        "(Kaldi compute-wer / sclite equivalent).")
    p.add_argument("--ref", required=True,
                   help="reference text file, Kaldi '<utt> <text>' lines")
    p.add_argument("--hyp", required=True, help="hypothesis text file")
    p.add_argument("--out", help="write the JSON report here")
    p.add_argument("--per-utt", action="store_true",
                   help="include per-utterance WER rows in the report")
    p.add_argument("--strict", action="store_true",
                   help="fail on ref/hyp utterance-set mismatch")
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="add a 95%% percentile-bootstrap CI on WER/CER "
                        "from N utterance resamples (e.g. 1000)")
    args = p.parse_args(argv)

    report, per_utt = score_files(args.ref, args.hyp, args.strict,
                                  per_utt=args.per_utt,
                                  bootstrap=args.bootstrap)
    if args.per_utt:
        report["per_utt"] = per_utt

    w = report["wer"]
    print(f"%WER {100 * w['error_rate']:.2f} [ {int(w['errors'])} errors / "
          f"{int(w['ref_tokens'])} words, {int(w['sub'])} sub, "
          f"{int(w['del'])} del, {int(w['ins'])} ins ] "
          f"({report['n_utts']} utts)")
    if "ci_low" in w:
        print(f"  95% CI [{100 * w['ci_low']:.2f}, "
              f"{100 * w['ci_high']:.2f}] "
              f"({w['n_resamples']} bootstrap resamples)")
    print(f"%CER {100 * report['cer']['error_rate']:.2f}")
    if report["n_missing_hyp"] or report["n_extra_hyp"]:
        print(f"warning: {report['n_missing_hyp']} refs without hyps, "
              f"{report['n_extra_hyp']} hyps without refs (scored the "
              "intersection)", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
