"""Decode and scoring CLI: batched beam search over a dataset, WER report.

Port of ``robust_e2e_gan_tpu/decode/cli.py``: the same flags, names and
defaults. It decodes an experiment directory written by the port's
``train.cli`` (``config.json``, ``checkpoints.json``, ``ckpt_<step>.pt``),
by the JAX package (``ckpt_<step>.msgpack``, its parameters read without
flax) or by ``tools/import_reference_ckpt.py``, on the GPU (``--device
cuda``, the default; it raises without one) or, when asked, on the CPU
(``--device cpu``), with the weights moved to the device once. It writes
``hyp.txt``, ``wer.json`` (token-level rate, and word and char rates when
the experiment has a tokenizer) and, when asked, ``nbest.jsonl`` and the
``--dump-attention`` maps.

``--serving-impls`` maps as in the JAX package: ``auto`` takes the BLSTM,
attention and tiled CTC-prefix kernels with the unfused decoder step;
``fused`` adds the fused decoder step (``ops/att_dec.py``); ``xla`` takes
the plain versions everywhere, an explicit escape hatch. On CPU tensors
every kernel wrapper runs its plain version.

The data sources are a jsonl manifest of ``.npy`` waveforms, a Kaldi
waveform scp (``--noisy-scp``) or a Kaldi feats.scp (``--feats-scp``, for
an experiment trained on precomputed log-mel or spectra), each with a
Kaldi ``text`` file (``--text``). An experiment trained with global CMVN
reads ``<ckpt-dir>/cmvn.ark``; one with speaker CMVN needs ``--utt2spk``
(stats from ``--cmvn-ark`` or ``<ckpt-dir>/cmvn.ark``).

``--mesh-data N`` (N > 1) decodes over N data-parallel ranks, one process
each (``parallel/``; one card each with ``--device cuda``, gloo ranks with
``--device cpu``): each rank decodes its rows of every batch whose size
divides over N, rank 0 alone a batch that does not (as the JAX CLI places
a ragged batch on one device), and rank 0 gathers the rows and writes
every output, byte for byte what one process writes.

``--pipelined on`` decodes with the cross-batch staged schedule
(``decode/beam.py::make_pipelined_beam_searcher``: the next batch's copy
and encode on a side CUDA stream under this batch's beam loop), to the
same files; with ``--mesh-data`` each rank stages its own rows.
``--greedy`` and ``--dump-attention`` stay sequential, as in the JAX
package, and ``--pipelined auto`` resolves to sequential, as it does
there off the TPU. ``--pipelined chunked`` raises
``NotImplementedError`` (ROADMAP, "Not to port").

  python -m robust_e2e_gan_torch.decode.cli \\
      --manifest data/eval.jsonl --ckpt-dir exp/joint \\
      --out exp/joint/decode_eval
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from robust_e2e_gan_torch import config as cfg_lib
from robust_e2e_gan_torch.config import BeamSearchConfig, JointConfig, TrainConfig
from robust_e2e_gan_torch.data.dataset import (
    AudioTextDataset,
    BucketBatcher,
    load_tokenizer,
)
from robust_e2e_gan_torch.decode.beam import (
    make_beam_searcher,
    make_pipelined_beam_searcher,
)
from robust_e2e_gan_torch.models.e2e import add_sos_eos
from robust_e2e_gan_torch.ops.ctc import ctc_greedy_decode
from robust_e2e_gan_torch.ops.editdistance import score_texts, wer_details
from robust_e2e_gan_torch.parallel import launch, make_mesh, sharding
from robust_e2e_gan_torch.train.loop import init_state, resolve_device
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--manifest", help="jsonl manifest of .npy waveforms")
    p.add_argument("--noisy-scp", help="Kaldi scp of waveforms (with --text)")
    p.add_argument("--feats-scp",
                   help="Kaldi feats.scp of precomputed features (with "
                        "--text); requires an experiment trained with "
                        "--train-feats-scp. --length-buckets are frames.")
    p.add_argument("--text", help="Kaldi text file (with --noisy-scp or "
                                  "--feats-scp)")
    p.add_argument("--serving-impls", choices=("auto", "fused", "xla"),
                   default="auto",
                   help="serving kernel selection: 'auto' the BLSTM, "
                        "attention and tiled CTC-prefix kernels; 'fused' "
                        "adds the fused decoder step; 'xla' the plain "
                        "versions (operational escape hatch)")
    p.add_argument("--index-cache",
                   help="persist probed utterance lengths here (reused "
                        "while the scp's size and mtime match)")
    p.add_argument("--utt2num-frames",
                   help="Kaldi utt2num_frames map for --feats-scp (skips "
                        "the header probe at index build)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--which", choices=("best", "latest"), default="best")
    p.add_argument("--out", help="output dir (default: ckpt_dir/decode)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--beam-size", type=int, default=8)
    p.add_argument("--ctc-weight", type=float, default=0.3)
    p.add_argument("--penalty", type=float, default=0.0)
    p.add_argument("--max-steps", type=int, default=128)
    p.add_argument("--maxlen-ratio", type=float, default=0.0,
                   help="cap output length at ratio * encoded length")
    p.add_argument("--minlen-ratio", type=float, default=0.0)
    p.add_argument("--greedy", action="store_true",
                   help="greedy CTC decode instead of beam search")
    p.add_argument("--lm-dir",
                   help="RNNLM experiment dir (train --mode lm) for shallow "
                        "fusion")
    p.add_argument("--lm-weight", type=float, default=0.0)
    p.add_argument("--end-detect", action="store_true",
                   help="ESPnet-style end detection")
    p.add_argument("--no-early-exit", action="store_true",
                   help="always run max_steps instead of exiting when all "
                        "hypotheses finish")
    p.add_argument("--no-enhancer", action="store_true",
                   help="decode raw noisy features (cascade-off baseline)")
    p.add_argument("--utt2spk",
                   help="Kaldi utt2spk map for per-speaker CMVN (the "
                        "experiment's cmvn mode must be 'speaker'; stats "
                        "come from <ckpt-dir>/cmvn.ark or --cmvn-ark)")
    p.add_argument("--cmvn-ark",
                   help="speaker-keyed CMVN stats ark (default: "
                        "<ckpt-dir>/cmvn.ark)")
    p.add_argument("--length-buckets", default="32000,64000,112000,160000")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel serving ranks (0/1: one process)")
    p.add_argument("--pipelined", choices=("auto", "on", "off", "chunked"),
                   default="auto",
                   help="serving schedule: on = cross-batch staged (batch "
                        "i+1's copy and encode on a side CUDA stream under "
                        "batch i's beam loop; greedy and --dump-attention "
                        "stay sequential); auto and off decode batch after "
                        "batch; chunked is not ported")
    p.add_argument("--nbest", type=int, default=0,
                   help="also write the top-N beam hypotheses per utterance "
                        "to nbest.jsonl")
    p.add_argument("--dump-attention", action="store_true",
                   help="save teacher-forced attention maps (per-utterance "
                        ".npy under <out>/att)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to decode: the GPU (raises without one) or, "
                        "when asked, the CPU")
    return p


def _refuse_unported(args) -> None:
    if args.pipelined == "chunked":
        raise NotImplementedError(
            "--pipelined chunked: the chunked schedule is not to be ported "
            "(ROADMAP 'Not to port'); --pipelined on stages whole batches")


def with_serving_impls(jcfg: JointConfig, serving_impls: str) -> JointConfig:
    """The kernel-impl fields ``--serving-impls`` selects, with exact
    float32 gate storage (``decode/cli.py:146-163`` of the JAX package)."""
    lstm = {"auto": "auto", "fused": "tiled", "xla": "scan"}[serving_impls]
    step = {"auto": "auto", "fused": "fused", "xla": "xla"}[serving_impls]
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(
            e2e,
            encoder=dataclasses.replace(e2e.encoder, lstm_impl=lstm,
                                        gate_storage="f32"),
            decoder=dataclasses.replace(e2e.decoder, step_impl=step),
            attention=dataclasses.replace(e2e.attention, score_impl=step)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl=lstm,
                                     gate_storage="f32"))


def load_experiment(ckpt_dir: str, which: str = "best",
                    serving_impls: str = "auto", device="cuda"):
    """Rebuild (model, jcfg, tokenizer or None, step, input_kind,
    log_domain) from a training run's dir: the model of its saved config
    with the serving impls applied and the global CMVN stats of its
    ``cmvn.ark``, its parameters restored from "best" (or "latest" when the
    run recorded no best; a run of the port or of the JAX package) into a
    ``train/loop.py::init_state`` template on ``device``, in eval mode.
    ``input_kind`` and ``log_domain`` are the training input's ("wav",
    "feats" or "spec"; whether spectra are log power)."""
    from robust_e2e_gan_torch.data.cmvn import (
        load_cmvn_ark,
        stats_to_mean_inv_std,
    )

    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        saved = json.load(f)
    input_kind = saved.get("input_kind", "wav")
    log_domain = bool(saved.get("spec_log_domain", False))
    jcfg = with_serving_impls(
        cfg_lib.from_dict(JointConfig, saved["joint"]), serving_impls)
    tok_path = os.path.join(ckpt_dir, "tokenizer.json")
    tok = load_tokenizer(tok_path) if os.path.exists(tok_path) else None
    cmvn_stats = None
    cmvn_ark = os.path.join(ckpt_dir, "cmvn.ark")
    if jcfg.e2e.frontend.cmvn == "global" and os.path.exists(cmvn_ark):
        cmvn_stats = stats_to_mean_inv_std(load_cmvn_ark(cmvn_ark))
    tcfg = cfg_lib.from_dict(TrainConfig, saved["train"])
    # a feats experiment's discriminator was sized to its features, which
    # the encoder reads at n_mels wide
    feat_dim = jcfg.e2e.frontend.n_mels if input_kind == "feats" else None
    state = init_state(jcfg, tcfg, device, cmvn_stats, feat_dim)
    if which == "best" and not ckpt_lib.has_checkpoint(ckpt_dir, "best"):
        # runs without a dev set never record a 'best' entry
        print("no 'best' checkpoint (no dev metric); using 'latest'")
        which = "latest"
    _, step = ckpt_lib.restore_checkpoint(ckpt_dir, state, which,
                                          params_only=True)
    return state.model.eval(), jcfg, tok, step, input_kind, log_domain


def dataset_of(args, tok, input_kind: str) -> AudioTextDataset:
    """The dataset of ``--manifest``, ``--feats-scp``/``--text`` or
    ``--noisy-scp``/``--text``, which must match the experiment's
    ``input_kind``."""
    if args.manifest:
        ds = AudioTextDataset.from_jsonl(args.manifest, tokenizer=tok)
    elif args.feats_scp and args.text:
        if input_kind not in ("feats", "spec"):
            raise SystemExit("--feats-scp needs an experiment trained "
                             "with --train-feats-scp")
        ds = AudioTextDataset.from_kaldi_feats(
            args.feats_scp, args.text, tokenizer=tok,
            utt2num_frames=args.utt2num_frames,
            index_cache=args.index_cache)
    elif args.noisy_scp and args.text:
        ds = AudioTextDataset.from_kaldi(
            args.noisy_scp, args.text, tokenizer=tok,
            index_cache=args.index_cache)
    else:
        raise SystemExit(
            "need --manifest, --noisy-scp/--text, or --feats-scp/--text")
    if input_kind in ("feats", "spec") and not args.feats_scp:
        raise SystemExit("this experiment was trained on precomputed "
                         "features; decode it with --feats-scp/--text")
    return ds


def beam_config(args) -> BeamSearchConfig:
    """The search the parsed flags ask for."""
    prefix_impl = {"auto": "auto", "fused": "tiled",
                   "xla": "twopass"}[args.serving_impls]
    return BeamSearchConfig(
        beam_size=args.beam_size, ctc_weight=args.ctc_weight,
        penalty=args.penalty, max_steps=args.max_steps,
        maxlen_ratio=args.maxlen_ratio, minlen_ratio=args.minlen_ratio,
        lm_weight=args.lm_weight, end_detect=args.end_detect,
        early_exit=not args.no_early_exit, prefix_impl=prefix_impl)


def _load_lm(lm_dir: str, serving_impls: str, device):
    """The fusion LM, its step impl forced to the kernel or the plain
    cells unless ``serving_impls`` is auto."""
    from robust_e2e_gan_torch.models.lm import RNNLM
    from robust_e2e_gan_torch.train.lm import load_lm

    lm = load_lm(lm_dir, device=device)
    if serving_impls == "auto":
        return lm
    forced = RNNLM(dataclasses.replace(lm.cfg, step_impl=serving_impls),
                   dtype=lm.dtype)
    forced.load_state_dict(lm.state_dict())
    return forced.to(device).eval()


def _host_inputs(batch, rows: slice, inputs) -> tuple:
    """(wav, lengths, cmvn_batch or None) of one batch's ``rows``, as CPU
    tensors."""
    wav, lens = (torch.from_numpy(batch[k][rows]) for k in inputs)
    cmvn_batch = None
    if "cmvn_mean" in batch:
        cmvn_batch = tuple(torch.from_numpy(batch[k][rows])
                           for k in ("cmvn_mean", "cmvn_inv_std"))
    return wav, lens, cmvn_batch


def _beam_arrays(args, res) -> list:
    """The host arrays of a beam search's result: best tokens, then (with
    ``--nbest``) every hypothesis's tokens, lengths and scores, then the
    two of ``--dump-attention``; each empty where not asked for."""
    toks = res.tokens.cpu().numpy()
    empty = np.zeros((toks.shape[0], 0), np.float32)
    bt = bl = bs = empty
    if args.nbest > 0:
        bt = res.beam_tokens.cpu().numpy()
        bl = res.beam_lengths.cpu().numpy()
        bs = res.beam_scores.cpu().numpy()
    return [toks, bt, bl, bs, empty, empty]


def _decode_rows(args, searcher, model, e2e, batch, rows: slice, inputs,
                 device) -> list:
    """The host arrays of one batch's ``rows``: best tokens, then (beam
    search with ``--nbest``) every hypothesis's tokens, lengths and
    scores, then (``--dump-attention``) the teacher-forced attention maps
    and encoded lengths; each empty where not asked for."""
    wav, lens, cmvn_batch = _host_inputs(batch, rows, inputs)
    wav, lens = wav.to(device), lens.to(device)
    if cmvn_batch is not None:
        cmvn_batch = tuple(x.to(device) for x in cmvn_batch)
    if args.greedy:
        with torch.inference_mode():
            _, _, enc_lens, ctc_logits, _ = searcher.encode(wav, lens,
                                                            cmvn_batch)
            toks = ctc_greedy_decode(ctc_logits, enc_lens,
                                     e2e.blank_id).cpu().numpy()
        empty = np.zeros((toks.shape[0], 0), np.float32)
        out = [toks, empty, empty, empty, empty, empty]
    else:
        out = _beam_arrays(args, searcher(wav, lens, cmvn_batch))
    if args.dump_attention:
        labels = torch.from_numpy(batch["labels"][rows]).to(device)
        with torch.inference_mode():
            hs, hmask, enc_lens, _, _ = searcher.encode(wav, lens,
                                                        cmvn_batch)
            ys_in, _, _ = add_sos_eos(labels, e2e.sos_id, e2e.eos_id,
                                      e2e.ignore_id)
            _, att = model.asr.decoder(hs, hmask, ys_in)
        out[4:] = att.float().cpu().numpy(), enc_lens.cpu().numpy()
    return out


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    resolve_device(args.device)  # raises before any output
    if args.mesh_data > 1:
        mesh = make_mesh(args.mesh_data, 1, args.device)
        print(f"data-parallel decode over {args.mesh_data} ranks "
              f"({mesh.backend})", flush=True)
        launch(_decode, mesh, args)
    else:
        _decode(None, args)


def _decode(mesh, args) -> None:
    """Decode and score the parsed flags' dataset: in this process, or as
    one rank of ``mesh``."""
    main_rank = mesh is None or mesh.is_main
    device = resolve_device(args.device if mesh is None else mesh.device)
    model, jcfg, tok, step, input_kind, log_domain = load_experiment(
        args.ckpt_dir, args.which, args.serving_impls, device)
    if main_rank:
        print(f"restored step {step} from {args.ckpt_dir} ({args.which})")

    ds = dataset_of(args, tok, input_kind)
    buckets = tuple(int(x) for x in args.length_buckets.split(",") if x)
    speaker_cmvn = None
    if jcfg.e2e.frontend.cmvn == "speaker":
        if not args.utt2spk:
            raise SystemExit("cmvn mode 'speaker' requires --utt2spk")
        from robust_e2e_gan_torch.data.cmvn import SpeakerCmvn

        cmvn_ark = args.cmvn_ark or os.path.join(args.ckpt_dir, "cmvn.ark")
        speaker_cmvn = SpeakerCmvn.load(cmvn_ark, args.utt2spk)
    # pad_final: every batch has the same shape, the last one included
    batcher = BucketBatcher(ds, args.batch_size, buckets,
                            speaker_cmvn=speaker_cmvn, pad_final=True)
    bcfg = beam_config(args)
    lm = None
    if args.lm_dir and args.lm_weight != 0.0:
        lm = _load_lm(args.lm_dir, args.serving_impls, device)
        if main_rank:
            print(f"RNNLM shallow fusion from {args.lm_dir} "
                  f"(weight {args.lm_weight})")
    use_enh = not args.no_enhancer
    parts = (model, jcfg.e2e, bcfg)
    kw = dict(use_enhancer=use_enh, lm=lm, input_kind=input_kind,
              log_domain=log_domain)
    staged = (args.pipelined == "on" and not args.greedy
              and not args.dump_attention)
    if staged:
        run = make_pipelined_beam_searcher(*parts, **kw)
        if main_rank:
            print("pipelined serving schedule (cross-batch staged)")
    else:
        searcher = make_beam_searcher(*parts, **kw)
    e2e = jcfg.e2e
    inputs = (("feats", "feat_lengths") if input_kind in ("feats", "spec")
              else ("noisy_wav", "wav_lengths"))

    def owned():
        """(batch, the mesh its rows are split over, this rank's rows) of
        each batch this rank decodes."""
        for batch in batcher.epoch(shuffle=False):
            shard, rows = sharding.serving_split(len(batch[inputs[0]]), mesh)
            if rows is not None:
                yield batch, shard, rows

    def results():
        """(batch, shard, this rank's host arrays) of each of them."""
        if not staged:
            for batch, shard, rows in owned():
                yield batch, shard, _decode_rows(
                    args, searcher, model, e2e, batch, rows, inputs, device)
            return
        metas = []

        def host_batches():
            for batch, shard, rows in owned():
                metas.append((batch, shard))
                yield _host_inputs(batch, rows, inputs)

        for res in run(host_batches()):
            batch, shard = metas.pop(0)
            yield batch, shard, _beam_arrays(args, res)

    out_dir = args.out or os.path.join(args.ckpt_dir, "decode")
    if main_rank:
        os.makedirs(out_dir, exist_ok=True)
    refs, hyps, lines, nbest_rows = [], [], [], []
    ref_texts, hyp_texts = [], []
    for batch, shard, arrays in results():
        arrays = sharding.gather_rows(arrays, shard)
        if not main_rank:
            continue
        toks, bt, bl, bs, atts, hlens = arrays
        if args.nbest > 0 and not args.greedy:
            order = np.argsort(-bs, axis=1)
            for j, uid in enumerate(batch["utt_ids"]):
                entries = []
                for k in order[j][:args.nbest]:
                    htoks = [int(x) for x in bt[j, k, :bl[j, k]] if x != -1]
                    entries.append({
                        "tokens": htoks,
                        "text": tok.decode(htoks) if tok else None,
                        "score": float(bs[j, k]),
                    })
                nbest_rows.append({"utt_id": uid, "nbest": entries})
        batch_hyps = [[int(x) for x in row if x != -1] for row in toks]
        if args.dump_attention:
            os.makedirs(os.path.join(out_dir, "att"), exist_ok=True)
            for j, uid in enumerate(batch["utt_ids"]):
                n_lab = int(np.sum(batch["labels"][j] != -1)) + 1
                np.save(os.path.join(out_dir, "att", f"{uid}.npy"),
                        atts[j, :n_lab, :int(hlens[j])])
        for uid, lab_row, hyp in zip(batch["utt_ids"], batch["labels"],
                                     batch_hyps):
            ref = [int(x) for x in lab_row if x != -1]
            refs.append(ref)
            hyps.append(hyp)
            text = tok.decode(hyp) if tok else " ".join(map(str, hyp))
            ref_texts.append(tok.decode(ref) if tok else "")
            hyp_texts.append(text)
            lines.append(f"{uid} {text}")

    if not main_rank:
        return
    if nbest_rows:
        with open(os.path.join(out_dir, "nbest.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in nbest_rows) + "\n")
    with open(os.path.join(out_dir, "hyp.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    report = {"token": wer_details(refs, hyps)}
    if tok is not None:
        report.update(score_texts(ref_texts, hyp_texts))
    report["n_utts"] = len(refs)
    report["decoder"] = "greedy" if args.greedy else f"beam{args.beam_size}"
    with open(os.path.join(out_dir, "wer.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
