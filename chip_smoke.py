#!/usr/bin/env python3
"""Drive the PyTorch port's serving decodes and its training on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA device must be present; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels of robust_e2e_gan_torch/csrc from the
   checkout (nvcc, sm_90a) and the host library of csrc/host (g++), and
   prints the seconds each took;
3. kernel parity: each kernel's wrapper against its plain PyTorch version
   on the card, at the shapes of the main path (B utterances of ~7 s, beam
   8, ~694 STFT frames, ~174 encoder frames, vocab 52; the W_x-resident
   BLSTM at each of the flagship's four BLSTM layers on both of its
   routes, the cluster kernel and the row-tiled one, timed in bfloat16 in
   turns with the gate-stream route and cuDNN's LSTM; the attention step
   on both of its routes, one block per utterance (csrc/att_loc_utt.cu,
   with its plan) and one per hypothesis (csrc/att_loc.cu), timed in turns
   with the plain version with the host ahead of the device, and again at
   B=16, where ops/att.py::utt_preferred picks the route by dtype; the
   CTC prefix psi, state and beam-step state (prefix_state_step) on both
   of their routes, one block per utterance and one thread per lane
   (csrc/ctc_prefix.cu, with their plans), timed in turns with the host
   ahead, at B=128 and B=16; the per-utterance psi kernel
   (csrc/ctc_prefix_utt.cu, a ring of frame chunks, with its plan) at
   B=128 and at B=16 with 1,200 frames, timed in turns with the psi
   kernel's utt route on the same inputs, the host ahead; the fused
   decoder step on both of its
   routes, the attention an utterance a block then the cell over all
   lanes on a co-resident grid (csrc/att_dec_utt.cu, with its plan) and
   one block per utterance for the whole step (csrc/att_dec.cu), at the
   flagship's decoder widths at B=128 and B=16 and at the decode CLI's
   float32 model, timed in turns with the attention step alone and the
   plain version, the host ahead), in float32 with
   TF32 off and in bfloat16, with the time of each; the gate-stream BLSTM
   recurrence on both of its routes, W_h split by gate columns over a
   co-resident grid (csrc/blstm_gx_grid.cu, with its plan) and row tiles
   (csrc/blstm.cu), at the flagship's enhancer and encoder layers and at
   the wide encoder's (H=1,024), timed in turns with cuDNN's LSTM from x
   at row 1b's shape (the enhancer layer, bfloat16) and at the wide layer
   in float32 and bfloat16; one BLSTM layer too wide for the W_x-resident
   kernel, which must take the gate-stream one on its grid route;
   then the training kernels, forward and every gradient, at the train
   shapes (B=32 ~2.9 s
   utterances: 286 STFT frames, 72 encoder frames; the train CLI's model
   for blstm_train_gx; the BLSTM's frame loops on both routes, the
   resident one and the row-tiled one, held to the plain version, timed
   in turns and split by the profiler into frame loops, gemm.cu's
   products, its column sums and the rest, and blstm_train_gx's layer
   from x at D=2560 timed in turns with cuDNN's LSTM; each product of
   gemm.cu (the projection, dx, dW_x, dW_h of the flagship's enhancer
   and encoder layer 0 in bfloat16, the train CLI's float32 dW_h) on the
   tensor-core kernel against the plain version, timed in turns with the
   SIMT kernel beside the plain version and torch.matmul on the same
   operands; the whole CTC loss and its gradient, float32 and
   bfloat16 logits, timed in turns with F.ctc_loss, with a profiler split
   of its device time against its wall time, and the bare alpha recursion
   alone); then the clean-speech kernels: the fused frontend
   at decode and train shapes on both of its routes, the DFT on the tensor
   cores in 3xTF32 (logmel_tc_kernel, with its plan; two runs
   bit-identical) and in float32 FMAs (logmel_kernel), timed in turns with
   the plain version, its backward at train shapes, and the RNNLM
   step at N=1024 lanes (float32 and bfloat16, 1 and 2 layers, and the
   CLI's E=H=512) on both of its routes, the gate product over all lanes
   in tiles on a co-resident grid (csrc/lm_step_tile.cu, with its plan;
   two runs bit-identical) and 8 lanes a block (csrc/lm_step.cu), timed in
   turns with the plain version with the host ahead, with each route's
   host time per call. Each kernel's entry also holds the least time the card
   could take for the same work (``bound_ms``) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``);
4. main path: the flagship model in bfloat16 compute (random weights from
   seed 0) through ``make_beam_searcher(..., use_enhancer=True)`` on 3
   batches of 128 utterances; checks the results, that every kernel
   launched (the BLSTM's cluster kernel once per layer and batch, its
   row-tiled and gate-stream kernels never; every attention step, 48 a
   batch, and every CTC psi and state launch, 48 each a batch, on the
   per-utterance route) and no plain version ran; runs one batch with the
   attention forced to the per-hypothesis route and one with the CTC
   prefix forced to the lane route (their launches are those kernels');
   times the path against the same path with every BLSTM layer on the
   row-tiled route, on the gate-stream route, with the attention on the
   per-hypothesis route and with the CTC prefix on the lane route, in
   turns, with one profiled batch of each; profiles one search on each
   CTC prefix route (its prefix rows and launches a beam step); then
   times the same path with the plain versions;
5. slice parity: one batch of 16 at full width in float32 through the
   kernel path, its attention forced to the per-utterance route (float32
   at B=16 defaults to the per-hypothesis one) and its CTC prefix on it,
   and the plain path; best-hypothesis scores must agree;
6. train step: the flagship in bfloat16 through ``make_joint_train_step``
   (D-step, then G-step; Adadelta) on B=32 utterances of 20-24 tokens:
   one warm-up and 5 timed steps on the kernel path, checking finite
   metrics, that every kernel of the path launched (the CTC loss twice a
   G-step, forward and backward; every BLSTM layer's frame loops on the
   resident route and every product on gemm.cu's tensor-core kernel, the
   D-step's inference BLSTM on the cluster route) and no plain version
   ran, and a profile of one warm step (with gemm.cu's rows and
   launches); then the same on the plain path;
7. entry point: ``train.cli --mode joint --synthetic`` at the CLI's
   default model (float32, B=16) for 3 steps into a temporary checkpoint
   dir, then a resume for 1 more; the encoder's first layer takes
   blstm_train_gx, the others blstm_train, every one on the resident
   frame loops;
8. train-slice parity: one float32 joint step of the flagship at B=16,
   kernel path against plain path from the same parameters;
9. clean-speech serving: the flagship with the fused frontend in bfloat16
   compute, without the enhancer, with RNNLM shallow fusion (an LM at the
   ``LMConfig`` defaults in float32, weights from seed 2, lm_weight 0.3)
   on 3 batches of 128 clean utterances; checks that the fused frontend,
   the LM step and the four serving kernels launched (every fused-frontend
   launch on its tensor-core route, every attention step on the
   per-utterance route, every LM step on its tile route) and no
   plain version ran; runs one batch with the LM forced to its lane route
   (its launches are that kernel's); profiles one warm batch on each LM
   route (the LM step's row); then times the same path with the plain
   versions;
10. its slice parity: one batch of 16 in float32, kernel path (attention
    forced to the per-utterance route, the CTC prefix and the LM step on
    their default routes, "utt" and "tile") against plain path;
    best-hypothesis scores must agree;
11. the clean-speech recipe through its entry points: ``train.cli --mode
    asr --fused-frontend`` and ``train.cli --mode lm`` (3 steps each, the
    LM resumed to a 4th) at the CLI's default model, then both runs
    restored and one batch of 16 decoded without the enhancer with the LM
    fused;
12. the serving entry point: ``decode.cli`` on phase 7's experiment (the
    CLI's default model, float32) over a manifest of 128 .npy utterances
    of its task, one batch, beam 8, 48 steps without early exit:
    ``--serving-impls fused`` must launch the fused decoder step 48 times,
    every one on its per-utterance route, beside the BLSTM (float32: the
    row-tiled kernel) and prefix kernels with no plain version;
    ``--serving-impls xla`` on the same inputs must agree on the best
    scores;
13. the fused-step A/B: phase 4's traffic through the fused decoder step
    (every launch on its per-utterance route), the unfused one and the
    fused one forced to its per-hypothesis route (one batch, whose
    launches that kernel's are), in turns, with one profiled batch of
    each (its decoder-step rows) and one profiled search of each (its
    launches a beam step);
14. the per-utterance CTC prefix kernel (``prefix_impl="pallas"``) on
    phase 4's traffic (every attention step and state launch on the
    per-utterance route), against the tiled prefix kernels in turns with
    one profiled batch of each, then an f32 B=16 parity against them;
15. serving with a wide encoder: phase 4's traffic through the flagship
    with its encoder widened to 3 BLSTMP layers of hidden = proj = 1,024
    in float32 (random weights, seed 3), whose layers the fit rule sends
    to the gate-stream kernel: 3 grid-route launches a batch and no plain
    version required, one batch forced onto the row-tiled route, both
    timed in turns with a profiled batch of each (its BLSTM rows), then a
    B=16 slice parity of the kernel path against the plain path;
16. the verify drive, ``robust_e2e_gan_torch/tools/verify_drive.py``
    (``scripts/verify_drive.py``'s model and task: H=64, vocab 12, 2-6
    tokens at 5 dB): 500 joint steps at B=16 in float32 (Adam 1e-3) on the
    kernel path, with the ms per step and the accuracy and losses every
    100 steps; the JAX drive's gates (accuracy > 0.9, greedy WER <= 0.05,
    beam <= greedy, bfloat16 beam within 0.02 of float32); then the
    bfloat16 token gates on the trained model: 128 more utterances decoded
    on the default routes and with the fused decoder step, the
    per-utterance psi kernel, the inference BLSTM forced to its row-tiled
    and to its cluster route, each WER within 0.02 of the default's, with
    each route's token-identical share and launches by route; the probes;
    and the manifest, loop and resume section. Each section's launches are
    checked: the training kernels on the resident frame loops in the
    training sections, the serving kernels on their routes in the decodes,
    no plain version but the teacher-forced attention's;
17. the corpus recipe through its entry points at ``train.cli``'s default
    model (float32, 512 wide): a manifest of 32 .npy utterances of the
    default task with a Kaldi text file of their references;
    ``train.cli --train-manifest --dev-manifest`` for one epoch and a
    resume to two (the step count continues, ``tokenizer.json`` written),
    ``--mode lm`` on the manifest's transcripts, ``enhance_cli`` in both
    domains (32 matrices, each utterance's valid frames, finite, read back
    with ``kaldi_io``), ``decode.cli`` with the LM fused (word and char
    rates in ``wer.json``), and ``score_cli --bootstrap 200`` on its
    ``hyp.txt`` (the same rates exactly, inside their intervals); the
    training, serving and LM kernels launched and no plain version but the
    teacher-forced attention's;
18. the paper-claim protocols on the hard synthetic task at a smoke
    budget: ``tools/adversarial_benefit.py::main`` (the toy model, float32
    B=16: 20 clean-ASR steps, 40 enhancement-GAN steps, 20 joint steps,
    the no-enhancement, cascade and joint decodes of 16 eval utterances,
    20 LM steps and the joint decode with the LM, then the bfloat16 route
    gates on 2 batches of 16) and ``tools/lm_benefit.py::main`` (20
    clean-ASR steps, 20 LM steps, 64 eval utterances decoded at three LM
    weights). Each section's launches are checked: the training sections
    on the resident frame loops, ``gemm.cu`` and the CTC loss (the GAN
    section on the D-step's row-tiled inference BLSTM instead of the CTC
    loss), each float32 decode on the row-tiled BLSTM, the attention route
    ``ops/att.py::utt_preferred`` picks and the CTC prefix's route "utt"
    (with the LM, the LM step on "tile"), the route gates as phase 16's;
    no plain version but the teacher-forced attention's. Every error rate
    must be finite and every summary key present; 20 steps train nothing,
    so neither ordering is gated here (the full runs gate them);
19. the Kaldi and precomputed-feature inputs: (1) the flagship in float32
    (TF32 off) on 16 utterances of phase 4's traffic, their log-mel and log
    power spectra made by ``data/featbin_cli.py``'s extraction:
    ``encode_for_decode_feats`` (utterance CMVN) against
    ``encode_for_decode`` without the enhancer, and
    ``encode_for_decode_spec`` (log domain) against it with the enhancer,
    each on the kernels: hlens equal, CTC logits at rtol/atol 1e-4, beam-8
    tokens over 48 steps identical (a spectrum's rows at the log floor
    printed where they are not); then speaker CMVN, every utterance of one
    speaker holding the global stats, against global CMVN: equal; (2) the
    flagship's joint forward on log spectra against the waveforms at phase
    8's shape (float32, B=16, the clean speech dithered), every loss
    within 1e-4, then one ``input_kind="spec"`` joint step on the kernel
    path whose enhancer gradients are finite and nonzero; (3) phase 4's
    traffic as log spectra through the flagship with the enhancer in
    bfloat16 (B=128, beam 8, 48 steps, 3 warm batches): utt/s, ms per
    batch and launches on a line that names the card, not gated; (4) a
    Kaldi recipe of 32 utterances through ``python -m
    robust_e2e_gan_torch`` at ``train.cli``'s default model: ``fbank``
    (log-mel and log spectra), ``copy-feats --compress 1``, ``cmvn``
    global and ``--utt2spk``, ``train --mode asr`` on the compressed
    log-mel with speaker CMVN, ``--mode joint`` on log spectra, ``--mode
    joint`` on the wav.scp with global CMVN and an index cache, resumed
    with no ark header probed, ``decode`` of each from its Kaldi source,
    ``enhance --noisy-scp`` and ``score`` equal to each ``wer.json``; every
    section's launches checked as phase 17's;
20. the attention variants and model interchange: (1) phase 4's traffic
    in bfloat16 through the flagship with AttAdd, then AttDot attention
    (seed-0 weights from ``init_params``), with the unfused step and with
    ``step_impl="fused"``, which such a model does not take: 12 cluster
    BLSTM launches and 144 of each CTC prefix kernel on route "utt", no
    attention kernel and no fused step, no plain version; utt/s and ms per
    batch on a line naming the card, not gated; then the kernel path
    against the plain path in float32 at B=16: best scores within 1e-3
    relative, best hypotheses identical; (2) the flagship's seed-0
    generator exported in the reference layout (``torch.save`` of
    ``tools/import_reference_ckpt.py::export_state_dict``), imported with
    ``--units`` (50 units at ids 1-50): the parameters bit-equal,
    enhancer included, a ``TableTokenizer`` of vocab 52, sos = eos = 51;
    ``decode.cli`` on 128 ``.npy`` utterances of phase 4's task (bfloat16,
    beam 8, 48 steps) with the default impls and with ``--serving-impls
    fused``: the best token ids identical to the searcher's on the original
    weights with the same ids, impls and batch; and the kernel path against
    the plain path with eos 51 in float32 at B=16, tokens identical; (3)
    phase 7's experiment written as the JAX package writes one
    (``ckpt_<step>.msgpack``, a JAX ``TrainState`` in the flax layout):
    ``decode.cli``'s ``hyp.txt`` and ``wer.json`` and ``enhance_cli``'s
    ark/scp byte-identical to the ``.pt`` experiment's, ``train.cli
    --init-from`` it for 2 steps with the first step's metrics within 1e-6
    of the warm start from the ``.pt`` experiment, ``--resume`` on it
    refused; (4) 3 flagship joint steps (bfloat16, phase 6's batch), each
    saved by ``AsyncCheckpointer`` while the next step updates the state
    in place: every checkpoint restores bit-equal to the state at its
    save; the ms ``save()`` blocked the training thread and the ms of the
    last write on the saver's thread printed;
21. data parallelism (``robust_e2e_gan_torch/parallel``,
    ``tools/dp_phases.py``): (1) two gloo ranks on card 0 each take 8 rows
    of phase 8's float32 B=16 traffic (the second shard cut to fewer
    label tokens) through 3 joint steps on the kernels: first-step
    metrics, ``grad_norm_g`` and ``grad_norm_d`` included, within rtol
    2e-4 / atol 2e-5 of one process's steps, the ranks' parameters
    bit-equal and within 5e-5 (generator) and 2e-4 (discriminator, whose
    convolutions' sums differ at B=8) of one process's after 3 steps,
    every rank launching ``blstm_train``, ``gemm`` and ``ctc_nll`` and no
    plain version; (2) the same two ranks decode phase 5's B=16 with early exit:
    tokens identical to one process's, scores within 1e-3 relative, each
    rank launching an inference BLSTM route, the attention kernel, psi and
    state; (3) one NCCL rank takes one step through the same reduction,
    bit-equal to the step with no mesh (deterministic algorithms in both),
    and ``train.cli --mesh-data 2`` over NCCL where two cards exist; (4)
    the ms the training thread waits in a depth-2 ``Prefetcher``'s
    ``next()`` on phase 7's traffic, the collation ms alone, and the
    loop's ms a step with and without it in turns, reported;
22. the host-side overlap: (1) the host library (``csrc/host``, built by
    g++ at phase 2, its seconds and the compiler's version printed): a
    ``.npy`` manifest of 8 batches of B=32 of the train cell's traffic
    collated by the C++ reader and by numpy (bit-equal), one
    CM-compressed feature batch (within ulps of numpy, printed),
    ``wer_details`` on 1,024 utterances of ~50 tokens (equal to the
    Python scorer), each timed in turns, and the loop's ms a step over
    2 of the manifest's batches a run on phase 7's model with a depth-2
    ``Prefetcher``, collated by each reader in turns, reported, not gated;
    (2) the staged
    searcher (``make_pipelined_beam_searcher``: each next batch's copy and
    encode on a side stream under this batch's beam loop) against the
    sequential one on the same host batches: phase 4's traffic with early
    exit on and off, timed in turns, with a profiled pass of two batches
    of each (the device's busy share, each stream's busy ms and the ms two
    streams ran at once); then phase 9's clean decode with the LM and the
    fused frontend, phase 13's fused step, and two B=16 batches through
    phase 15's wide float32 encoder (random weights drawn on the card)
    with the fused step (the grid recurrence on the side stream, the fused
    step on the current one: two cooperative grids, and the ms they ran at
    once); each gated on identical tokens and best scores within 1e-5
    relative; (3) ``decode.cli --pipelined on`` on phase 7's experiment (2
    batches of 16, 24 steps, the default impls and ``--serving-impls
    fused``): ``hyp.txt``, ``wer.json`` and ``nbest.jsonl`` byte-identical
    to ``--pipelined off``'s;
23. the paper-claim protocol at the reference scale (the JAX script's
    ``jcfg_for("reference")``: 36.3 M parameters, 2 x 512 enhancer, VGG +
    3 x 512 BLSTMP at 80 mels, 512-wide attention and decoder, bfloat16;
    random weights from seed 0; the hard task, B=32): (1) 6 joint steps
    (Adam 3e-4, warmup 600), every training BLSTM layer on the resident
    frame loops, every product on ``gemm.cu``'s tensor-core kernel, the
    CTC loss on ``ctc_nll``, the D-step's enhancer forward on the
    row-tiled inference BLSTM (the cluster plan stops at H = 256), ms a
    step; (2) 64 eval utterances decoded in bfloat16 (beam 4, 29 steps, no
    early exit): 5 row-tiled BLSTM launches and every attention, psi and
    state launch on route "utt", then the float32 kernel path against the
    plain path at B=16 (best scores within 1e-3 relative, hypotheses
    identical or a near tie); (3) row 1a's row-tiled kernel at encoder
    layer 0 (B=64, T=70, D=2,560, H=512) against its plain version, timed
    in turns with cuDNN's LSTM, with its bound; (4)
    ``tools/adversarial_benefit.py::main`` at the reference scale (4 + 2
    x 2 + 2 steps, ``save_every=3``, 16 eval utterances, one route batch)
    uncut, then cut before global step 6 and run again in its checkpoint
    dir: the restored state bit-equal to the state at its save, the
    resumed stream bit-equal to the uncut run's, the no-enhancement
    decode reused from the sidecar, every summary key present, the
    cluster route reported not run; the uncut and resumed rates printed
    side by side; (5) the kernels at the reference widths against their
    plain versions in bfloat16 (phase 3's limits): the training BLSTM on
    its resident route, forward and every gradient, at the enhancer's
    layer 0 (B=32, T=279, D=257, H=512) and the encoder's (B=32, T=70,
    D=2,560, H=512), every product on ``gemm.cu``'s tensor-core kernel;
    the CTC loss and its gradient at V=32 (also float32); the attention
    step's utt route at B=64, K=4, A=512.

Each phase after 15 prints its seconds. The line before the last is a JSON object of the 22 kernels (``gemm``
the products of one row-6 call, with phase 6's launches; the
attention's two routes as ``att_loc_step`` and ``att_loc_step_hyp``, the
CTC prefix kernels' as ``ctc_prefix_psi_utt``/``ctc_prefix_state_utt``
and ``ctc_prefix_psi``/``ctc_prefix_state``, the second of each pair
with phase 4's forced batch's launches; the fused step's as
``att_dec_step``, with phase 12's launches, and ``att_dec_step_hyp``,
with phase 13's forced batch's; the LM step's as ``lm_step``, with phase
9's launches, and ``lm_step_lane``, with phase 9's forced batch's;
``fbank_fused`` the fused frontend's tensor-core route, with phase 9's
launches; ``blstm_recurrence`` the gate-stream grid route, timed at the
wide float32 encoder layer, with phase 15's launches, and
``blstm_recurrence_row_tiled`` its row-tiled route, timed there too,
with phase 15's forced batch's); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from robust_e2e_gan_torch import __main__ as unified_cli
from robust_e2e_gan_torch import config as config_lib
from robust_e2e_gan_torch import pipeline
from robust_e2e_gan_torch.config import (
    AttentionConfig,
    BeamSearchConfig,
    DecoderConfig,
    EncoderConfig,
    FrontendConfig,
    JointConfig,
    LMConfig,
    TrainConfig,
)
from robust_e2e_gan_torch.configs import flagship_config
from robust_e2e_gan_torch.convert import (
    from_flax,
    init_disc_params,
    init_lm_params,
    init_params,
)
from robust_e2e_gan_torch.data.synthetic import (
    SyntheticConfig,
    labels_to_list,
    make_batch,
    sample_transcript,
    synth_utterance,
)
from robust_e2e_gan_torch.decode.beam import (
    beam_search_from_encoder,
    make_beam_searcher,
    make_pipelined_beam_searcher,
)
from robust_e2e_gan_torch.models.encoder import subsampled_frames
from robust_e2e_gan_torch.models.enhancement import (
    Discriminator,
    adversarial_losses,
    enhancement_loss,
)
from robust_e2e_gan_torch.models.lm import RNNLM
from robust_e2e_gan_torch.models import rnn
from robust_e2e_gan_torch.models.rnn import BLSTM, input_projection
from robust_e2e_gan_torch.decode import cli as decode_cli
from robust_e2e_gan_torch.decode import enhance_cli, score_cli
from robust_e2e_gan_torch.data import cmvn, dataset, featbin_cli, kaldi_io
from robust_e2e_gan_torch.data.dataset import CharTokenizer
from robust_e2e_gan_torch.ops import (
    att,
    att_dec,
    blstm,
    blstm_train,
    ctc,
    ctc_prefix,
    editdistance,
    fbank_fused,
    lm_step,
)
from robust_e2e_gan_torch.ops.fbank import num_frames
from robust_e2e_gan_torch.parallel import launch, make_mesh
from robust_e2e_gan_torch.pipeline import build_model
from robust_e2e_gan_torch.train import cli as train_cli
from robust_e2e_gan_torch.train import loop as train_loop
from robust_e2e_gan_torch.train import steps as train_steps
from robust_e2e_gan_torch.train.lm import load_lm
from robust_e2e_gan_torch.tools import (
    adversarial_benefit,
    dp_phases,
    import_reference_ckpt,
    lm_benefit,
    verify_drive,
)
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib
from robust_e2e_gan_torch.utils import native
from robust_e2e_gan_torch.utils.build import build
from robust_e2e_gan_torch.utils.impl import device_limits

VOCAB = 52
# the wide encoder's width (phase 15): hidden = proj = 1,024
WIDE = 1024
BATCH = 128
N_BATCHES = 3
BEAM = 8
STEPS = 48
# encoder frames of phase 3's long-utterance psi parity (~48 s of audio),
# past what staging a whole utterance in shared memory allowed
LONG_T = 1200
SYNTH = SyntheticConfig(vocab_size=VOCAB, min_tokens=48, max_tokens=58)
# training traffic (scripts/bench_train.py): ~2.9 s utterances, 46,080
# samples, 286 STFT frames, 72 encoder frames
TRAIN_BATCH = 32
TRAIN_STEPS = 5
TRAIN_SYNTH = SyntheticConfig(vocab_size=VOCAB, min_tokens=20, max_tokens=24)

KERNELS = {
    # blstm_infer's two routes (ops/blstm.py::cluster_plan): their
    # launches are counted by route, not by the shared wrapper
    "blstm_infer": dict(
        wrapper=blstm.blstm_infer, plain=blstm.blstm_infer_plain,
        route="cluster",
        source="robust_e2e_gan_torch/csrc/blstm_infer_cluster.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_pallas.py:332 "
                 "(W_x-resident, pallas_call :403)"),
    "blstm_infer_row_tiled": dict(
        wrapper=blstm.blstm_infer, plain=blstm.blstm_infer_plain,
        route="row_tiled",
        source="robust_e2e_gan_torch/csrc/blstm_infer.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_pallas.py:332 "
                 "(W_x-resident, pallas_call :403)"),
    # blstm_recurrence's two routes (ops/blstm.py::gx_plan), counted by
    # route: W_h split by gate columns over a co-resident grid, and the
    # row-tiled kernel past the plan
    "blstm_recurrence": dict(
        wrapper=blstm.blstm_recurrence, plain=blstm.blstm_recurrence_plain,
        gx_route="grid",
        source="robust_e2e_gan_torch/csrc/blstm_gx_grid.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_pallas.py:332 "
                 "(gate-stream _gx_kernel :210, pallas_call :455)"),
    "blstm_recurrence_row_tiled": dict(
        wrapper=blstm.blstm_recurrence, plain=blstm.blstm_recurrence_plain,
        gx_route="row_tiled",
        source="robust_e2e_gan_torch/csrc/blstm.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_pallas.py:332 "
                 "(gate-stream _gx_kernel :210, pallas_call :455)"),
    # att_loc_step's two routes (ops/att.py::utt_plan), counted by route
    "att_loc_step": dict(
        wrapper=att.att_loc_step, plain=att.att_loc_step_plain,
        route="utt",
        source="robust_e2e_gan_torch/csrc/att_loc_utt.cu",
        replaces="robust_e2e_gan_tpu/ops/att_pallas.py:178 "
                 "(pallas_call :251)"),
    "att_loc_step_hyp": dict(
        wrapper=att.att_loc_step, plain=att.att_loc_step_plain,
        route="hyp",
        source="robust_e2e_gan_torch/csrc/att_loc.cu",
        replaces="robust_e2e_gan_tpu/ops/att_pallas.py:178 "
                 "(pallas_call :251)"),
    # the CTC prefix kernels' two routes each (ops/ctc_prefix.py::psi_plan,
    # state_plan), counted by kernel and route; ctc_prefix_state_utt's
    # wrapper on the path is prefix_state_step, with the searcher's gathers
    # and selects in the kernel
    "ctc_prefix_psi_utt": dict(
        wrapper=ctc_prefix.prefix_psi,
        plain=ctc_prefix.prefix_psi_recursion_plain, prefix=("psi", "utt"),
        source="robust_e2e_gan_torch/csrc/ctc_prefix.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py:116 "
                 "(pallas_call :179)"),
    "ctc_prefix_psi": dict(
        wrapper=ctc_prefix.prefix_psi,
        plain=ctc_prefix.prefix_psi_recursion_plain, prefix=("psi", "lane"),
        source="robust_e2e_gan_torch/csrc/ctc_prefix.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py:116 "
                 "(pallas_call :179)"),
    "ctc_prefix_state_utt": dict(
        wrapper=ctc_prefix.prefix_state_step,
        plain=ctc_prefix.prefix_state_plain, prefix=("state", "utt"),
        source="robust_e2e_gan_torch/csrc/ctc_prefix.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py:237 "
                 "(pallas_call :274)"),
    "ctc_prefix_state": dict(
        wrapper=ctc_prefix.prefix_state, plain=ctc_prefix.prefix_state_plain,
        prefix=("state", "lane"),
        source="robust_e2e_gan_torch/csrc/ctc_prefix.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py:237 "
                 "(pallas_call :274)"),
    "blstm_train": dict(
        wrapper=blstm_train.blstm_train, plain=blstm_train.blstm_train_plain,
        source="robust_e2e_gan_torch/csrc/blstm_train_resident.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_train_pallas.py:624"),
    "blstm_train_gx": dict(
        wrapper=blstm_train.blstm_train_gx,
        plain=blstm_train.blstm_train_gx_plain,
        source="robust_e2e_gan_torch/csrc/blstm_train_resident.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_train_pallas.py:1050"),
    # the training BLSTM's products (rows 6 and 7): one tensor-core launch
    # a product for both directions; the SIMT route (gemm_simt_kernel) runs
    # only where phase 3 forces it
    "gemm": dict(
        wrapper=blstm_train.gemm, plain=blstm_train.gemm_plain,
        source="robust_e2e_gan_torch/csrc/gemm.cu",
        replaces="robust_e2e_gan_tpu/ops/blstm_train_pallas.py:150-158, "
                 ":296-308, :346-359, :902-907 (inside pallas_call :489, "
                 ":565, :930, :972)"),
    "ctc_nll": dict(
        wrapper=ctc.ctc_nll, plain=ctc.ctc_nll_plain,
        source="robust_e2e_gan_torch/csrc/ctc_alpha.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_pallas.py:296 "
                 "(with the loss around it, ops/ctc.py:61-90,145-158)"),
    "ctc_alpha": dict(
        wrapper=ctc.ctc_alpha, plain=ctc.ctc_alpha_fwd_plain,
        source="robust_e2e_gan_torch/csrc/ctc_alpha.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_pallas.py:296"),
    # the fused frontend's route "tc" (logmel_tc_kernel, ops/fbank_fused.py::
    # fbank_plan), counted by route; route "simt" (logmel_kernel) runs only
    # where phase 3 forces it
    "fbank_fused": dict(
        wrapper=fbank_fused.fbank_fused, plain=fbank_fused.fbank_fused_plain,
        fbank_route="tc",
        source="robust_e2e_gan_torch/csrc/fbank.cu",
        replaces="robust_e2e_gan_tpu/ops/fbank_pallas.py:147"),
    # the backward with its frame pass on route "tc" (dframes_tc_kernel,
    # ops/fbank_fused.py::fbank_bwd_plan), counted by route; route "simt"
    # (dframes_kernel) runs only where phase 3 forces it
    "fbank_fused_bwd": dict(
        wrapper=fbank_fused.fbank_fused_bwd,
        plain=fbank_fused.fbank_fused_bwd_plain,
        source="robust_e2e_gan_torch/csrc/fbank.cu",
        replaces="robust_e2e_gan_tpu/ops/fbank_pallas.py:448"),
    # lm_step's two routes (ops/lm_step.py::tile_plan), counted by route
    "lm_step": dict(
        wrapper=lm_step.lm_step, plain=lm_step.lm_step_plain,
        lm_route="tile",
        source="robust_e2e_gan_torch/csrc/lm_step_tile.cu",
        replaces="robust_e2e_gan_tpu/ops/lm_step_pallas.py:104 "
                 "(pallas_call :180)"),
    "lm_step_lane": dict(
        wrapper=lm_step.lm_step, plain=lm_step.lm_step_plain,
        lm_route="lane",
        source="robust_e2e_gan_torch/csrc/lm_step.cu",
        replaces="robust_e2e_gan_tpu/ops/lm_step_pallas.py:104 "
                 "(pallas_call :180)"),
    # att_dec_step's two routes (ops/att_dec.py::utt_plan), counted by route
    "att_dec_step": dict(
        wrapper=att_dec.att_dec_step, plain=att_dec.att_dec_step_plain,
        dec_route="utt",
        source="robust_e2e_gan_torch/csrc/att_dec_utt.cu",
        replaces="robust_e2e_gan_tpu/ops/att_pallas.py:416 "
                 "(pallas_call :530)"),
    "att_dec_step_hyp": dict(
        wrapper=att_dec.att_dec_step, plain=att_dec.att_dec_step_plain,
        dec_route="hyp",
        source="robust_e2e_gan_torch/csrc/att_dec.cu",
        replaces="robust_e2e_gan_tpu/ops/att_pallas.py:416 "
                 "(pallas_call :530)"),
    "ctc_prefix_utt": dict(
        wrapper=ctc_prefix.prefix_psi_utt,
        plain=ctc_prefix.prefix_psi_recursion_plain,
        source="robust_e2e_gan_torch/csrc/ctc_prefix_utt.cu",
        replaces="robust_e2e_gan_tpu/ops/ctc_prefix_pallas.py:110"),
}
SERVING = ("blstm_infer", "att_loc_step", "ctc_prefix_psi_utt",
           "ctc_prefix_state_utt")
# the clean-speech serving path: no enhancer, fused frontend, LM fusion
CLEAN_SERVING = ("fbank_fused", "lm_step") + SERVING
# the same in float32, whose BLSTM layers take the row-tiled kernel
F32_CLEAN_SERVING = (("fbank_fused", "lm_step", "blstm_infer_row_tiled")
                     + SERVING[1:])
# the decode CLI with --serving-impls fused: the fused step replaces the
# attention kernel
FUSED_SERVING = ("blstm_infer", "att_dec_step", "ctc_prefix_psi_utt",
                 "ctc_prefix_state_utt")
# the decode CLI's model is float32, whose BLSTM layers the cluster plan
# leaves to the row-tiled kernel
CLI_SERVING = ("blstm_infer_row_tiled",) + FUSED_SERVING[1:]
# the per-utterance prefix search
UTT_SERVING = ("blstm_infer", "att_loc_step", "ctc_prefix_utt",
               "ctc_prefix_state_utt")
LM_WEIGHT = 0.3
# peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): a
# bound takes the rate of its operands' type, the tensor cores' for
# bfloat16 and the CUDA cores' for float32, whatever the kernel itself
# runs on; HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES = 3.35e12
# the kernels of the train step: the D-step's no-grad generator forward
# takes the inference BLSTM kernel; the G-step's CTC loss is ctc_nll, one
# forward and one backward launch (ctc_alpha runs on no path); the BLSTM
# layers' products are gemm's
TRAINING = ("blstm_train", "ctc_nll", "blstm_infer", "gemm")
# csrc/gemm.cu's kernels in a profile: the tensor-core product, the SIMT
# one (run only where forced), the column sum of dbias
GEMM_KERNELS = ("gemm_tc_kernel", "gemm_simt_kernel", "colsum_kernel")
# the bound of a float32 product of gemm.cu: its 3xTF32 runs three tf32
# passes on the tensor cores, whose tf32 peak is 495 TFLOP/s (H100 SXM,
# NVIDIA's data sheet, dense, at 700 W)
TF32X3_FLOPS = 495e12 / 3
# the training BLSTM's two frame-loop routes: W_h resident across a
# co-resident grid (csrc/blstm_train_resident.cu), chosen by
# ops/blstm_train.py::resident_plan, and the row-tiled loops past it
# (csrc/blstm_train.cu)
ROUTES = ("resident", "loop")
# blstm_infer's two routes: W_h split over a thread-block cluster
# (csrc/blstm_infer_cluster.cu), chosen by ops/blstm.py::cluster_plan, and
# the row-tiled kernel past it (csrc/blstm_infer.cu)
INFER_ROUTES = ("cluster", "row_tiled")
# blstm_recurrence's two routes: W_h split by gate columns over a
# co-resident grid (csrc/blstm_gx_grid.cu), chosen by ops/blstm.py::gx_plan,
# and the row-tiled kernel past it (csrc/blstm.cu)
GX_ROUTES = ("grid", "row_tiled")
# their kernels' names in a profile, and the W_x-resident kernels'
BLSTM_KERNELS = ("blstm_gx_grid_kernel", "blstm_rec_kernel",
                 "blstm_infer_kernel", "blstm_infer_cluster_kernel")
# att_loc_step's two routes: one block per utterance (csrc/att_loc_utt.cu),
# chosen by ops/att.py::utt_plan, and one block per hypothesis past it
# (csrc/att_loc.cu)
ATT_ROUTES = ("utt", "hyp")
# att_dec_step's two routes: the attention an utterance a block, then the
# cell over all lanes on a co-resident grid (csrc/att_dec_utt.cu) wherever
# ops/att_dec.py::utt_plan fits, and one block an utterance for the whole
# step past it (csrc/att_dec.cu)
DEC_ROUTES = ("utt", "hyp")
# lm_step's two routes: the gate product over all lanes in tiles on a
# co-resident grid (csrc/lm_step_tile.cu) wherever ops/lm_step.py::tile_plan
# fits, and 8 lanes a block through the whole step past it (csrc/lm_step.cu)
LM_ROUTES = ("tile", "lane")
# their kernels' names in a profile
LM_KERNELS = ("lm_step_tile_kernel", "lm_step_kernel")
# the fused frontend's forward routes: the DFT on the tensor cores in
# 3xTF32 wherever ops/fbank_fused.py::fbank_plan fits, and float32 FMAs a
# thread a bin past it (both csrc/fbank.cu); the backward's frame pass has
# routes of the same names (ops/fbank_fused.py::fbank_bwd_plan)
FBANK_ROUTES = ("tc", "simt")
# the frontend's kernels in a profile: either route's log-mel and CMVN
FRONTEND_KERNELS = ("logmel_tc_kernel", "logmel_kernel", "cmvn_kernel")
# the CTC prefix kernels' two routes: one block per utterance, chosen by
# ops/ctc_prefix.py::psi_plan and state_plan, and one thread per lane past
# them (both csrc/ctc_prefix.cu)
PREFIX_ROUTES = ("utt", "lane")
# their kernels' names in a profile: utt psi and state, lane psi and state
PREFIX_KERNELS = ("psi_lse_kernel", "state_utt_kernel", "::psi_kernel",
                  "::state_kernel")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        k["plain"].calls = 0
    for route in ROUTES:
        blstm_train.ROUTE_LAUNCHES[route] = 0
    for route in blstm_train.GEMM_ROUTE_LAUNCHES:
        blstm_train.GEMM_ROUTE_LAUNCHES[route] = 0
    for route in INFER_ROUTES:
        blstm.INFER_ROUTE_LAUNCHES[route] = 0
    for route in GX_ROUTES:
        blstm.GX_ROUTE_LAUNCHES[route] = 0
    for route in ATT_ROUTES:
        att.ATT_ROUTE_LAUNCHES[route] = 0
    for route in DEC_ROUTES:
        att_dec.DEC_ROUTE_LAUNCHES[route] = 0
    for route in LM_ROUTES:
        lm_step.LM_ROUTE_LAUNCHES[route] = 0
    for route in FBANK_ROUTES:
        fbank_fused.FBANK_ROUTE_LAUNCHES[route] = 0
        fbank_fused.FBANK_BWD_ROUTE_LAUNCHES[route] = 0
    for kind in ctc_prefix.PREFIX_ROUTE_LAUNCHES.values():
        for route in PREFIX_ROUTES:
            kind[route] = 0


def launch_count(name: str) -> int:
    """Launches of kernel ``name`` since the last reset: its wrapper's
    count, or its route's where a wrapper launches two kernels."""
    k = KERNELS[name]
    if "prefix" in k:
        kind, route = k["prefix"]
        return ctc_prefix.PREFIX_ROUTE_LAUNCHES[kind][route]
    if "dec_route" in k:
        return att_dec.DEC_ROUTE_LAUNCHES[k["dec_route"]]
    if "lm_route" in k:
        return lm_step.LM_ROUTE_LAUNCHES[k["lm_route"]]
    if "fbank_route" in k:
        return fbank_fused.FBANK_ROUTE_LAUNCHES[k["fbank_route"]]
    if "gx_route" in k:
        return blstm.GX_ROUTE_LAUNCHES[k["gx_route"]]
    if "route" in k:
        routes = (att.ATT_ROUTE_LAUNCHES if k["route"] in ATT_ROUTES
                  else blstm.INFER_ROUTE_LAUNCHES)
        return routes[k["route"]]
    return k["wrapper"].launches


def require_utt_attention(where: str, n: int) -> None:
    """Every attention launch since the last reset, ``n`` of them, took
    the per-utterance route."""
    routes = dict(att.ATT_ROUTE_LAUNCHES)
    print(f"  att_loc_step launches by route {routes}")
    require(routes == {"utt": n, "hyp": 0},
            f"{where}: not every attention step took the utt route: "
            f"{routes}, expected {n}")


def prefix_routes() -> dict:
    return {n: dict(r) for n, r in ctc_prefix.PREFIX_ROUTE_LAUNCHES.items()}


def require_utt_prefix(where: str, n_psi: int, n_state: int) -> None:
    """Every CTC prefix launch since the last reset took the per-utterance
    route: ``n_psi`` psi and ``n_state`` state launches."""
    routes = prefix_routes()
    print(f"  CTC prefix launches by kernel and route {routes}")
    require(routes == {"psi": {"utt": n_psi, "lane": 0},
                       "state": {"utt": n_state, "lane": 0}},
            f"{where}: not every CTC prefix launch took the utt route: "
            f"{routes}, expected {n_psi} psi and {n_state} state")


def on_prefix_route(route, fn):
    """``fn`` with every psi and state launch on ``route``."""
    def run(*args):
        with ctc_prefix._force_prefix_route(route):
            return fn(*args)
    return run


def on_att_route(route, fn):
    """``fn`` with every ``att_loc_step`` launch on ``route``."""
    def run(*args):
        with att._force_att_route(route):
            return fn(*args)
    return run


def on_dec_route(route, fn):
    """``fn`` with every ``att_dec_step`` launch on ``route``."""
    def run(*args):
        with att_dec._force_dec_route(route):
            return fn(*args)
    return run


def on_fbank_route(route, fn):
    """``fn`` with every fused-frontend launch on ``route``."""
    def run(*args):
        with fbank_fused._force_fbank_route(route):
            return fn(*args)
    return run


def on_fbank_bwd_route(route, fn):
    """``fn`` with every fused-frontend backward's frame pass on
    ``route``."""
    def run(*args):
        with fbank_fused._force_fbank_bwd_route(route):
            return fn(*args)
    return run


def require_tc_frontend(where: str, n: int) -> None:
    """Every fused-frontend launch since the last reset, ``n`` of them,
    took route "tc"."""
    routes = dict(fbank_fused.FBANK_ROUTE_LAUNCHES)
    print(f"  fbank_fused launches by route {routes}")
    require(routes == {"tc": n, "simt": 0},
            f"{where}: not every fused-frontend launch took the tc route: "
            f"{routes}, expected {n}")


def on_lm_route(route, fn):
    """``fn`` with every ``lm_step`` launch on ``route``."""
    def run(*args):
        with lm_step._force_lm_route(route):
            return fn(*args)
    return run


def require_lm_route(where: str, route: str, n: int) -> None:
    """Every LM step since the last reset, ``n`` of them, took ``route``."""
    routes = dict(lm_step.LM_ROUTE_LAUNCHES)
    print(f"  lm_step launches by route {routes}")
    require(routes == {r: n * (r == route) for r in LM_ROUTES},
            f"{where}: not every LM step took the {route} route: {routes}, "
            f"expected {n}")


def require_utt_dec(where: str, n: int) -> None:
    """Every fused decoder step since the last reset, ``n`` of them, took
    route "utt"."""
    routes = dict(att_dec.DEC_ROUTE_LAUNCHES)
    print(f"  att_dec_step launches by route {routes}")
    require(routes == {"utt": n, "hyp": 0},
            f"{where}: not every fused decoder step took the utt route: "
            f"{routes}, expected {n}")


def require_resident(where: str) -> None:
    """Every training BLSTM layer since the last reset took the resident
    frame loops: the plan fits every flagship and train CLI layer."""
    routes = dict(blstm_train.ROUTE_LAUNCHES)
    print(f"  frame-loop launches by route {routes}")
    require(routes["resident"] > 0 and routes["loop"] == 0,
            f"{where}: the training BLSTM layers did not all take the "
            f"resident frame loops: {routes}")


def counts(names):
    return ({n: launch_count(n) for n in names},
            {n: KERNELS[n]["plain"].calls for n in KERNELS})


def cuda_ms(fn, reps: int, ahead: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up.
    With ``ahead``, a sleep kernel (~50 ms) first holds the stream while
    the host enqueues every call, so that calls whose host time exceeds
    their device time are timed on the device alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 50) -> float:
    """Mean host time of one call of ``fn`` without waiting for the device:
    what a launch costs the host, and whether the call blocks."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested lists allowed), each counted once."""
    total = 0
    for x in tensors:
        if isinstance(x, (list, tuple)):
            total += nbytes(*x)
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def entry(name, err, ms, plain_ms, flops, moved, dtype, library_ms=None,
          rate=None) -> dict:
    """A kernel's numbers for the JSON line. ``bound_ms``: the larger of
    ``flops`` (the operations the function needs on these inputs) over the
    card's peak for the operands' ``dtype``, or over ``rate`` where given
    (``TF32X3_FLOPS``: float32 products run as 3xTF32 on the tensor
    cores), and ``moved`` (its inputs read once, its outputs written once)
    over the memory rate."""
    t_ops = flops / (rate or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = moved / HBM_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    peak = "3xTF32" if rate == TF32X3_FLOPS else f"{dtype}"
    print(f"    {name}: {ms:.3f} ms (plain {plain_ms:.3f}"
          f"{f', library {library_ms:.3f}' if library_ms else ''}); "
          f"bound {bound:.4f} ms by {by} ({flops / 1e9:.3f} GFLOP at the "
          f"{peak} peak, {moved / 1e6:.2f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


def lstm_library_ms(x, lengths, h, train: bool) -> float:
    """Device time of cuDNN's bidirectional LSTM (``torch.nn.LSTM`` over a
    packed sequence, the input projection included) on x (B, T, D): the
    forward alone, or the forward and every gradient for a random
    cotangent. A yardstick only: the port never calls it."""
    return cuda_ms(lstm_library_fn(x, lengths, h, train), 3)


def lstm_library_fn(x, lengths, h, train: bool):
    """A call of cuDNN's LSTM as ``lstm_library_ms`` times it, for timing
    in turns with other calls (in float32 where cuDNN refuses x's
    type)."""
    from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence

    def make(x):
        lstm = torch.nn.LSTM(x.shape[-1], h, batch_first=True,
                             bidirectional=True).to(x.device, x.dtype)
        lstm.flatten_parameters()  # cuDNN's one weight buffer
        packed = pack_padded_sequence(x, lengths.cpu().long(),
                                      batch_first=True, enforce_sorted=False)
        data = packed.data.detach().requires_grad_(train)
        seq = PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                             packed.unsorted_indices)
        if not train:
            def forward():
                with torch.inference_mode():
                    return lstm(seq)
            return forward
        dy = torch.randn((data.shape[0], 2 * h), device=x.device,
                         dtype=x.dtype)
        leaves = [data, *lstm.parameters()]
        return lambda: torch.autograd.grad(lstm(seq)[0].data, leaves, dy)

    fn = make(x)
    try:
        fn()
    except RuntimeError as exc:  # a cuDNN build without bfloat16 RNNs
        print(f"    cuDNN LSTM refused {x.dtype} ({str(exc)[:100]}); "
              "library time taken in float32")
        fn = make(x.float())
    return fn


def compare(name, got, want, rtol=0.0, atol=0.0, scale_atol=0.0):
    """Largest |got - want| and whether every element is within
    atol + rtol * |want| (+ scale_atol * max|want|)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        limit = atol + scale_atol * w.abs().max().item()
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        ok &= bool((diff <= limit + rtol * w.abs()).all())
    print(f"  {name}: max_abs_err {err:.3e}  limit atol {atol:g}"
          f"{f' + {scale_atol:g}*max|plain|' if scale_atol else ''}"
          f"{f' + rtol {rtol:g}*|plain|' if rtol else ''}  "
          f"{'ok' if ok else 'FAIL'}")
    return err, ok


# ---------------------------------------------------------------------------
# phase 3: kernel parity at main-path shapes
# ---------------------------------------------------------------------------


def blstm_inputs(gen, b, t, h, dtype, dev):
    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    wh = torch.randn((2, h, 4 * h), generator=gen, device=dev) / h ** 0.5
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = t
    return gx, wh.to(dtype).contiguous(), lengths


def att_inputs(gen, b, k, t, c, a, e, dtype, dev):
    def rnd(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * scale).to(dtype)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[None] < lens[:, None]).to(dtype)
    return (rnd(b, k, t, c, scale=0.05), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a, scale=0.3), rnd(a, scale=0.1), mask)


def ctc_inputs(gen, b, k, t, v, dev):
    """Masked log-probs and parent states two tokens deep, built with the
    plain version."""
    lpz = torch.log_softmax(3 * torch.randn((b, t, v), generator=gen,
                                            device=dev), -1)
    hl = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    pad = torch.full((v,), ctc_prefix.LOG_ZERO, device=dev)
    pad[0] = 0.0
    valid = torch.arange(t, device=dev)[None] < hl[:, None]
    lpz = torch.where(valid[..., None], lpz, pad).contiguous()
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for _ in range(2):
        tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        r_n, r_b = ctc_prefix.prefix_state_plain(lpz, tok, last, lens, r_n,
                                                 r_b, 0)
        last, lens = tok, lens + 1
    tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                        dtype=torch.int32)
    tok[:, 0] = last[:, 0]  # repeated tokens take the r_b branch
    return lpz, tok, last, lens, r_n, r_b


def prefix_parity(gen, b, t, dev):
    """Phase 3's CTC prefix kernels at B utterances, beam 8, T frames, V=52:
    psi, the state and the state step of a beam step (parents at random,
    a quarter of the lanes appending nothing) on both routes against their
    plain versions, then timed in turns with the host ahead (a call's host
    time is near its device time). Returns (JSON rows, all agree)."""
    lpz, tok, last, lens, r_n, r_b = ctc_inputs(gen, b, BEAM, t, VOCAB, dev)
    k_idx = torch.randint(0, BEAM, (b, BEAM), generator=gen, device=dev)
    append = torch.rand((b, BEAM), generator=gen, device=dev) < 0.75
    step_tok = tok.clone()
    step_tok[:, 1] = ctc_prefix.gather_beam(last, k_idx)[:, 1]
    fns = {
        "psi": (lambda: [ctc_prefix.prefix_psi(lpz, last, lens, r_n, r_b, 0,
                                               1)],
                lambda: [ctc_prefix.prefix_psi_plain(lpz, last, lens, r_n,
                                                     r_b, 0, 1)]),
        "state": (lambda: ctc_prefix.prefix_state(lpz, tok, last, lens, r_n,
                                                  r_b, 0),
                  lambda: ctc_prefix.prefix_state_plain(lpz, tok, last, lens,
                                                        r_n, r_b, 0)),
        "state step": (lambda: ctc_prefix.prefix_state_step(
            lpz, k_idx, step_tok, append, last, lens, r_n, r_b, 0),
            lambda: ctc_prefix.prefix_state_step_plain(
                lpz, k_idx, step_tok, append, last, lens, r_n, r_b, 0)),
    }
    errs, ok_all = {}, True
    for name, (kernel, plain) in fns.items():
        want = plain()
        for route in PREFIX_ROUTES:
            errs[name, route], ok = compare(
                f"ctc_prefix {name} {route} B={b} K={BEAM} T={t} V={VOCAB}",
                on_prefix_route(route, kernel)(), want, atol=1e-3)
            ok_all &= ok
    print(f"    plans at B={b}: psi (frame splits, chunk frames) "
          f"{ctc_prefix._psi_plan_on(dev.index or 0, BEAM, t, VOCAB)}, "
          f"state chunk frames "
          f"{ctc_prefix._state_plan_on(dev.index or 0, BEAM, t, VOCAB)}; "
          f"{b} CTAs each")
    runs = [on_prefix_route(r, fns[n][0]) for n in fns for r in PREFIX_ROUTES]
    ms = dict(zip([(n, r) for n in fns for r in PREFIX_ROUTES],
                  cuda_ms_in_turns(runs, 20, ahead=True)))
    host = {key: host_us(fn) for key, fn in zip(ms, runs)}
    for name in fns:
        print(f"    B={b} {name} ms in turns: utt {ms[name, 'utt']:.4f}, lane "
              f"{ms[name, 'lane']:.4f}; host time per call: utt "
              f"{host[name, 'utt']:.1f} us, lane {host[name, 'lane']:.1f} us")
    psi_moved = nbytes(lpz, last, lens, r_n, r_b, fns["psi"][0]())
    state_moved = nbytes(lpz, tok, last, lens, r_n, r_b, fns["state"][0]())
    plain_ms = {n: cuda_ms(fns[n][1], 5) for n in ("psi", "state")}
    rows = {}
    # one log-space update (~8 operations) per (b, k, v, frame) for psi,
    # two per (b, k, frame) for the state
    for name, kind, route in (("ctc_prefix_psi_utt", "psi", "utt"),
                              ("ctc_prefix_psi", "psi", "lane"),
                              ("ctc_prefix_state_utt", "state", "utt"),
                              ("ctc_prefix_state", "state", "lane")):
        flops = (8 * b * BEAM * VOCAB * t if kind == "psi"
                 else 16 * b * BEAM * t)
        moved = psi_moved if kind == "psi" else state_moved
        err = errs[kind, route]
        if kind == "state":
            err = max(err, errs["state step", route])
        rows[name] = entry(name, err, ms[kind, route], plain_ms[kind], flops,
                           moved, lpz.dtype)
    return rows, ok_all


def on_gx_route(route, fn):
    """``fn`` with every ``blstm_recurrence`` launch on ``route``."""
    def run(*args):
        with blstm._force_gx_route(route):
            return fn(*args)
    return run


def blstm_gx_parity(gen, b, t_enh, t_enc, jcfg, dev):
    """Both routes of ``blstm_recurrence`` against its plain version (h
    rounded) at the flagship's enhancer and encoder layer shapes (H=256)
    and at the wide encoder's layer 0 (H=1,024, D=2,560), float32 and
    bfloat16; then the grid route, the row-tiled route and cuDNN's LSTM
    from x (TF32 off) timed in turns at row 1b's shape (the enhancer layer
    0, bfloat16) and at the wide layer in float32 and bfloat16, each with
    the grid plan and its bound: the recurrence needs 2 * 4H * H
    multiply-adds per valid frame and direction (cuDNN computes the input
    projection too), at the 3xTF32 peak in float32 (the grid route's
    products) and the bfloat16 peak in bfloat16. Returns (both routes'
    rows at the wide layer in float32, the shape phase 15 launches them
    at, whether every shape agreed)."""
    f32, bf16 = torch.float32, torch.bfloat16
    enc = jcfg.e2e.encoder
    d_vgg = subsampled_frames(enc.input_dim) * enc.vgg_channels[-1]
    shapes = (("enhancer", t_enh, jcfg.enhancer.input_dim,
               jcfg.enhancer.hidden_dim),
              ("encoder", t_enc, enc.proj_dim, enc.hidden_dim),
              ("wide encoder", t_enc, d_vgg, WIDE))
    timed_at = {("enhancer", bf16), ("wide encoder", f32),
                ("wide encoder", bf16)}
    rows, ok_all = {}, True
    for tag, t, d, h in shapes:
        for dt in (f32, bf16):
            gx, wh, lengths = blstm_inputs(gen, b, t, h, dt, dev)

            def kernel(gx=gx, wh=wh, lengths=lengths):
                return blstm.blstm_recurrence(gx, wh, lengths)

            def plain(gx=gx, wh=wh, lengths=lengths):
                return blstm.blstm_recurrence_plain(gx, wh, lengths,
                                                    round_h=True)

            want = plain()
            tol = dict(rtol=1e-4, atol=1e-5) if dt == f32 else dict(
                scale_atol=2e-2)
            errs = {}
            for route in GX_ROUTES:
                errs[route], ok = compare(
                    f"blstm_recurrence {route} {tag} B={b} T={t} H={h} {dt}",
                    [on_gx_route(route, kernel)()], [want], **tol)
                ok_all &= ok
            valid = int(lengths.sum())
            print(f"    (B={b} valid frames {valid})")
            if (tag, dt) not in timed_at:
                continue
            print(f"    grid plan {tuple(blstm._gx_grid(b, h, wh))} "
                  f"({'|'.join(blstm.GxPlan._fields)})")
            x = torch.randn((b, t, d), device=dev, dtype=dt)
            ms = cuda_ms_in_turns([on_gx_route("grid", kernel),
                                   on_gx_route("row_tiled", kernel),
                                   lstm_library_fn(x, lengths, h,
                                                   train=False)], 3)
            print(f"    {tag} D={d} {dt}, ms in turns: grid {ms[0]:.3f}, "
                  f"row-tiled {ms[1]:.3f}, cuDNN LSTM from x {ms[2]:.3f}")
            plain_ms = cuda_ms(plain, 1)
            flops, moved = 2 * valid * 2 * 4 * h * h, nbytes(gx, wh, lengths,
                                                            want)
            for name, route, v in (("blstm_recurrence", "grid", ms[0]),
                                   ("blstm_recurrence_row_tiled",
                                    "row_tiled", ms[1])):
                row = entry(f"{name} {tag} {dt}", errs[route], v, plain_ms,
                            flops, moved, dt, ms[2],
                            TF32X3_FLOPS if dt == f32 else None)
                if (tag, dt) == ("wide encoder", f32):
                    rows[name] = row
    return rows, ok_all


def on_infer_route(route, fn):
    """``fn`` with every ``blstm_infer`` launch on ``route``."""
    def run(*args):
        with blstm._force_infer_route(route):
            return fn(*args)
    return run


def blstm_infer_parity(gen, b, t_enh, t_enc, jcfg, dev):
    """Both routes of ``blstm_infer`` against its plain version at the
    flagship's four BLSTM layers and at one H = 512 layer, the reference
    encoder's layer 0 at this batch (float32: the row-tiled route, the
    only one the plan gives float32; bfloat16: the cluster and the
    row-tiled routes), and per layer in bfloat16 the times, taken in
    turns, of the cluster route, the row-tiled route, the gate-stream
    route (the cuBLAS projection, then ``csrc/blstm.cu``) and cuDNN's LSTM
    from x. Returns (the entries of both kernels at enhancer layer 0,
    whether every layer agreed)."""
    f32, bf16 = torch.float32, torch.bfloat16
    enc = jcfg.e2e.encoder
    h_enh, h_enc = jcfg.enhancer.hidden_dim, enc.hidden_dim
    d_vgg = subsampled_frames(enc.input_dim) * enc.vgg_channels[-1]
    layers = (("enhancer0", t_enh, jcfg.enhancer.input_dim, h_enh),
              ("enhancer1", t_enh, 2 * h_enh, h_enh),
              ("encoder0", t_enc, d_vgg, h_enc),
              ("encoder1", t_enc, enc.proj_dim, h_enc),
              ("H=512 encoder0", t_enc, d_vgg, 512))
    names = ("cluster", "row-tiled", "projection + blstm_recurrence",
             "cuDNN LSTM")
    ok_all, rows, total = True, {}, [0.0] * len(names)
    for tag, t, d, h in layers:
        for dt in (f32, bf16):
            x, wx, wh, bias, lengths, _ = train_inputs(gen, b, t, d, h, dt,
                                                       dev)
            x = x.to(dt)

            def kernel(x=x, wx=wx, wh=wh, bias=bias, lengths=lengths):
                return blstm.blstm_infer(x, lengths, wx, wh, bias)

            def plain(x=x, wx=wx, wh=wh, bias=bias, lengths=lengths):
                return blstm.blstm_infer_plain(x, lengths, wx, wh, bias)

            want = plain()
            tol = dict(rtol=1e-4, atol=1e-5) if dt == f32 else dict(
                scale_atol=2e-2)
            errs = {}
            if dt == bf16:
                plan = blstm._cluster(b, d, h, wh)
                at_once = blstm._clusters_at_once(wh.device.index, plan[0],
                                                  plan[4])
                print(f"    cluster plan (C, R, F, W_x resident, shared "
                      f"memory bytes) {plan}; clusters of {plan[0]} the "
                      f"card runs at once: {at_once}")
            for route in (("row_tiled",) if dt == f32 else INFER_ROUTES):
                got = on_infer_route(route, kernel)()
                errs[route], ok = compare(
                    f"blstm_infer {route} {tag} B={b} T={t} D={d} H={h} "
                    f"{dt}", [got], [want], **tol)
                ok_all &= ok
            if dt != bf16:
                continue
            ms = cuda_ms_in_turns(
                [on_infer_route("cluster", kernel),
                 on_infer_route("row_tiled", kernel),
                 lambda: blstm.blstm_recurrence(
                     input_projection(x, wx, bias, dt), wh, lengths),
                 lstm_library_fn(x, lengths, h, train=False)], 3)
            if not tag.startswith("H=512"):
                for i, v in enumerate(ms):
                    total[i] += v
            print(f"    {tag} {dt} (valid frames {int(lengths.sum())}), ms "
                  "in turns: " + ", ".join(
                      f"{n} {v:.3f}" for n, v in zip(names, ms)))
            if tag == "enhancer0":
                # per valid frame and direction: the projection (D * 4H
                # multiply-adds) and the recurrent product (H * 4H)
                plain_ms = cuda_ms(plain, 1)
                for name, route, v in (("blstm_infer", "cluster", ms[0]),
                                       ("blstm_infer_row_tiled", "row_tiled",
                                        ms[1])):
                    rows[name] = entry(
                        name, errs[route], v, plain_ms,
                        2 * int(lengths.sum()) * 2 * 4 * h * (d + h),
                        nbytes(x, wx, wh, bias, lengths, want), dt, ms[3])
    print("    the four layers, bf16, ms in turns: " + ", ".join(
        f"{n} {v:.3f}" for n, v in zip(names, total)))
    return rows, ok_all


def oversize_blstm(dev) -> int:
    """One BLSTM layer past the fit rule, through ``models/rnn.py::BLSTM``
    on the card: B=16, T=72, D=32,768, H=256 in bfloat16, where W_x alone
    (128 MB) is over the JAX kernel's 64 MB budget. It must take the
    gate-stream kernel on its grid route and agree with its plain
    version."""
    b, t, d, h, dt = 16, 72, 32768, 256, torch.bfloat16
    require(blstm.infer_kernel_for(b, t, d, h, dt) == "gx",
            "the fit rule keeps the oversize layer in the W_x-resident kernel")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    layer = BLSTM(d, h, dt, "auto").to(dev)
    with torch.no_grad():
        for p, scale in ((layer.wx, d ** -0.5), (layer.wh, h ** -0.5),
                         (layer.bias, 0.3)):
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * scale)
    x = torch.randn((b, t, d), generator=gen, device=dev)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = t
    mask = (torch.arange(t, device=dev)[None] < lengths[:, None]).float()
    reset_counts()
    with torch.inference_mode():
        got = layer(x, mask)
        launches, plain_calls = counts(("blstm_recurrence",
                                        "blstm_recurrence_row_tiled",
                                        "blstm_infer",
                                        "blstm_infer_row_tiled"))
        want = blstm.blstm_recurrence_plain(
            input_projection(x, layer.wx, layer.bias, dt),
            layer.wh.to(dt), lengths, round_h=True)
    print(f"  oversize BLSTM layer: launches {launches}")
    require(launches == {"blstm_recurrence": 1,
                         "blstm_recurrence_row_tiled": 0, "blstm_infer": 0,
                         "blstm_infer_row_tiled": 0},
            f"the oversize layer did not take the gate-stream kernel's "
            f"grid route: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran in the oversize layer: {plain_calls}")
    _, ok = compare(f"BLSTM(auto) B={b} T={t} D={d} H={h} {dt} vs plain",
                    [got], [want], scale_atol=2e-2)
    require(ok, "the oversize layer disagrees with its plain version")


def kernel_parity(b: int, t_enh: int, t_enc: int, jcfg, dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    acfg = jcfg.e2e.attention
    e_dim = jcfg.e2e.encoder.proj_dim
    f32, bf16 = torch.float32, torch.bfloat16
    res = {}
    rows, ok_all = blstm_infer_parity(gen, b, t_enh, t_enc, jcfg, dev)
    res.update(rows)

    # BLSTM recurrence (gate stream): both routes, the flagship's layer
    # shapes and the wide encoder's
    rows, ok = blstm_gx_parity(gen, b, t_enh, t_enc, jcfg, dev)
    res.update(rows)
    ok_all &= ok

    # attention step: both routes, timed in turns with the plain version
    sharp = acfg.sharpening
    c, a = acfg.conv_channels, acfg.dim
    for dt in (f32, bf16):
        args = att_inputs(gen, b, BEAM, t_enc, c, a, e_dim, dt, dev)
        want = att.att_loc_step_plain(*args, sharp)
        tol = (dict(rtol=1e-4, atol=1e-5) if dt == f32
               else dict(scale_atol=2e-2))
        errs = {}
        for route in ATT_ROUTES:
            got = on_att_route(route, att.att_loc_step)(*args, sharp)
            errs[route], ok = compare(
                f"att_loc_step {route} B={b} K={BEAM} T={t_enc} {dt}",
                got, want, **tol)
            ok_all &= ok
        print(f"    utt plan (chunk frames, column splits, shared memory "
              f"bytes) {att._utt(b, BEAM, t_enc, c, a, e_dim, args[2])}, "
              f"{b} CTAs")
        fns = [on_att_route(r, lambda: att.att_loc_step(*args, sharp))
               for r in ATT_ROUTES]
        # the host ahead: a call's host time (~50 us) is near its device
        # time
        ms = cuda_ms_in_turns(
            fns + [lambda: att.att_loc_step_plain(*args, sharp)], 20,
            ahead=True)
        print(f"    {dt} ms in turns: utt {ms[0]:.4f}, hyp {ms[1]:.4f}, "
              f"plain {ms[2]:.4f}; host time per call: utt "
              f"{host_us(fns[0]):.1f} us, hyp {host_us(fns[1]):.1f} us")
        if dt == bf16:
            # per (b, k): location projection, energies, softmax, context
            flops = b * BEAM * (t_enc * (2 * c * a + 6 * a + 5)
                                + 2 * t_enc * e_dim)
            for name, route, v in (("att_loc_step", "utt", ms[0]),
                                   ("att_loc_step_hyp", "hyp", ms[1])):
                res[name] = entry(name, errs[route], v, ms[2], flops,
                                  nbytes(args, want), dt)
        # the parity phases' B=16, where the route rule
        # (ops/att.py::utt_preferred) decides by dtype
        small = att_inputs(gen, 16, BEAM, t_enc, c, a, e_dim, dt, dev)
        ms = cuda_ms_in_turns(
            [on_att_route(r, lambda: att.att_loc_step(*small, sharp))
             for r in ATT_ROUTES], 20, ahead=True)
        print(f"    {dt} B=16 ms in turns: utt {ms[0]:.4f}, hyp {ms[1]:.4f}; "
              f"default route "
              f"{'utt' if att._utt(16, BEAM, t_enc, c, a, e_dim, small[2]) else 'hyp'}")

    # CTC prefix psi and state (float32 only, as in the JAX package)
    for bb in (b, 16):
        rows, ok = prefix_parity(gen, bb, t_enc, dev)
        ok_all &= ok
        if bb == b:
            res.update(rows)
    lpz, tok, last, lens, r_n, r_b = ctc_inputs(gen, b, BEAM, t_enc, VOCAB,
                                                dev)

    def psi_plain():
        return ctc_prefix.prefix_psi_plain(lpz, last, lens, r_n, r_b, 0, 1)

    # the per-utterance psi kernel (row 12): the same function, eos and
    # blank columns included; at B utterances and at B=16, T=1,200 (the
    # ring of frame chunks takes any length)
    def utt_kernel():
        return ctc_prefix.prefix_psi_utt(lpz, last, lens, r_n, r_b, 0, 1)

    err, ok = compare(f"ctc_prefix_utt B={b} K={BEAM} T={t_enc} V={VOCAB}",
                      [utt_kernel()], [psi_plain()], atol=1e-3)
    ok_all &= ok
    long_in = ctc_inputs(gen, 16, BEAM, LONG_T, VOCAB, dev)
    long_err, ok = compare(
        f"ctc_prefix_utt B=16 K={BEAM} T={LONG_T} V={VOCAB}",
        [ctc_prefix.prefix_psi_utt(*long_in[:1], *long_in[2:], 0, 1)],
        [ctc_prefix.prefix_psi_plain(*long_in[:1], *long_in[2:], 0, 1)],
        atol=1e-3)
    ok_all &= ok
    print(f"    utt psi plan (frame splits, chunk frames, stages): "
          f"{ctc_prefix._utt_psi_plan_on(dev.index or 0, BEAM, t_enc, VOCAB)}"
          f" at T={t_enc}, "
          f"{ctc_prefix._utt_psi_plan_on(dev.index or 0, BEAM, LONG_T, VOCAB)}"
          f" at T={LONG_T}")
    # in turns with row 3's route "utt" on the same inputs, the host ahead
    ms = cuda_ms_in_turns(
        [utt_kernel, on_prefix_route("utt", lambda: ctc_prefix.prefix_psi(
            lpz, last, lens, r_n, r_b, 0, 1))], 20, ahead=True)
    print(f"    psi ms in turns: ctc_prefix_utt (row 12) {ms[0]:.4f}, "
          f"ctc_prefix_psi_utt (row 3) {ms[1]:.4f}")
    res["ctc_prefix_utt"] = entry(
        "ctc_prefix_utt", max(err, long_err), ms[0], cuda_ms(psi_plain, 5),
        8 * b * BEAM * VOCAB * t_enc,
        nbytes(lpz, last, lens, r_n, r_b, utt_kernel()), lpz.dtype)
    print(f"    host time per call: ctc_prefix_utt {host_us(utt_kernel):.1f} "
          "us")

    rows, ok = dec_step_parity(gen, b, t_enc, jcfg, dev)
    res.update(rows)
    ok_all &= ok
    require(ok_all, "a kernel disagrees with its plain version")
    return res


def dec_step_parity(gen, b, t_enc, jcfg, dev):
    """The fused decoder step on both routes against its plain version,
    timed in turns: (the kernels line's rows, all agreed)."""
    acfg = jcfg.e2e.attention
    e_dim = jcfg.e2e.encoder.proj_dim
    f32, bf16 = torch.float32, torch.bfloat16
    res, ok_all = {}, True
    # the flagship's decoder widths at B=128 and B=16, and the decode
    # CLI's f32 model (A = E = EMB = H = 512, V = 12) at its task's longest
    # utterance; timed in turns with att_loc_step alone (the attention that
    # the fused step adds the cell to, on its default route) and the plain
    # version, the host ahead
    emb_dim = jcfg.e2e.decoder.embed_dim
    h_dec = jcfg.e2e.decoder.hidden_dim
    cli = DecoderConfig()  # the train and decode CLIs' defaults
    t_cli = subsampled_frames(num_frames(SyntheticConfig().max_samples,
                                         jcfg.e2e.frontend))
    cases = [("flagship", bb, dt, t_enc, acfg, e_dim, emb_dim, h_dec, VOCAB)
             for bb in (b, 16) for dt in (f32, bf16)]
    cases.append(("CLI", b, f32, t_cli, AttentionConfig(),
                  EncoderConfig().proj_dim, cli.embed_dim, cli.hidden_dim,
                  SyntheticConfig().vocab_size))
    for tag, bb, dt, t, dcfg, e, embd, h, v in cases:
        args = dec_step_inputs(gen, bb, BEAM, t, dcfg, e, embd, h, v, dt,
                               dev)
        want = att_dec.att_dec_step_plain(*args)
        tol = (dict(rtol=1e-4, atol=1e-5) if dt == f32
               else dict(scale_atol=2e-2))
        errs = {}
        for route in DEC_ROUTES:
            got = on_dec_route(route, att_dec.att_dec_step)(*args)
            errs[route], ok = compare(
                f"att_dec_step {route} {tag} B={bb} K={BEAM} T={t} "
                f"A={dcfg.dim} E={e} EMB={embd} H={h} V={v} {dt}", got,
                want, **tol)
            ok_all &= ok
        plan = att_dec._utt(bb, BEAM, t, dcfg.conv_channels, dcfg.dim, e,
                            embd, h, v, args[2])
        print(f"    utt plan (chunk frames, column splits, readout columns, "
              f"grid, shared memory bytes) {plan}")
        fns = [on_dec_route(r, lambda: att_dec.att_dec_step(*args))
               for r in DEC_ROUTES]
        ms = cuda_ms_in_turns(
            fns + [lambda: att.att_loc_step(*args[:8]),
                   lambda: att_dec.att_dec_step_plain(*args)], 20,
            ahead=True)
        print(f"    {tag} B={bb} {dt} ms in turns: utt {ms[0]:.4f}, hyp "
              f"{ms[1]:.4f}, att_loc_step alone {ms[2]:.4f}, plain "
              f"{ms[3]:.4f}; host time per call: utt {host_us(fns[0]):.1f} "
              f"us, hyp {host_us(fns[1]):.1f} us")
        if tag == "flagship" and bb == b and dt == bf16:
            c, a = dcfg.conv_channels, dcfg.dim
            n = bb * BEAM
            # the attention as att_loc_step, then per lane the gate products
            # over [emb | ctx | z], the readout over [z | ctx] and ~10
            # operations per unit for the cell
            flops = (n * (t * (2 * c * a + 6 * a + 5) + 2 * t * e)
                     + n * (2 * (embd + e + h) * 4 * h
                            + 2 * (h + e) * v + 10 * h))
            for name, route, m in (("att_dec_step", "utt", ms[0]),
                                   ("att_dec_step_hyp", "hyp", ms[1])):
                res[name] = entry(name, errs[route], m, ms[3], flops,
                                  nbytes(args[:7], args[8:], want), dt)
    return res, ok_all


def dec_step_inputs(gen, b, k, t, acfg, e, emb_dim, h, v, dtype, dev):
    """The fused decoder step's arguments: the attention's as att_inputs,
    token ids, the cell and readout weights at their initialisers' scales
    in the compute dtype, f32 biases and an f32 state."""
    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    f32 = torch.float32
    return (*att_inputs(gen, b, k, t, acfg.conv_channels, acfg.dim, e, dtype,
                        dev),
            acfg.sharpening,
            torch.randint(0, v, (b, k), generator=gen, device=dev),
            rnd(v, emb_dim), rnd(emb_dim + e, 4 * h, scale=(emb_dim + e) ** -0.5),
            rnd(h, 4 * h, scale=h ** -0.5), rnd(4 * h, scale=0.1, dt=f32),
            rnd(h + e, v, scale=(h + e) ** -0.5), rnd(v, scale=0.1, dt=f32),
            rnd(b, k, h, scale=0.5, dt=f32), rnd(b, k, h, scale=0.5, dt=f32))


def train_inputs(gen, b, t, d, h, dtype, dev):
    x = torch.randn((b, t, d), generator=gen, device=dev)
    wx = (torch.randn((2, d, 4 * h), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    bias = torch.randn((2, 4 * h), generator=gen, device=dev) * 0.3
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = t
    dy = torch.randn((b, t, 2 * h), generator=gen, device=dev)
    return x, wx, wh, bias, lengths, dy


def with_grads(fn, leaves, dy):
    """fn(*leaves) and its gradients for the cotangent dy."""
    leaves = [a.detach().requires_grad_() for a in leaves]
    y = fn(*leaves)
    return [y] + list(torch.autograd.grad(y.float().mul(dy).sum(), leaves))


def grad_tols(dt):
    """(output, gradient) limits: float32 sums in another order; gradients
    sum over B*T rows, so their limit scales with their size; bf16 one
    rounding of the outputs."""
    if dt == torch.float32:
        return dict(rtol=1e-4, atol=1e-5), dict(scale_atol=1e-4)
    return dict(scale_atol=2e-2), dict(scale_atol=2e-2)


def train_kernel_parity(jcfg, t_enh, t_enc, dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    b, res, ok_all = TRAIN_BATCH, {}, True
    names = ("y", "dx", "dwx", "dwh", "dbias")
    h_enh, h_enc = jcfg.enhancer.hidden_dim, jcfg.e2e.encoder.hidden_dim
    d_enc = subsampled_frames(jcfg.e2e.encoder.input_dim) * \
        jcfg.e2e.encoder.vgg_channels[-1]

    # blstm_train: flagship enhancer layer 0 and encoder layer 0
    for tag, t, d, h in (("enhancer0", t_enh, jcfg.enhancer.input_dim, h_enh),
                         ("encoder0", t_enc, d_enc, h_enc)):
        for dt in (f32, bf16):
            x, wx, wh, bias, lengths, dy = train_inputs(gen, b, t, d, h, dt,
                                                        dev)

            def run(fn, x=x, wx=wx, wh=wh, bias=bias, lengths=lengths,
                    dy=dy):
                return with_grads(lambda *a: fn(a[0], lengths, *a[1:]),
                                  [x, wx, wh, bias], dy)

            want = run(blstm_train.blstm_train_plain)
            out_tol, g_tol = grad_tols(dt)
            errs = []
            for route in ROUTES:  # both frame-loop routes
                with blstm_train._force_route(route):
                    got = run(blstm_train.blstm_train)
                for name, g, w in zip(names, got, want):
                    err, ok = compare(
                        f"blstm_train {route} {tag} {name} B={b} T={t} D={d} "
                        f"H={h} {dt}", [g], [w],
                        **(out_tol if name == "y" else g_tol))
                    ok_all &= ok
                    errs.append(err)
            if tag == "enhancer0" and dt == bf16:
                valid = int(lengths.sum())
                ms = route_ms(lambda: run(blstm_train.blstm_train), 3)
                # per valid frame: the projection, dx and dW_x (2 * D * 8H
                # each), the recurrence, dh and dW_h (2 * 2 * 4H * H each)
                res["blstm_train"] = entry(
                    "blstm_train", max(errs), ms["resident"],
                    cuda_ms(lambda: run(blstm_train.blstm_train_plain), 1),
                    valid * 3 * (2 * d * 8 * h + 16 * h * h),
                    nbytes(x, wx, wh, bias, lengths, dy, got), dt,
                    lstm_library_ms(x.to(dt), lengths, h, train=True))
                gx = blstm_train._projection_kernel(x.to(dt), wx, bias)
                frame_loop_split("blstm_train",
                                 lambda: run(blstm_train.blstm_train),
                                 gx, wh, lengths, dy)

    # blstm_train_gx: the train CLI's encoder layer 0 (B=16, D=2560, H=512)
    gb, gh = 16, 512
    _, _, wh, _, lengths, dy = train_inputs(gen, gb, t_enc, 8, gh, f32, dev)
    gx = torch.randn((gb, t_enc, 2, 4 * gh), generator=gen, device=dev)

    def run_gx(fn):
        return with_grads(lambda g, w: fn(g, w, lengths), [gx, wh], dy)

    want = run_gx(blstm_train.blstm_train_gx_plain)
    out_tol, g_tol = grad_tols(f32)
    errs = []
    for route in ROUTES:
        with blstm_train._force_route(route):
            got = run_gx(blstm_train.blstm_train_gx)
        for name, g, w in zip(("y", "dgx", "dwh"), got, want):
            err, ok = compare(f"blstm_train_gx {route} {name} B={gb} "
                              f"T={t_enc} H={gh} {f32}", [g], [w],
                              **(out_tol if name == "y" else g_tol))
            ok_all &= ok
            errs.append(err)
    ms = route_ms(lambda: run_gx(blstm_train.blstm_train_gx), 5)
    # the layer as models/rnn.py runs it: input_projection from x at
    # D=2560, then blstm_train_gx, forward and every gradient, timed in
    # turns with cuDNN's LSTM on the same x (which also computes the
    # projection and its gradients)
    x = torch.randn((gb, t_enc, d_enc), generator=gen, device=dev)
    wx = torch.randn((2, d_enc, 4 * gh), generator=gen, device=dev) \
        / d_enc ** 0.5
    bias = torch.randn((2, 4 * gh), generator=gen, device=dev) * 0.3

    def layer():
        return with_grads(lambda x_, wx_, wh_, b_: blstm_train.blstm_train_gx(
            input_projection(x_, wx_, b_, f32), wh_, lengths),
            [x, wx, wh, bias], dy)

    layer_ms, lib_ms = [], []
    for fn in ("layer", "lib", "lib", "layer"):
        if fn == "layer":
            layer_ms.append(cuda_ms(layer, 5))
        else:
            lib_ms.append(lstm_library_ms(x, lengths, gh, train=True))
    print(f"    blstm_train_gx layer from x (D={d_enc}, input_projection "
          f"+ frame loops, fwd + grads), in turns with cuDNN: "
          f"{layer_ms[0]:.3f}, {layer_ms[1]:.3f} ms; cuDNN LSTM "
          f"{lib_ms[0]:.3f}, {lib_ms[1]:.3f} ms")
    # per valid frame: the recurrence, dh and dW_h; the library call takes
    # x (B, T, 2560) and computes the projection and its gradients too
    res["blstm_train_gx"] = entry(
        "blstm_train_gx", max(errs), ms["resident"],
        cuda_ms(lambda: run_gx(blstm_train.blstm_train_gx_plain), 1),
        int(lengths.sum()) * 3 * 16 * gh * gh,
        nbytes(gx, wh, lengths, dy, got), wh.dtype, mean(lib_ms))
    frame_loop_split("blstm_train_gx",
                     lambda: run_gx(blstm_train.blstm_train_gx),
                     gx, wh, lengths, dy)

    # ctc_nll: the whole CTC loss and its gradient at the train shapes
    s_len = TRAIN_SYNTH.max_tokens
    u = 2 * s_len + 1
    logits = 3 * torch.randn((b, t_enc, VOCAB), generator=gen, device=dev)
    labels = torch.randint(2, VOCAB, (b, s_len), generator=gen, device=dev)
    label_lengths = torch.randint(TRAIN_SYNTH.min_tokens, s_len + 1, (b,),
                                  generator=gen, device=dev)
    logit_lengths = torch.randint(t_enc - 12, t_enc + 1, (b,), generator=gen,
                                  device=dev)

    def run_ctc(impl, lg=logits):
        lg = lg.detach().requires_grad_()
        loss = ctc.ctc_loss(lg, logit_lengths, labels, label_lengths,
                            impl=impl, reduction="none")
        return [loss, torch.autograd.grad(loss.sum(), lg)[0]]

    for dt in (f32, bf16):
        got, want = run_ctc("auto", logits.to(dt)), run_ctc("scan",
                                                           logits.to(dt))
        err, ok = compare(f"ctc_nll loss+grad B={b} T={t_enc} S={s_len} "
                          f"V={VOCAB} {dt}", got, want,
                          **(dict(atol=1e-4) if dt == f32
                             else dict(scale_atol=2e-2)))
        ok_all &= ok
        if dt == f32:
            nll_err, nll_out = err, got

    def library_ctc():
        lg = logits.clone().requires_grad_()
        lp = torch.log_softmax(lg, -1).transpose(0, 1)
        loss = F.ctc_loss(lp, labels, logit_lengths, label_lengths,
                          reduction="none")
        return torch.autograd.grad(loss.sum(), lg)

    # both are host-bound at these shapes: timed in turns (kernel,
    # library, library, kernel), so one host's drift falls on both
    nll_ms, lib_ms = cuda_ms_in_turns([lambda: run_ctc("auto"), library_ctc],
                                      50)
    # log-softmax and its gradient (~8 per logit), the alpha and beta
    # recursions (~10 per (b, t, u) each way), U = 2S + 1
    res["ctc_nll"] = entry(
        "ctc_nll", nll_err, nll_ms, cuda_ms(lambda: run_ctc("scan"), 2),
        b * t_enc * (8 * VOCAB + 20 * u),
        nbytes(logits, labels, label_lengths, logit_lengths, nll_out),
        logits.dtype, lib_ms)
    print(f"    host time per call (loss + gradient): ctc_nll "
          f"{host_us(lambda: run_ctc('auto')):.1f} us, plain "
          f"{host_us(lambda: run_ctc('scan'), 5):.1f} us, F.ctc_loss "
          f"{host_us(library_ctc):.1f} us")
    ctc_split("ctc_nll", lambda: run_ctc("auto"))
    ctc_split("F.ctc_loss", library_ctc)

    # ctc_alpha alone: the recursion from the same inputs' emissions and
    # alpha0 to the final alpha, and its gradient for a random cotangent
    with torch.no_grad():
        emit, alpha0, skip, pos = ctc.ctc_alpha_inputs(logits, labels,
                                                       label_lengths)
    dfin = torch.randn((b, u), generator=gen, device=dev)

    def run_alpha(fn):
        return with_grads(lambda e, a0: fn(e, a0, skip, pos, logit_lengths),
                          [emit, alpha0], dfin)

    ctc.ctc_alpha.launches = 0
    got = run_alpha(ctc.ctc_alpha)
    alpha_launches = ctc.ctc_alpha.launches
    want = run_alpha(ctc.ctc_alpha_plain)
    reach = want[0] > ctc.NEG_THRESH  # unreachable positions hold ~-1e30
    err, ok = compare(f"ctc_alpha final alpha + grads B={b} T={t_enc} U={u}",
                      [got[0][reach]] + got[1:], [want[0][reach]] + want[1:],
                      atol=1e-4)
    ok_all &= ok
    # the alpha and beta recursions, ~10 per (b, t, u) each way
    res["ctc_alpha"] = entry(
        "ctc_alpha", err, cuda_ms(lambda: run_alpha(ctc.ctc_alpha), 20),
        cuda_ms(lambda: run_alpha(ctc.ctc_alpha_plain), 2),
        b * t_enc * 20 * u,
        nbytes(emit, alpha0, skip, pos, logit_lengths, dfin, got), emit.dtype)
    require(ok_all, "a training kernel disagrees with its plain version")
    return res, alpha_launches


def on_gemm_route(route, fn):
    """fn with every product of gemm.cu forced onto ``route``."""
    def run():
        with blstm_train._force_gemm_route(route):
            return fn()
    return run


def gemm_products(jcfg, t_enh, t_enc, dev) -> dict:
    """Phase 3: each product of csrc/gemm.cu at the flagship's enhancer
    layer 0 and encoder layer 0 (B=32, bfloat16) and the train CLI's
    float32 dW_h (B=16, T=72, H=512), through the wrappers the layer runs:
    the tensor-core kernel against the plain version (reruns bit-identical
    where K is split), timed in turns with the SIMT route, beside the plain
    version, torch.matmul on the same operands in the compute type
    (``library_ms``, timed, used nowhere) and the bound. The kernel line's
    ``gemm`` entry is the products of one row-6 call: enhancer layer 0,
    forward and every gradient (the projection twice, dx, dW_x, dW_h)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    enc = jcfg.e2e.encoder
    d_enc = subsampled_frames(enc.input_dim) * enc.vgg_channels[-1]
    layers = (("enhancer0", TRAIN_BATCH, t_enh, jcfg.enhancer.input_dim,
               jcfg.enhancer.hidden_dim, bf16, ("proj", "dx", "dwx", "dwh")),
              ("encoder0", TRAIN_BATCH, t_enc, d_enc, enc.hidden_dim, bf16,
               ("proj", "dx", "dwx", "dwh")),
              ("cli", 16, t_enc, 8, 512, f32, ("dwh",)))
    row6 = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, flops=0, moved=0)
    ok_all = True
    n_sm, smem = device_limits(torch.cuda.current_device())
    for tag, b, t, d, h, dt, prods in layers:
        xc = torch.randn((b, t, d), generator=gen, device=dev).to(dt)
        wx = (torch.randn((2, d, 4 * h), generator=gen, device=dev)
              / d ** 0.5).to(dt)
        bias = torch.randn((2, 4 * h), generator=gen, device=dev) * 0.3
        dg = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev) * 0.1
        y_ext = torch.randn((2, b, t + 1, h), generator=gen,
                            device=dev).to(dt)
        rnd = dt == bf16
        # torch.matmul's operands in the compute type, laid out outside the
        # timed call
        x2, dgc = xc.reshape(b * t, d), dg.to(dt).reshape(b * t, 8 * h)
        wx_t = wx.transpose(1, 2).reshape(8 * h, d)
        h_prev = torch.stack([y_ext[0, :, :t], y_ext[1, :, 1:]]).reshape(
            2, b * t, h).transpose(1, 2)
        dg_z = dgc.reshape(b * t, 2, 4 * h).transpose(0, 1).contiguous()
        out_bytes = 4 * 2 * 4 * h
        table = {  # (product, batch, M, N, K, bytes read and written, lib)
            "proj": (lambda p: blstm_train._projection_kernel(xc, wx, bias,
                                                              p),
                     2, b * t, 4 * h, d,
                     nbytes(xc, wx, bias) + b * t * out_bytes,
                     lambda: torch.matmul(x2, wx)),
            "dx": (lambda p: blstm_train._dx_kernel(dg, wx, rnd, p),
                   1, b * t, d, 8 * h, nbytes(dg, wx) + 4 * b * t * d,
                   lambda: torch.matmul(dgc, wx_t)),
            "dwx": (lambda p: blstm_train._dwx_kernel(xc, dg, rnd, p),
                    2, d, 4 * h, b * t, nbytes(xc, dg) + d * out_bytes,
                    lambda: torch.matmul(x2.t(), dgc)),
            "dwh": (lambda p: blstm_train._dwh_kernel(y_ext, dg, b, t, h, p),
                    2, h, 4 * h, b * t, nbytes(y_ext, dg) + h * out_bytes,
                    lambda: torch.matmul(h_prev, dg_z)),
        }
        for name in prods:
            run, batch, m, n, k, moved, lib = table[name]
            plan = blstm_train.gemm_plan(m, n, k, xc.element_size(), n_sm,
                                         smem, batch=batch)
            got = run(None)
            want = run(blstm_train.gemm_plain)
            err, ok = compare(f"gemm {tag} {name} batch={batch} M={m} N={n} "
                              f"K={k} {dt} ({plan.splits} k slices)", [got],
                              [want], scale_atol=1e-4)
            ok_all &= ok
            if plan.splits > 1:
                same = torch.equal(got, run(None))
                print(f"  gemm {tag} {name}: rerun "
                      f"{'bit-identical' if same else 'DIFFERS'}")
                ok_all &= same
            tc, simt = cuda_ms_in_turns(
                [lambda: run(None), on_gemm_route("simt", lambda: run(None))],
                5, ahead=True)
            plain = cuda_ms(lambda: run(blstm_train.gemm_plain), 3)
            lib_ms = cuda_ms(lib, 10, ahead=True)
            flops = 2 * batch * m * n * k
            rate = TF32X3_FLOPS if dt == f32 else PEAK_FLOPS[bf16]
            bound = max(flops / rate, moved / HBM_BYTES) * 1e3
            print(f"    gemm {tag} {name}: tensor-core {tc:.4f} ms "
                  f"({flops / tc / 1e9:.1f} TFLOP/s, {bound / tc:.1%} of the "
                  f"bound), SIMT {simt:.4f}, plain {plain:.4f}, torch.matmul "
                  f"{lib_ms:.4f}, bound {bound:.4f} ms"
                  f"{' (3 tf32 passes at 495 TFLOP/s)' if dt == f32 else ''}")
            if tag == "enhancer0":
                times = 2 if name == "proj" else 1  # again in the backward
                row6["err"] = max(row6["err"], err)
                row6["ms"] += times * tc
                row6["plain"] += times * plain
                row6["lib"] += times * lib_ms
                row6["flops"] += times * flops
                row6["moved"] += times * moved
    require(ok_all, "a product of gemm.cu disagrees with its plain version "
            "or with itself")
    print(f"    gemm per row-6 call (enhancer layer 0, the projection twice, "
          f"dx, dW_x, dW_h): {row6['ms']:.4f} ms")
    return {"gemm": entry("gemm", row6["err"], row6["ms"], row6["plain"],
                          row6["flops"], row6["moved"], bf16, row6["lib"])}


def on_route(route, fn):
    """fn with every BLSTM layer's frame loops forced onto ``route``."""
    def run():
        with blstm_train._force_route(route):
            return fn()
    return run


def route_ms(fn, reps: int) -> dict:
    """``cuda_ms`` of fn on each frame-loop route, in turns (resident,
    loop, loop, resident)."""
    ms = cuda_ms_in_turns([on_route(r, fn) for r in ROUTES], reps)
    print(f"    in turns: resident route {ms[0]:.3f} ms, row-tiled loops "
          f"{ms[1]:.3f} ms")
    return dict(zip(ROUTES, ms))


def is_frame_loop(key: str) -> bool:
    return ("fwd_resident" in key or "bwd_resident" in key
            or "::fwd_kernel<" in key or "::bwd_kernel<" in key)


def frame_loop_split(tag, fn, gx, wh, lengths, dy, reps: int = 5):
    """Per route: one torch.profiler window over ``reps`` calls of fn (a
    BLSTM layer forward and every gradient), its device time split into
    the frame loops, csrc/gemm.cu's products (gemm_tc_kernel; for
    blstm_train_gx only the dW_h product), its column sums and the rest;
    then the forward loop, the backward loop and the dW_h product
    (``_dwh_kernel``) alone with CUDA events."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    b, t = gx.shape[:2]
    h = wh.shape[1]
    for route in ROUTES:
        with blstm_train._force_route(route):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]

            def ms_of(pick):
                return sum(e.self_device_time_total for e in rows
                           if pick(e.key)) / 1e3 / reps

            loops = ms_of(is_frame_loop)
            gemm = ms_of(lambda k: any(g in k for g in GEMM_KERNELS[:2]))
            colsum = ms_of(lambda k: GEMM_KERNELS[2] in k)
            other = ms_of(lambda k: True) - loops - gemm - colsum
            with torch.no_grad():
                _, y_ext, c_ext = blstm_train._recurrence_fwd_kernel(
                    gx, wh, lengths)
                dg = blstm_train._recurrence_bwd_kernel(gx, wh, lengths,
                                                        y_ext, c_ext, dy)
                fwd = cuda_ms(lambda: blstm_train._recurrence_fwd_kernel(
                    gx, wh, lengths), reps)
                bwd = cuda_ms(lambda: blstm_train._recurrence_bwd_kernel(
                    gx, wh, lengths, y_ext, c_ext, dy), reps)
                dwh = cuda_ms(lambda: blstm_train._dwh_kernel(
                    y_ext, dg, b, t, h), reps)
        print(f"    {tag} {route} split per call ({reps} calls): frame "
              f"loops {loops:.4f} ms, gemm.cu products {gemm:.4f} ms, "
              f"column sums {colsum:.4f} ms, other {other:.4f} ms of device "
              f"time; alone: forward loop "
              f"{fwd:.4f}, backward loop {bwd:.4f}, _dwh_kernel {dwh:.4f} ms")


def cuda_ms_in_turns(fns, reps: int, ahead: bool = False):
    """``cuda_ms`` of each of ``fns``, taken twice in turns (A, B, B, A)
    and averaged."""
    times = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        times[i].append(cuda_ms(fns[i], reps, ahead))
    return [mean(t) for t in times]


def ctc_split(tag, fn, reps: int = 20):
    """One torch.profiler window over ``reps`` calls of a CTC loss and its
    gradient: the device time of the two ctc_nll kernels and of every
    other kernel, against the calls' wall time (profiled, and unprofiled on
    the host clock)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    ours = [e for e in rows
            if "nll_fwd_kernel" in e.key or "nll_bwd_kernel" in e.key]
    per_call = {("fwd" if "nll_fwd" in e.key else "bwd"):
                round(e.self_device_time_total / 1e3 / reps, 4) for e in ours}
    kern_ms = sum(per_call.values())
    other_ms = sum(e.self_device_time_total for e in rows) / 1e3 / reps \
        - kern_ms
    other_n = sum(e.count for e in rows if e not in ours) / reps
    print(f"    {tag} split per loss + gradient ({reps} calls): ctc_nll "
          f"kernels {kern_ms:.4f} ms of device time {per_call}, other kernels "
          f"{other_ms:.4f} ms in {other_n:.1f} launches; wall "
          f"{wall_ms:.4f} ms ({prof_ms:.4f} profiled)")


def lm_inputs(gen, n, v, e, h, layers, dev):
    """Token ids, LM weights at their initialisers' scales and a carry."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return (torch.randint(0, v, (n,), generator=gen, device=dev),
            rnd(v, e, scale=e ** -0.5),
            [rnd(e if i == 0 else h, 4 * h, scale=(e if i == 0 else h) ** -0.5)
             for i in range(layers)],
            [rnd(h, 4 * h, scale=h ** -0.5) for _ in range(layers)],
            [rnd(4 * h, scale=0.1) for _ in range(layers)],
            rnd(h, v, scale=h ** -0.5), rnd(v, scale=0.1),
            rnd(layers, n, h, scale=0.5), rnd(layers, n, h, scale=0.5))


def clean_kernel_parity(jcfg, dev):
    """Phase 3, the clean-speech kernels: the fused frontend at decode and
    train shapes and its backward at train shapes (float32 throughout, as
    the JAX kernel's HIGHEST-precision products), then the RNNLM step.
    Returns the kernels' entries and the backward's launches: no serving
    or training path runs the backward (no parameter lies upstream of the
    waveform), so its launches are this phase's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    fcfg = dataclasses.replace(jcfg.e2e.frontend, fused=True)
    l_, f_, m_ = fcfg.frame_length, fcfg.n_freqs, fcfg.n_mels
    bases = fbank_fused.device_bases(fcfg, dev)[:3]
    res, ok_all = {}, True

    for tag, b, synth in (("decode", BATCH, SYNTH),
                          ("train", TRAIN_BATCH, TRAIN_SYNTH)):
        data = make_batch(b, synth, np.random.default_rng(3))
        wav = torch.from_numpy(data["noisy_wav"]).to(dev)
        lens = torch.from_numpy(data["wav_lengths"]).to(dev)
        fns = {r: on_fbank_route(r, lambda: fbank_fused.fbank_fused(
            wav, fcfg, lens)) for r in FBANK_ROUTES}
        want = fbank_fused.fbank_fused_plain(wav, fcfg, lens)
        n_valid = fbank_fused.valid_frames(wav, fcfg, lens)
        frames = int(n_valid.sum())
        plan = fbank_fused.fbank_plan(fcfg, b, wav.shape[1],
                                      *device_limits(0), wav.data_ptr())
        print(f"  fbank_fused {tag}: tc plan {plan}")
        require(plan is not None, f"the tc route does not fit {tag} shapes")
        errs = {}
        for route, fn in fns.items():
            got = fn()
            # float32 DFT and mel sums in another order (route "tc": the
            # products in 3xTF32): ~1e-5 of O(1) features
            errs[route], ok = compare(
                f"fbank_fused {route} {tag} B={b} N={wav.shape[1]} "
                f"T={got[0].shape[1]} (valid frames {frames})", got, want,
                rtol=1e-4, atol=1e-4)
            ok_all &= ok
        same = torch.equal(fns["tc"]()[0], fns["tc"]()[0])
        print(f"    tc route rerun bit-identical: {same}")
        ok_all &= same
        # in turns (tc, simt, plain, plain, simt, tc), the host ahead (at
        # the train shape a call's host time reaches its device time)
        ms = cuda_ms_in_turns(
            [fns["tc"], fns["simt"],
             lambda: fbank_fused.fbank_fused_plain(wav, fcfg, lens)], 10,
            ahead=True)
        print(f"    in turns, host ahead: tc {ms[0]:.4f} ms, simt "
              f"{ms[1]:.4f} ms, plain {ms[2]:.4f} ms")
        # per valid frame: the windowed DFT (two bases, 2 * L * F each),
        # power, mel (2 * F * M), log and CMVN
        flops = frames * (4 * l_ * f_ + 3 * f_ + 2 * f_ * m_ + 6 * m_)
        # the products as route "tc" runs them: three tf32 passes over the
        # band it computes (plan.nbins bins), at the tensor cores' peak
        tc_ms = frames * 4 * l_ * plan.nbins / TF32X3_FLOPS * 1e3
        print(f"    3xTF32 bound of the DFT over {plan.nbins} bins: "
              f"{tc_ms:.4f} ms (three tf32 passes at 495 TFLOP/s)")
        if tag == "decode":
            res["fbank_fused"] = entry(
                "fbank_fused", errs["tc"], ms[0], ms[2], flops,
                nbytes(wav, lens, want, bases), wav.dtype)

    # the backward at the train shapes, for a fixed random cotangent, its
    # frame pass on both routes (the recompute on "tc"), each held to the
    # plain version; "tc" run twice
    g = torch.randn(got[0].shape, generator=gen, device=dev)
    bplan = fbank_fused.fbank_bwd_plan(fcfg, *wav.shape, *device_limits(0),
                                       wav.data_ptr())
    print(f"  fbank_fused_bwd train: frame-pass tc plan {bplan}")
    require(bplan is not None,
            "the backward's tc route does not fit the train shapes")
    bwds = {r: on_fbank_bwd_route(r, lambda: fbank_fused.fbank_fused_bwd(
        wav, n_valid, g, fcfg)) for r in FBANK_ROUTES}

    def bwd_plain():
        return fbank_fused.fbank_fused_bwd_plain(wav, n_valid, g, fcfg)

    fbank_fused.fbank_fused_bwd.launches = 0
    for route in FBANK_ROUTES:
        fbank_fused.FBANK_BWD_ROUTE_LAUNCHES[route] = 0
    want = bwd_plain()
    errs = {}
    for route, fn in bwds.items():
        dwav = fn()
        errs[route], ok = compare(
            f"fbank_fused_bwd {route} train B={wav.shape[0]} "
            f"N={wav.shape[1]} dwav", [dwav], [want], scale_atol=1e-4)
        ok_all &= ok
    same = torch.equal(bwds["tc"](), bwds["tc"]())
    print(f"    tc route rerun bit-identical: {same}")
    ok_all &= same
    routes = dict(fbank_fused.FBANK_BWD_ROUTE_LAUNCHES)
    print(f"    fbank_fused_bwd launches by frame-pass route {routes}")
    ok_all &= routes == {"tc": 3, "simt": 1}
    # in turns (tc, simt, plain, plain, simt, tc), the host ahead
    ms = cuda_ms_in_turns([bwds["tc"], bwds["simt"], bwd_plain], 10,
                          ahead=True)
    print(f"    in turns, host ahead: tc {ms[0]:.4f} ms, simt {ms[1]:.4f} "
          f"ms, plain {ms[2]:.4f} ms")
    # the products as route "tc" runs them: the recompute's DFT and the
    # transposed one, each 4 * L * nbins a valid frame over the band, in
    # three tf32 passes at the tensor cores' peak
    tc_ms = frames * 2 * 4 * l_ * bplan.nbins / TF32X3_FLOPS * 1e3
    print(f"    3xTF32 bound of its two DFTs over {bplan.nbins} bins: "
          f"{tc_ms:.4f} ms (three tf32 passes at 495 TFLOP/s)")
    # per valid frame: the forward again, CMVN, log and mel transposes
    # (2 * F * M), the power's chain rule, the transposed DFT (2 * 2 * L * F);
    # the overlap-add (2 per sample)
    res["fbank_fused_bwd"] = entry(
        "fbank_fused_bwd", errs["tc"], ms[0], ms[2],
        frames * (8 * l_ * f_ + 10 * f_ + 4 * f_ * m_ + 12 * m_)
        + 2 * wav.numel(), nbytes(wav, n_valid, g, dwav, bases), wav.dtype)
    bwd_launches = fbank_fused.FBANK_BWD_ROUTE_LAUNCHES["tc"]

    # the RNNLM step over the B*K = 1024 lanes of a beam step, on both
    # routes, each held to the plain version; "tile" run twice
    f32, bf16 = torch.float32, torch.bfloat16
    n = BATCH * BEAM
    for tag, layers, e, h, v, dt in (
            ("LMConfig() float32", 1, 128, 256, VOCAB, f32),
            ("LMConfig() bfloat16", 1, 128, 256, VOCAB, bf16),
            ("2 layers float32", 2, 128, 256, VOCAB, f32),
            ("train CLI E=H=512 float32", 1, 512, 512, 12, f32)):
        args = lm_inputs(gen, n, v, e, h, layers, dev)
        fns = {r: on_lm_route(r, lambda: lm_step.lm_step(*args, dtype=dt))
               for r in LM_ROUTES}
        want = lm_step.lm_step_plain(*args, dtype=dt)
        tol = (dict(rtol=1e-4, atol=1e-5) if dt == f32
               else dict(scale_atol=2e-2))
        shape = f"N={n} V={v} E={e} H={h} L={layers}"
        errs = {}
        for route, fn in fns.items():
            got = fn()
            errs[route], ok = compare(f"lm_step {route} {tag} {shape}", got,
                                      want, **tol)
            ok_all &= ok
        runs = [fns["tile"]() for _ in range(2)]
        same = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
        print(f"    tile route rerun bit-identical: {same}")
        ok_all &= same
        # in turns (tile, lane, plain, plain, lane, tile), the host ahead
        ms = cuda_ms_in_turns(
            [fns["tile"], fns["lane"],
             lambda: lm_step.lm_step_plain(*args, dtype=dt)], 50, ahead=True)
        print(f"    in turns, host ahead: tile {ms[0]:.4f} ms, lane "
              f"{ms[1]:.4f} ms, plain {ms[2]:.4f} ms; host time per call: "
              f"tile {host_us(fns['tile']):.1f} us, lane "
              f"{host_us(fns['lane']):.1f} us")
        if tag == "LMConfig() float32":
            # per lane: 2 * (E + L * H + (L - 1) * H) * 4H for the gates,
            # 2 * H * V for the readout, ~10 per unit for the cells
            flops = n * (2 * (e + (2 * layers - 1) * h) * 4 * h + 2 * h * v
                         + 10 * layers * h)
            moved = nbytes(args, want)
            for name, route, t in (("lm_step", "tile", ms[0]),
                                   ("lm_step_lane", "lane", ms[1])):
                res[name] = entry(name, errs[route], t, ms[2], flops, moved,
                                  f32)
    require(ok_all, "a clean-speech kernel disagrees with its plain version")
    return res, bwd_launches


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------


def with_impls(jcfg, lstm: str, score: str, dtype: str):
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg, compute_dtype=dtype,
        e2e=dataclasses.replace(
            e2e,
            encoder=dataclasses.replace(e2e.encoder, lstm_impl=lstm),
            attention=dataclasses.replace(e2e.attention, score_impl=score)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl=lstm),
    )


def load(jcfg, state, dev):
    model = build_model(jcfg)
    model.load_state_dict(state)
    return model.to(dev).eval()


def batch_tensors(b, seed, dev, wav="noisy_wav", synth=SYNTH):
    data = make_batch(b, synth, np.random.default_rng(seed))
    return (torch.from_numpy(data[wav]).to(dev),
            torch.from_numpy(data["wav_lengths"]).to(dev))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_result(res, b):
    require(res.scores.shape == (b,) and res.tokens.shape == (b, STEPS),
            f"result shapes {tuple(res.scores.shape)} "
            f"{tuple(res.tokens.shape)}")
    require(bool(torch.isfinite(res.scores).all()), "non-finite beam scores")
    require(bool(((res.lengths >= 0) & (res.lengths <= STEPS)).all()),
            "hypothesis lengths outside [0, max_steps]")


def split_ms(model, jcfg, bcfg, wav, lens, use_enhancer=True, lm=None):
    """(encode ms, search ms) of one batch, each ending in a synchronize."""
    lm_fns = (lm.step, lm.initial_carry) if lm is not None else (None, None)
    with torch.inference_mode():
        enc, enc_ms = timed(lambda: model.encode_for_decode(wav, lens,
                                                            use_enhancer))
        hs, hmask, hlens, ctc_logits, enc_proj = enc
        _, search_ms = timed(lambda: beam_search_from_encoder(
            model.decoder_step, model.decoder_initial_carry, hs, hmask, hlens,
            enc_proj, ctc_logits, jcfg.e2e, bcfg, *lm_fns))
    return enc_ms, search_ms


def mean(xs):
    return sum(xs) / len(xs)


def steady(batches, search, model, jcfg, bcfg, use_enhancer=True, lm=None):
    """Warm per-batch ms of the whole search, then of its two halves:
    (whole, encode, search) means over the batches."""
    whole = [timed(lambda: search(w, n))[1] for w, n in batches]
    halves = [split_ms(model, jcfg, bcfg, w, n, use_enhancer, lm)
              for w, n in batches]
    print(f"  warm ms per batch {['%.1f' % x for x in whole]}")
    return (mean(whole), mean([h[0] for h in halves]),
            mean([h[1] for h in halves]))


def main_path(b, n_batches, state, dev):
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    kcfg = with_impls(flagship_config(VOCAB), "auto", "auto", "bfloat16")
    model = load(kcfg, state, dev)
    searcher = make_beam_searcher(model, kcfg.e2e, bcfg, use_enhancer=True)
    batches = [batch_tensors(b, seed, dev) for seed in range(n_batches)]
    print(f"  batch: B={b} samples={batches[0][0].shape[1]} "
          f"mean length {batches[0][1].float().mean().item() / 16000:.2f} s")

    reset_counts()
    first = []
    for wav, lens in batches:
        res, ms = timed(lambda: searcher(wav, lens))
        check_result(res, b)
        first.append(ms)
    launches, plain_calls = counts(SERVING)
    print(f"  kernel path, first pass: ms per batch "
          f"{['%.1f' % x for x in first]} (the first includes warm-up)")
    print(f"  launches {launches}  plain calls {plain_calls}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on the main path: {plain_calls}")
    n_layers = kcfg.enhancer.num_layers + kcfg.e2e.encoder.num_layers
    routes = dict(blstm.INFER_ROUTE_LAUNCHES)
    print(f"  blstm_infer launches by route {routes}, gate-stream "
          f"{blstm.blstm_recurrence.launches}")
    require(routes == {"cluster": n_batches * n_layers, "row_tiled": 0}
            and blstm.blstm_recurrence.launches == 0,
            f"not every BLSTM layer took the cluster route: {routes} for "
            f"{n_batches} x {n_layers} layers, "
            f"{blstm.blstm_recurrence.launches} gate-stream launches")
    require_utt_attention("main path", n_batches * STEPS)
    require_utt_prefix("main path", n_batches * STEPS, n_batches * STEPS)
    before = dict(att.ATT_ROUTE_LAUNCHES)
    check_result(on_att_route("hyp", searcher)(*batches[0]), b)
    hyp = {r: att.ATT_ROUTE_LAUNCHES[r] - before[r] for r in ATT_ROUTES}
    print(f"  one batch with the attention forced to hyp: launches {hyp}")
    require(hyp == {"utt": 0, "hyp": STEPS},
            f"the forced hyp batch launched {hyp}")
    launches["att_loc_step_hyp"] = hyp["hyp"]
    before = prefix_routes()
    check_result(on_prefix_route("lane", searcher)(*batches[0]), b)
    lane = {n: {r: v - before[n][r] for r, v in routes.items()}
            for n, routes in prefix_routes().items()}
    print(f"  one batch with the CTC prefix forced to lane: launches {lane}")
    require(lane == {"psi": {"utt": 0, "lane": STEPS},
                     "state": {"utt": 0, "lane": STEPS}},
            f"the forced lane batch launched {lane}")
    launches["ctc_prefix_psi"] = lane["psi"]["lane"]
    launches["ctc_prefix_state"] = lane["state"]["lane"]

    k_ms, k_enc, k_search = steady(batches, searcher, model, kcfg, bcfg)
    print(f"  kernel path: {b * 1e3 / k_ms:.2f} utt/s, {k_ms:.1f} ms/batch "
          f"(encode {k_enc:.1f} ms + search {k_search:.1f} ms when timed "
          f"apart; means over {n_batches} warm batches)")
    rt_enc = mean([on_infer_route("row_tiled", split_ms)(
        model, kcfg, bcfg, w, n)[0] for w, n in batches])
    print(f"  encode ms per batch: cluster route {k_enc:.1f}, row-tiled "
          f"route {rt_enc:.1f}")
    in_turns({"cluster BLSTM": searcher,
              "row-tiled BLSTM": on_infer_route("row_tiled", searcher),
              "gate-stream BLSTM": gate_stream(searcher),
              "hyp attention": on_att_route("hyp", searcher),
              "lane CTC prefix": on_prefix_route("lane", searcher)},
             batches, b)
    # launches a beam step and the CTC prefix rows of one profiled search,
    # with the searcher's work around the state call folded into the "utt"
    # kernels and without (the "lane" route)
    for route in PREFIX_ROUTES:
        on_prefix_route(route, search_profile)(model, kcfg, bcfg,
                                               *batches[0],
                                               f"{route} CTC prefix")

    pcfg = with_impls(kcfg, "scan", "xla", "bfloat16")
    plain_model = load(pcfg, state, dev)
    pbcfg = dataclasses.replace(bcfg, prefix_impl="twopass")
    plain_search = make_beam_searcher(plain_model, pcfg.e2e, pbcfg)
    check_result(plain_search(*batches[0]), b)  # warm-up
    p_ms, p_enc, p_search = steady(batches, plain_search, plain_model, pcfg,
                                   pbcfg)
    print(f"  plain path: {b * 1e3 / p_ms:.2f} utt/s, {p_ms:.1f} ms/batch "
          f"(encode {p_enc:.1f} ms + search {p_search:.1f} ms)")
    return launches, k_ms


def search_profile(model, jcfg, bcfg, wav, lens, tag, pick=PREFIX_KERNELS):
    """One warm search from the encoder's outputs under the profiler: its
    device rows of the kernels whose names hold one of ``pick`` (the CTC
    prefix kernels) and its launches a beam step."""
    with torch.inference_mode():
        hs, hmask, hlens, ctc_logits, enc_proj = model.encode_for_decode(
            wav, lens, True)

        def run():
            return beam_search_from_encoder(
                model.decoder_step, model.decoder_initial_carry, hs, hmask,
                hlens, enc_proj, ctc_logits, jcfg.e2e, bcfg)

        run()
        print(f"  {tag}, one profiled search:")
        busy_ms, n_launch, _ = device_profile(run, 0, pick=pick)
    print(f"    search: {n_launch} launches, {n_launch / STEPS:.1f} a beam "
          f"step over {STEPS} steps; device kernels {busy_ms:.1f} ms")


def gate_stream(search):
    """``search`` with every BLSTM layer on the gate-stream route (the
    cuBLAS projection, then ``csrc/blstm.cu``): the fit rule answers "gx"
    while it runs."""
    def run(wav, lens):
        rule = rnn.infer_kernel_for
        rnn.infer_kernel_for = lambda *args: "gx"
        try:
            return search(wav, lens)
        finally:
            rnn.infer_kernel_for = rule
    return run


def slice_parity(state, dev):
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    base = flagship_config(VOCAB)
    wav, lens = batch_tensors(16, 100, dev)
    out = {}
    for tag, lstm_impl, score, prefix in (("kernel", "auto", "auto", "auto"),
                                          ("plain", "scan", "xla", "twopass")):
        cfg = with_impls(base, lstm_impl, score, "float32")
        model = load(cfg, state, dev)
        search = make_beam_searcher(
            model, cfg.e2e, dataclasses.replace(bcfg, prefix_impl=prefix))
        reset_counts()
        # float32 at B=16 defaults to the hyp route (utt_preferred): the
        # slice holds the utt route
        out[tag] = on_att_route("utt", search)(wav, lens)
        check_result(out[tag], 16)
        if tag == "kernel":
            require_utt_attention("the f32 slice", STEPS)
            require_utt_prefix("the f32 slice", STEPS, STEPS)
    k, p = out["kernel"], out["plain"]
    rel = ((k.scores - p.scores).abs() / p.scores.abs().clamp_min(1e-6)).max()
    same = sum(bool(torch.equal(a, c)) for a, c in zip(k.tokens, p.tokens))
    print(f"  float32 B=16: best-score max rel diff {rel.item():.3e} "
          f"(limit 1e-3); best hypotheses token-identical {same}/16")
    require(rel.item() <= 1e-3, "kernel and plain paths disagree on scores")


# ---------------------------------------------------------------------------
# phases 6-8: training
# ---------------------------------------------------------------------------


def train_cfg(lstm: str, ctc_impl: str, dtype: str, jcfg=None):
    jcfg = jcfg or flagship_config(VOCAB)
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg, compute_dtype=dtype,
        e2e=dataclasses.replace(
            e2e, ctc_impl=ctc_impl,
            encoder=dataclasses.replace(e2e.encoder, lstm_impl=lstm)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl=lstm))


def train_state(jcfg, state_g, state_d, dev):
    model = build_model(jcfg)
    model.load_state_dict(state_g)
    disc = Discriminator(jcfg.discriminator, model.dtype)
    disc.load_state_dict(state_d)
    return train_steps.init_train_state(model.to(dev), disc.to(dev),
                                        TrainConfig(), seed=0)


def train_batch(b, seed, dev):
    data = make_batch(b, TRAIN_SYNTH, np.random.default_rng(seed))
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def check_metrics(metrics):
    bad = {k: float(v) for k, v in metrics.items()
           if not bool(torch.isfinite(v))}
    require(not bad, f"non-finite train metrics {bad}")


def device_profile(fn, top: int, pick=(), rows_out=None):
    """Run fn once under torch.profiler; print its ``top`` device rows by
    kernel, and the others whose name holds one of ``pick``, and return
    (device ms summed over kernels, launches, profiled wall ms); with
    ``rows_out``, append every row's (name, device ms, launches) to it.
    One stream, so the kernels' sum is the device's busy time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    if rows_out is not None:
        rows_out.extend((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in rows)
    for i, e in enumerate(rows):
        if i < top or any(p in e.key for p in pick):
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows), wall_ms)


def profile_step(step, state, batch):
    """Device time by kernel over one warm step, the device's busy share of
    the step's wall time, and csrc/gemm.cu's rows: (ms, launches) by
    kernel of GEMM_KERNELS."""
    rows = []
    busy_ms, launches, wall_ms = device_profile(lambda: step(state, batch),
                                                15, pick=GEMM_KERNELS,
                                                rows_out=rows)
    print(f"  profile of one warm step: wall {wall_ms:.1f} ms (profiled), "
          f"device kernels {busy_ms:.1f} ms, busy share "
          f"{busy_ms / wall_ms:.3f}, {launches} launches")
    gemm = {g: (sum(ms for key, ms, _ in rows if g in key),
                sum(n for key, _, n in rows if g in key))
            for g in GEMM_KERNELS}
    (tc_ms, tc_n), (_, simt_n), (cs_ms, cs_n) = gemm.values()
    print(f"  gemm.cu rows of the step: products {tc_ms:.2f} ms in {tc_n} "
          f"launches, column sums {cs_ms:.2f} ms in {cs_n}; SIMT launches "
          f"{simt_n}")
    return gemm


def train_path(state_g, state_d, dev):
    """Phase 6: the flagship joint step in bfloat16, kernel then plain."""
    batch = train_batch(TRAIN_BATCH, 0, dev)
    print(f"  batch: B={TRAIN_BATCH} samples={batch['noisy_wav'].shape[1]} "
          f"tokens {TRAIN_SYNTH.min_tokens}-{TRAIN_SYNTH.max_tokens}")
    result = {}
    for tag, lstm, ctc_impl in (("kernel", "auto", "auto"),
                                ("plain", "scan", "scan")):
        jcfg = train_cfg(lstm, ctc_impl, "bfloat16")
        state = train_state(jcfg, state_g, state_d, dev)
        step = train_steps.make_joint_train_step(jcfg)
        reset_counts()
        check_metrics(timed(lambda: step(state, batch))[0])  # warm-up
        times = []
        for _ in range(TRAIN_STEPS):
            metrics, ms = timed(lambda: step(state, batch))
            check_metrics(metrics)
            times.append(ms)
        mean_ms = mean(times)
        print(f"  {tag} path: ms per step {['%.1f' % x for x in times]}; "
              f"{mean_ms:.1f} ms/step, {TRAIN_BATCH * 1e3 / mean_ms:.2f} "
              f"utt/s (warm mean over {TRAIN_STEPS})")
        print("  metrics " + " ".join(f"{k}={float(v):.4g}"
                                      for k, v in metrics.items()))
        if tag == "kernel":
            launches, plain_calls = counts(TRAINING)
            print(f"  launches {launches}  plain calls {plain_calls}")
            require(all(v > 0 for v in launches.values()),
                    f"a kernel of the train path never launched: {launches}")
            require(launches["ctc_nll"] == 2 * (TRAIN_STEPS + 1),
                    f"ctc_nll launched {launches['ctc_nll']} times in "
                    f"{TRAIN_STEPS + 1} steps, not 2 per G-step loss")
            train_plain = {n: plain_calls[n] for n in
                           TRAINING + ("blstm_train_gx", "ctc_alpha")}
            require(not any(train_plain.values()),
                    f"a plain version ran on the train path: {train_plain}")
            require_resident("phase 6")
            routes = dict(blstm.INFER_ROUTE_LAUNCHES)
            print(f"  blstm_infer launches by route {routes}")
            require(routes["cluster"] > 0 and routes["row_tiled"] == 0,
                    f"phase 6: the D-step's BLSTM layers did not all take "
                    f"the cluster route: {routes}")
            gemm_routes = dict(blstm_train.GEMM_ROUTE_LAUNCHES)
            print(f"  gemm launches by route {gemm_routes}")
            require(gemm_routes["simt"] == 0
                    and gemm_routes["tc"] == launches["gemm"] > 0,
                    f"phase 6: not every product took the tensor-core "
                    f"kernel: {gemm_routes}")
            result = launches
            rows = profile_step(step, state, batch)
            require(rows["gemm_tc_kernel"][1] > 0
                    and rows["gemm_simt_kernel"][1] == 0,
                    f"phase 6: the profiled step's gemm.cu rows {rows}")
    return result


def cli_path(ckpt):
    """Phase 7: the train CLI at its default model, 3 steps and a resume,
    into the experiment dir ``ckpt`` (phase 12 decodes it)."""
    argv = ["--mode", "joint", "--synthetic", "--ckpt-dir", ckpt,
            "--synthetic-utts", "16", "--batch-size", "16",
            "--log-every", "1"]
    reset_counts()
    t0 = time.perf_counter()
    train_cli.main(argv + ["--epochs", "3"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    train_cli.main(argv + ["--epochs", "4"])
    torch.cuda.synchronize()
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        latest = json.load(f)["latest"]
    launches, plain_calls = counts(("blstm_train", "blstm_train_gx",
                                    "ctc_nll"))
    print(f"  3 steps + dev evals in {first_s:.1f} s; resumed to step "
          f"{latest['step']}; launches {launches}")
    require(latest["step"] == 4, f"resume ended at step {latest['step']}")
    require(all(v > 0 for v in launches.values()),
            f"a training kernel never launched from the CLI: {launches}")
    require(not any(plain_calls[n] for n in launches),
            f"a plain version ran from the CLI: {plain_calls}")
    require_resident("phase 7")
    return launches


def train_slice_parity(state_g, state_d, dev):
    """Phase 8: one float32 joint step, kernel path against plain path."""
    batch = train_batch(16, 100, dev)
    out = {}
    for tag, lstm, ctc_impl in (("kernel", "auto", "auto"),
                                ("plain", "scan", "scan")):
        jcfg = train_cfg(lstm, ctc_impl, "float32")
        state = train_state(jcfg, state_g, state_d, dev)
        out[tag] = train_steps.make_joint_train_step(jcfg)(state, batch)
        check_metrics(out[tag])
    k, p = out["kernel"], out["plain"]
    ok = True
    for key, limit in (("loss_g", 1e-4), ("loss_d", 1e-4),
                       ("loss_ctc", 1e-4), ("loss_att", 1e-4),
                       ("grad_norm_g", 1e-3)):
        rel = abs(float(k[key]) - float(p[key])) / max(abs(float(p[key])),
                                                        1e-12)
        ok &= rel <= limit
        print(f"  {key}: kernel {float(k[key]):.6g} plain {float(p[key]):.6g}"
              f" rel {rel:.2e} (limit {limit:g})")
    require(ok, "kernel and plain train steps disagree")


# ---------------------------------------------------------------------------
# phases 9-11: clean-speech serving with RNNLM fusion, and its recipe
# ---------------------------------------------------------------------------


def clean_cfg(lstm: str, score: str, dtype: str):
    """The flagship with the fused frontend (used where no enhancer sits
    between STFT and mel)."""
    cfg = with_impls(flagship_config(VOCAB), lstm, score, dtype)
    return dataclasses.replace(cfg, e2e=dataclasses.replace(
        cfg.e2e, frontend=dataclasses.replace(cfg.e2e.frontend, fused=True)))


def make_lm(step_impl: str, dev):
    """An RNNLM at the LMConfig defaults (V=52, E=128, H=256, one layer),
    float32, weights from seed 2."""
    lmcfg = LMConfig(vocab_size=VOCAB, step_impl=step_impl)
    lm = RNNLM(lmcfg)
    lm.load_state_dict(from_flax(init_lm_params(lmcfg, seed=2)))
    return lm.to(dev).eval()


@contextlib.contextmanager
def plain_frontend():
    """The pipeline's fused frontend through its plain version. The JAX
    package selects the fused frontend by ``FrontendConfig.fused`` alone,
    with no impl field of its own, so the plain paths swap it here."""
    kernel = pipeline.fbank_fused
    pipeline.fbank_fused = fbank_fused.fbank_fused_plain
    try:
        yield
    finally:
        pipeline.fbank_fused = kernel


def clean_path(b, n_batches, state, dev):
    """Phase 9: no enhancer, fused frontend, LM fusion; kernel then plain."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False, lm_weight=LM_WEIGHT)
    kcfg = clean_cfg("auto", "auto", "bfloat16")
    model, lm = load(kcfg, state, dev), make_lm("auto", dev)
    searcher = make_beam_searcher(model, kcfg.e2e, bcfg, use_enhancer=False,
                                  lm=lm)
    batches = [batch_tensors(b, seed, dev, "clean_wav")
               for seed in range(n_batches)]
    print(f"  batch: B={b} clean samples={batches[0][0].shape[1]} "
          f"mean length {batches[0][1].float().mean().item() / 16000:.2f} s;"
          f" LM V={VOCAB} E=128 H=256 L=1 float32, lm_weight {LM_WEIGHT}")

    reset_counts()
    first = []
    for wav, lens in batches:
        res, ms = timed(lambda: searcher(wav, lens))
        check_result(res, b)
        first.append(ms)
    launches, plain_calls = counts(CLEAN_SERVING)
    print(f"  kernel path, first pass: ms per batch "
          f"{['%.1f' % x for x in first]} (the first includes warm-up)")
    print(f"  launches {launches}  plain calls {plain_calls}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the clean path never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on the clean path: {plain_calls}")
    require(launches["lm_step"] == n_batches * STEPS,
            f"LM steps {launches['lm_step']} != {n_batches} x {STEPS}")
    require_lm_route("clean path", "tile", n_batches * STEPS)
    require_utt_attention("clean path", n_batches * STEPS)
    require_tc_frontend("clean path", n_batches)
    before = dict(lm_step.LM_ROUTE_LAUNCHES)
    check_result(on_lm_route("lane", searcher)(*batches[0]), b)
    lane = {r: lm_step.LM_ROUTE_LAUNCHES[r] - before[r] for r in LM_ROUTES}
    print(f"  one batch with the LM forced to lane: launches {lane}")
    require(lane == {"tile": 0, "lane": STEPS},
            f"the forced lane batch launched {lane}")
    launches["lm_step_lane"] = lane["lane"]

    k_ms, k_enc, k_search = steady(batches, searcher, model, kcfg, bcfg,
                                   False, lm)
    print(f"  kernel path: {b * 1e3 / k_ms:.2f} utt/s, {k_ms:.1f} ms/batch "
          f"(encode {k_enc:.1f} ms + search {k_search:.1f} ms when timed "
          f"apart; means over {n_batches} warm batches)")
    # device time by kernel over one warm batch on each LM route, with the
    # LM step's row, and the device's busy share of that batch's
    # unprofiled wall time
    wav, lens = batches[0]
    for route in LM_ROUTES:
        search = on_lm_route(route, searcher)
        _, wall_ms = timed(lambda: search(wav, lens))
        print(f"  LM on route {route}, one profiled warm batch:")
        busy_ms, launches_p, _ = device_profile(
            lambda: search(wav, lens), 12, pick=LM_KERNELS + FRONTEND_KERNELS)
        print(f"  profile of one warm batch: device kernels {busy_ms:.1f} ms "
              f"of an unprofiled {wall_ms:.1f} ms batch (busy share "
              f"{busy_ms / wall_ms:.3f}), {launches_p} launches")

    pcfg = clean_cfg("scan", "xla", "bfloat16")
    plain_model, plain_lm = load(pcfg, state, dev), make_lm("xla", dev)
    pbcfg = dataclasses.replace(bcfg, prefix_impl="twopass")
    plain_search = make_beam_searcher(plain_model, pcfg.e2e, pbcfg,
                                      use_enhancer=False, lm=plain_lm)
    with plain_frontend():
        check_result(plain_search(*batches[0]), b)  # warm-up
        p_ms, p_enc, p_search = steady(batches, plain_search, plain_model,
                                       pcfg, pbcfg, False, plain_lm)
    print(f"  plain path: {b * 1e3 / p_ms:.2f} utt/s, {p_ms:.1f} ms/batch "
          f"(encode {p_enc:.1f} ms + search {p_search:.1f} ms)")
    require(k_ms < p_ms, "the kernel path is not faster than the plain path")
    return launches


def clean_slice_parity(state, dev):
    """Phase 10: one float32 batch of 16, kernel path against plain path."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False, lm_weight=LM_WEIGHT)
    wav, lens = batch_tensors(16, 100, dev, "clean_wav")
    out = {}
    for tag, lstm_impl, score, prefix, lm_impl in (
            ("kernel", "auto", "auto", "auto", "auto"),
            ("plain", "scan", "xla", "twopass", "xla")):
        cfg = clean_cfg(lstm_impl, score, "float32")
        search = make_beam_searcher(
            load(cfg, state, dev), cfg.e2e,
            dataclasses.replace(bcfg, prefix_impl=prefix),
            use_enhancer=False, lm=make_lm(lm_impl, dev))
        reset_counts()
        if tag == "kernel":
            out[tag] = on_att_route("utt", search)(wav, lens)
            launches, _ = counts(F32_CLEAN_SERVING)
            require(all(v > 0 for v in launches.values()),
                    f"a kernel never launched in the f32 slice: {launches}")
            require_utt_attention("the f32 clean slice", STEPS)
            require_utt_prefix("the f32 clean slice", STEPS, STEPS)
            require_lm_route("the f32 clean slice", "tile", STEPS)
        else:
            with plain_frontend():
                out[tag] = search(wav, lens)
        check_result(out[tag], 16)
    k, p = out["kernel"], out["plain"]
    rel = ((k.scores - p.scores).abs() / p.scores.abs().clamp_min(1e-6)).max()
    same = sum(bool(torch.equal(a, c)) for a, c in zip(k.tokens, p.tokens))
    print(f"  float32 B=16: best-score max rel diff {rel.item():.3e} "
          f"(limit 1e-3); best hypotheses token-identical {same}/16")
    require(rel.item() <= 1e-3, "kernel and plain clean paths disagree")


def clean_recipe(dev):
    """Phase 11: train the clean ASR through the fused frontend and the LM
    through the CLI, restore both and decode with LM fusion."""
    argv = ["--synthetic", "--synthetic-utts", "16", "--batch-size", "16",
            "--log-every", "1"]
    with tempfile.TemporaryDirectory() as root:
        asr_dir, lm_dir = os.path.join(root, "asr"), os.path.join(root, "lm")
        reset_counts()
        t0 = time.perf_counter()
        train_cli.main(["--mode", "asr", "--fused-frontend", "--ckpt-dir",
                        asr_dir, "--epochs", "3"] + argv)
        torch.cuda.synchronize()
        asr_s = time.perf_counter() - t0
        asr_kernels = ("fbank_fused", "blstm_train", "blstm_train_gx",
                       "ctc_nll")
        asr_launches, plain_calls = counts(asr_kernels)
        print(f"  --mode asr --fused-frontend: 3 steps + dev evals in "
              f"{asr_s:.1f} s; launches {asr_launches}")
        # 3 training steps and 3 one-batch dev evals, all through the kernel
        require(asr_launches["fbank_fused"] == 6,
                f"fused frontend launches {asr_launches['fbank_fused']} != 6")
        require_tc_frontend("--mode asr --fused-frontend", 6)
        require(all(v > 0 for v in asr_launches.values()),
                f"a kernel never launched in --mode asr: {asr_launches}")
        # (the teacher-forced decoder's attention is plain PyTorch, as the
        # JAX package's is XLA: its beam-step kernel serves decoding only)
        require(not any(plain_calls[n] for n in asr_kernels),
                f"a plain version ran in --mode asr: {plain_calls}")

        t0 = time.perf_counter()
        train_cli.main(["--mode", "lm", "--ckpt-dir", lm_dir,
                        "--epochs", "3"] + argv)
        train_cli.main(["--mode", "lm", "--ckpt-dir", lm_dir,
                        "--epochs", "4"] + argv)
        torch.cuda.synchronize()
        lm_s = time.perf_counter() - t0
        with open(os.path.join(lm_dir, "checkpoints.json")) as f:
            lm_latest = json.load(f)["latest"]
        print(f"  --mode lm: 3 steps and a resume in {lm_s:.1f} s; resumed to "
              f"step {lm_latest['step']}")
        require(lm_latest["step"] == 4, f"LM resume at {lm_latest['step']}")

        with open(os.path.join(asr_dir, "config.json")) as f:
            jcfg = config_lib.from_dict(JointConfig, json.load(f)["joint"])
        model = build_model(jcfg).to(dev)
        disc = Discriminator(jcfg.discriminator, model.dtype).to(dev)
        state = train_steps.init_train_state(model, disc, TrainConfig())
        _, step = ckpt_lib.restore_checkpoint(asr_dir, state, "latest")
        lm = load_lm(lm_dir)
        require(step == 3, f"ASR restored at step {step}")

    vocab = jcfg.e2e.decoder.vocab_size
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False, lm_weight=LM_WEIGHT)
    wav, lens = batch_tensors(16, 7, dev, "clean_wav",
                              SyntheticConfig())
    reset_counts()
    res = make_beam_searcher(model.eval(), jcfg.e2e, bcfg, use_enhancer=False,
                             lm=lm)(wav, lens)
    torch.cuda.synchronize()
    check_result(res, 16)
    require(bool(((res.tokens >= -1) & (res.tokens < vocab)).all()),
            "decoded tokens outside the vocabulary")
    # float32 at B=16: the attention takes the hyp route (utt_preferred)
    launches, plain_calls = counts(CLEAN_SERVING + ("att_loc_step_hyp",))
    print(f"  restored ASR (step {step}) + LM (step {lm_latest['step']}) "
          f"decoded B=16, V={vocab}: launches {launches}")
    require(launches["fbank_fused"] > 0 and launches["lm_step"] > 0,
            f"the restored decode skipped a kernel: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran in the restored decode: {plain_calls}")


# ---------------------------------------------------------------------------
# phases 12-14: the decode CLI, the fused-step A/B, the per-utterance prefix
# ---------------------------------------------------------------------------


def write_manifest(work, n, synth, seed):
    """A jsonl manifest of ``n`` noisy .npy utterances of ``synth``'s task
    from ``seed``, and its tokenizer: characters for ids 3.., so each text
    encodes back to its token ids (token 2 is written as an unknown
    character, which encodes to <unk> = 2)."""
    chars = [chr(ord("a") + i) for i in range(synth.vocab_size - 3)]
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        tokens = sample_transcript(synth, rng)
        _, noisy = synth_utterance(tokens, synth, rng)
        path = os.path.join(work, f"u{i:03d}.npy")
        np.save(path, noisy)
        entries.append({"utt_id": f"u{i:03d}", "noisy": path,
                        "n_samples": len(noisy),
                        "text": "".join("?" if t == 2 else chars[t - 3]
                                        for t in tokens)})
    manifest = os.path.join(work, "manifest.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(json.dumps(e) for e in entries) + "\n")
    return manifest, CharTokenizer(chars)


def best_scores(out_dir):
    """utt id -> the best hypothesis' score, from ``--nbest 1``."""
    with open(os.path.join(out_dir, "nbest.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["utt_id"]: r["nbest"][0]["score"] for r in rows}


def decode_cli_path(ckpt, work):
    """Phase 12: ``decode.cli`` on phase 7's experiment (the CLI's default
    model, float32) over 128 utterances of its task in one batch:
    ``--serving-impls fused``, then ``xla`` on the same inputs."""
    synth = SyntheticConfig()  # the train CLI's task
    manifest, tok = write_manifest(work, BATCH, synth, seed=12)
    tok.save(os.path.join(ckpt, "tokenizer.json"))
    argv = ["--manifest", manifest, "--ckpt-dir", ckpt, "--batch-size",
            str(BATCH), "--beam-size", str(BEAM), "--max-steps", str(STEPS),
            "--no-early-exit", "--nbest", "1"]
    out, secs, runs = {}, {}, {}
    for impls in ("fused", "xla"):
        out[impls] = os.path.join(work, f"decode_{impls}")
        reset_counts()
        t0 = time.perf_counter()
        decode_cli.main(argv + ["--serving-impls", impls, "--out",
                                out[impls]])
        torch.cuda.synchronize()
        secs[impls] = time.perf_counter() - t0
        runs[impls] = counts(KERNELS)
        print(f"  --serving-impls {impls}: {secs[impls]:.2f} s wall "
              f"(restore, one batch of {BATCH}, scoring)")
    launches, plain_calls = runs["fused"]
    path = {n: launches[n] for n in CLI_SERVING}
    print(f"  fused launches {path}  plain calls {plain_calls}")
    print(f"  fused step launches by route: utt {path['att_dec_step']}, hyp "
          f"{launches['att_dec_step_hyp']}")
    require(path["att_dec_step"] == STEPS
            and launches["att_dec_step_hyp"] == 0,
            f"att_dec_step launched {path['att_dec_step']} times on route "
            f"utt and {launches['att_dec_step_hyp']} on hyp, not {STEPS} "
            f"on utt")
    require(all(v > 0 for v in path.values()),
            f"a kernel of the fused path never launched: {path}")
    require(launches["att_loc_step"] == 0,
            "the fused step ran beside the attention kernel")
    require(not any(plain_calls.values()),
            f"a plain version ran with --serving-impls fused: {plain_calls}")
    require(not any(runs["xla"][0].values()),
            f"a kernel launched with --serving-impls xla: {runs['xla'][0]}")
    got, want = best_scores(out["fused"]), best_scores(out["xla"])
    require(sorted(got) == sorted(want) and len(got) == BATCH,
            "the two runs decoded different utterances")
    rel = max(abs(got[u] - want[u]) / max(abs(want[u]), 1e-6) for u in got)
    with open(os.path.join(out["fused"], "hyp.txt")) as f:
        hyp_f = f.read().splitlines()
    with open(os.path.join(out["xla"], "hyp.txt")) as f:
        hyp_x = f.read().splitlines()
    same = sum(a == c for a, c in zip(hyp_f, hyp_x))
    print(f"  best-score max rel diff fused vs xla {rel:.3e} (limit 1e-3); "
          f"hyp.txt lines identical {same}/{len(hyp_x)}")
    require(rel <= 1e-3, "--serving-impls fused and xla disagree on scores")
    return path


def with_step_impl(jcfg, step_impl):
    return dataclasses.replace(jcfg, e2e=dataclasses.replace(
        jcfg.e2e, decoder=dataclasses.replace(jcfg.e2e.decoder,
                                              step_impl=step_impl)))


def fused_step_ab(b, n_batches, state, dev, phase4_ms):
    """Phase 13: phase 4's traffic with the fused decoder step (every launch
    on route "utt"), against the unfused step and the fused step on route
    "hyp" in turns (A, B, C, C, B, A), one profiled warm batch of each
    with its decoder-step rows, and one profiled search of each: its
    launches a beam step."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    base = with_impls(flagship_config(VOCAB), "auto", "auto", "bfloat16")
    searchers, models = {}, {}
    for tag, step_impl in (("unfused step", "auto"), ("fused step", "fused")):
        cfg = with_step_impl(base, step_impl)
        models[tag] = (load(cfg, state, dev), cfg)
        searchers[tag] = make_beam_searcher(models[tag][0], cfg.e2e, bcfg)
    batches = [batch_tensors(b, seed, dev) for seed in range(n_batches)]
    reset_counts()
    for wav, lens in batches:
        check_result(searchers["fused step"](wav, lens), b)
    launches, plain_calls = counts(FUSED_SERVING)
    print(f"  fused step, first pass: launches {launches}")
    require(launches["att_dec_step"] == n_batches * STEPS,
            f"att_dec_step launched {launches['att_dec_step']} times")
    require_utt_dec("phase 13", n_batches * STEPS)
    require(KERNELS["att_loc_step"]["wrapper"].launches == 0,
            "the fused step ran beside the attention kernel")
    require(not any(plain_calls.values()),
            f"a plain version ran with the fused step: {plain_calls}")
    before = dict(att_dec.DEC_ROUTE_LAUNCHES)
    check_result(on_dec_route("hyp", searchers["fused step"])(*batches[0]),
                 b)
    hyp = {r: att_dec.DEC_ROUTE_LAUNCHES[r] - before[r] for r in DEC_ROUTES}
    print(f"  one batch with the fused step forced to hyp: launches {hyp}")
    require(hyp == {"utt": 0, "hyp": STEPS},
            f"the forced hyp batch launched {hyp}")
    launches["att_dec_step_hyp"] = hyp["hyp"]
    searchers["fused step, hyp route"] = on_dec_route(
        "hyp", searchers["fused step"])
    # the decoder-step rows: the fused step's two kernels, the unfused
    # step's attention
    step_rows = ("att_dec_utt_kernel", "att_dec_kernel", "att_utt_kernel")
    in_turns(searchers, batches, b, pick=step_rows)
    print(f"  (phase 4's kernel path: {b * 1e3 / phase4_ms:.2f} utt/s, "
          f"{phase4_ms:.1f} ms/batch)")
    for tag, route in (("unfused step", "utt"), ("fused step", "utt"),
                       ("fused step", "hyp")):
        model, cfg = models[tag]
        on_dec_route(route, search_profile)(
            model, cfg, bcfg, *batches[0],
            tag if tag == "unfused step" else f"{tag}, {route} route",
            step_rows)
    return launches


def in_turns(searchers, batches, b, pick=()):
    """Warm ms per batch of the searchers timed in turns (A, B, B, A, or
    A, B, C, C, B, A, over the batches), and one profiled warm batch of
    each: its device time, busy share and launches, and its device rows of
    the kernels whose names hold one of ``pick``."""
    tags = list(searchers)
    ms = {tag: [] for tag in tags}
    for tag in tags + tags[::-1]:
        ms[tag] += [timed(lambda: searchers[tag](w, n))[1]
                    for w, n in batches]
    for tag in tags:
        mean_ms = mean(ms[tag])
        wav, lens = batches[0]
        _, wall_ms = timed(lambda: searchers[tag](wav, lens))
        busy_ms, n_launch, _ = device_profile(
            lambda: searchers[tag](wav, lens), 8, pick=pick)
        print(f"  {tag}: {b * 1e3 / mean_ms:.2f} utt/s, "
              f"{mean_ms:.1f} ms/batch (mean of {len(ms[tag])} warm "
              f"batches, in turns); profiled batch: device kernels "
              f"{busy_ms:.1f} ms of an unprofiled {wall_ms:.1f} ms (busy "
              f"share {busy_ms / wall_ms:.3f}), {n_launch} launches")


def utt_prefix_path(b, n_batches, state, dev):
    """Phase 14: phase 4's traffic with ``prefix_impl="pallas"``, against
    the tiled prefix kernels in turns, then an f32 B=16 parity against
    them."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False, prefix_impl="pallas")
    kcfg = with_impls(flagship_config(VOCAB), "auto", "auto", "bfloat16")
    model = load(kcfg, state, dev)
    searchers = {
        f"{p} prefix": make_beam_searcher(
            model, kcfg.e2e, dataclasses.replace(bcfg, prefix_impl=p))
        for p in ("tiled", "pallas")}
    batches = [batch_tensors(b, seed, dev) for seed in range(n_batches)]
    reset_counts()
    for wav, lens in batches:
        check_result(searchers["pallas prefix"](wav, lens), b)
    launches, plain_calls = counts(UTT_SERVING)
    print(f"  launches {launches}  plain calls {plain_calls}")
    require(launches["ctc_prefix_utt"] == n_batches * STEPS,
            f"ctc_prefix_utt launched {launches['ctc_prefix_utt']} times")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the per-utterance path never launched: {launches}")
    require(KERNELS["ctc_prefix_psi"]["wrapper"].launches == 0,
            "the tiled psi wrapper ran on the per-utterance path")
    require_utt_attention("per-utterance prefix path", n_batches * STEPS)
    require_utt_prefix("per-utterance prefix path", 0, n_batches * STEPS)
    require(not any(plain_calls.values()),
            f"a plain version ran on the per-utterance path: {plain_calls}")
    in_turns(searchers, batches, b)

    wav, lens = batch_tensors(16, 100, dev)
    cfg = with_impls(flagship_config(VOCAB), "auto", "auto", "float32")
    model = load(cfg, state, dev)
    reset_counts()
    out = {p: make_beam_searcher(model, cfg.e2e, dataclasses.replace(
        bcfg, prefix_impl=p))(wav, lens) for p in ("pallas", "tiled")}
    require_utt_prefix("the f32 pallas and tiled slices", STEPS, 2 * STEPS)
    u, t = out["pallas"], out["tiled"]
    check_result(u, 16)
    rel = ((u.scores - t.scores).abs() / t.scores.abs().clamp_min(1e-6)).max()
    same = sum(bool(torch.equal(a, c)) for a, c in zip(u.tokens, t.tokens))
    print(f"  float32 B=16 pallas vs tiled: best-score max rel diff "
          f"{rel.item():.3e} (limit 1e-3); token-identical {same}/16")
    require(rel.item() <= 1e-3, "the per-utterance and tiled paths disagree")
    return launches


def wide_config(dtype: str):
    """The flagship with its encoder widened to hidden = proj = 1,024 in
    three BLSTMP layers (the ESPnet CHiME-4 recipe's VGG-BLSTMP encoder:
    elayers 3, eunits 1024, eprojs 1024; the JAX ``EncoderConfig``'s
    default depth), kernel impls, in ``dtype`` compute."""
    base = flagship_config(VOCAB)
    wide = dataclasses.replace(base, e2e=dataclasses.replace(
        base.e2e, encoder=dataclasses.replace(
            base.e2e.encoder, num_layers=3, hidden_dim=WIDE, proj_dim=WIDE)))
    return with_impls(wide, "auto", "auto", dtype)


def wide_encoder_path(b, n_batches, dev):
    """Phase 15: phase 4's traffic (B utterances ~7 s, beam 8, 48 steps, no
    early exit, the enhancer on) through ``make_beam_searcher`` over
    ``RobustE2E.encode_for_decode`` with the wide encoder in float32
    (random weights, seed 3): every encoder layer's ``blstm_recurrence``
    on the grid route (3 a batch), no plain version; one batch with the
    recurrence forced onto the row-tiled route (its launches are that
    kernel's); both timed in turns with a profiled batch of each (its
    BLSTM rows); then the B=16 slice parity, kernel path against plain
    path. Returns the launches of both routes."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    kcfg = wide_config("float32")
    state = from_flax(init_params(kcfg, seed=3))
    model = load(kcfg, state, dev)
    searcher = make_beam_searcher(model, kcfg.e2e, bcfg, use_enhancer=True)
    batches = [batch_tensors(b, seed, dev) for seed in range(n_batches)]
    layers = kcfg.e2e.encoder.num_layers
    names = ("blstm_recurrence", "blstm_recurrence_row_tiled",
             "blstm_infer_row_tiled")
    reset_counts()
    first = []
    for wav, lens in batches:
        res, ms = timed(lambda: searcher(wav, lens))
        check_result(res, b)
        first.append(ms)
    launches, plain_calls = counts(names)
    print(f"  first pass: ms per batch {['%.1f' % x for x in first]}; "
          f"launches {launches}")
    require(launches == {"blstm_recurrence": n_batches * layers,
                         "blstm_recurrence_row_tiled": 0,
                         "blstm_infer_row_tiled": n_batches
                         * kcfg.enhancer.num_layers},
            f"the wide encoder's layers did not all take the grid route: "
            f"{launches}, expected {n_batches * layers}")
    require(not any(plain_calls.values()),
            f"a plain version ran on the wide path: {plain_calls}")
    before = dict(blstm.GX_ROUTE_LAUNCHES)
    check_result(on_gx_route("row_tiled", searcher)(*batches[0]), b)
    forced = {r: blstm.GX_ROUTE_LAUNCHES[r] - before[r] for r in GX_ROUTES}
    print(f"  one batch with the recurrence forced to row_tiled: {forced}")
    require(forced == {"grid": 0, "row_tiled": layers},
            f"the forced row-tiled batch launched {forced}")
    launches["blstm_recurrence_row_tiled"] = forced["row_tiled"]
    k_ms, k_enc, k_search = steady(batches, searcher, model, kcfg, bcfg)
    print(f"  grid route: {b * 1e3 / k_ms:.2f} utt/s, {k_ms:.1f} ms/batch "
          f"(encode {k_enc:.1f} ms + search {k_search:.1f} ms)")
    in_turns({"grid recurrence": searcher,
              "row-tiled recurrence": on_gx_route("row_tiled", searcher)},
             batches, b, pick=BLSTM_KERNELS)

    wav, lens = batch_tensors(16, 100, dev)
    out = {}
    for tag, cfg, prefix in (("kernel", kcfg, "auto"),
                             ("plain", with_impls(kcfg, "scan", "xla",
                                                  "float32"), "twopass")):
        m = load(cfg, state, dev)
        reset_counts()
        out[tag] = make_beam_searcher(m, cfg.e2e, dataclasses.replace(
            bcfg, prefix_impl=prefix))(wav, lens)
        check_result(out[tag], 16)
        if tag == "kernel":
            n = counts(names)[0]
            require(n["blstm_recurrence"] == layers,
                    f"the B=16 slice's encoder launched {n}")
    k, p = out["kernel"], out["plain"]
    rel = ((k.scores - p.scores).abs() / p.scores.abs().clamp_min(1e-6)).max()
    same = sum(bool(torch.equal(x, y)) for x, y in zip(k.tokens, p.tokens))
    print(f"  float32 B=16 slice: best-score max rel diff {rel.item():.3e} "
          f"(limit 1e-3); best hypotheses token-identical {same}/16")
    require(rel.item() <= 1e-3, "the wide kernel and plain paths disagree")
    return launches


# ---------------------------------------------------------------------------
# phases 16-17: the verify drive, and the corpus recipe through its entry
# points
# ---------------------------------------------------------------------------

# the verify drive's training steps
DRIVE_STEPS = 500
# what each of the drive's sections must launch and must not (its
# float32 model's inference BLSTM layers take the row-tiled route, its
# bfloat16 ones the cluster route; float32 at B=16 takes the attention's
# per-hypothesis route, bfloat16 the per-utterance one), and whether the
# teacher-forced decoder's attention (plain PyTorch, as the JAX package's
# is XLA) runs in it: every other plain version is refused
TRAIN_SECTION = (("blstm_train", "gemm", "ctc_nll", "blstm_infer_row_tiled"),
                 (), True)
DRIVE_SECTIONS = {
    "train": TRAIN_SECTION,
    "decode": (("blstm_infer", "blstm_infer_row_tiled", "att_loc_step",
                "att_loc_step_hyp", "ctc_prefix_psi_utt",
                "ctc_prefix_state_utt"),
               ("ctc_prefix_psi", "ctc_prefix_state"), False),
    "routes": (("blstm_infer", "blstm_infer_row_tiled", "att_loc_step",
                "att_dec_step", "ctc_prefix_utt", "ctc_prefix_psi_utt",
                "ctc_prefix_state_utt"),
               ("att_loc_step_hyp", "att_dec_step_hyp", "ctc_prefix_psi",
                "ctc_prefix_state"), False),
    "probes": (("blstm_infer_row_tiled", "ctc_nll"), (), True),
    "loop": TRAIN_SECTION,
}
# the teacher-forced attention's plain version, shared by the two routes'
# entries
ATTENTION = ("att_loc_step", "att_loc_step_hyp")
# phase 17's transcripts: token t is ALPHABET[t - 2]
ALPHABET = "abcdefghij"


def require_launches(where, launched, plain_calls, ran, not_ran,
                     attention=False):
    """Every kernel of ``ran`` launched and none of ``not_ran``; no plain
    version ran but, with ``attention``, the teacher-forced attention's."""
    print(f"  {where}: launches {launched}")
    require(all(launched[n] > 0 for n in ran),
            f"{where}: a kernel never launched: "
            f"{ {n: launched[n] for n in ran} }")
    require(not any(launched[n] for n in not_ran),
            f"{where}: a route that should not run launched: "
            f"{ {n: launched[n] for n in not_ran} }")
    plain = {n: c for n, c in plain_calls.items()
             if c and not (attention and n in ATTENTION)}
    require(not plain, f"{where}: a plain version ran: {plain}")


def section_watch(where, sections, seconds, resident=("train", "loop")):
    """A ``watch(name)`` for a tool's ``main``: the counts set to 0 as a
    section starts, its seconds into ``seconds`` and its launches checked
    against ``sections[name]`` (ran, not ran, attention) as it ends; the
    sections of ``resident`` also on the resident frame loops."""

    @contextlib.contextmanager
    def watch(name):
        reset_counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launched, plain_calls = counts(KERNELS)
        ran, not_ran, attention = sections[name]
        require_launches(f"{where} section {name!r}",
                         {n: v for n, v in launched.items() if v
                          or n in ran + not_ran},
                         plain_calls, ran, not_ran, attention)
        if name in resident:
            require_resident(f"{where}, {name}")

    return watch


def drive_phase(dev) -> dict:
    """Phase 16: ``tools/verify_drive.py::main`` on the card, each of its
    sections' launches checked (``DRIVE_SECTIONS``)."""
    seconds = {}
    watch = section_watch("drive", DRIVE_SECTIONS, seconds)
    out = verify_drive.main(DRIVE_STEPS, dev, watch=watch)
    print(f"  drive: {out['ms_per_step']:.2f} ms/step over {DRIVE_STEPS} "
          "steps (host clock, ending in torch.cuda.synchronize())")
    for h in out["history"]:
        print(f"  step {h['step']}: acc {h['acc']:.4f} loss_ctc "
              f"{h['loss_ctc']:.4f} loss_att {h['loss_att']:.4f} loss_d "
              f"{h['loss_d']:.4f}")
    w = out["wer"]
    print(f"  WER greedy {w['greedy']:.4f}, beam {w['beam']:.4f}, bf16 beam "
          f"{w['beam_bf16']:.4f} (16 utterances)")
    for name, r in out["routes"].items():
        if "not_run" in r:
            print(f"  bf16 {name}: not run: {r['not_run']}")
            continue
        print(f"  bf16 {name}: WER {r['wer']:.4f}, token-identical "
              f"{r['identical']}/{r['n']} ({r['identical'] / r['n']:.4f})")
    print("  seconds by section "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


def write_corpus(root, n, seed):
    """A jsonl manifest of ``n`` noisy and clean .npy utterances of the
    default synthetic task from ``seed`` with ``ALPHABET`` text, and a
    Kaldi text file of its references; (manifest, text, entries)."""
    synth = SyntheticConfig()
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        tokens = sample_transcript(synth, rng)
        clean, noisy = synth_utterance(tokens, synth, rng)
        np.save(os.path.join(root, f"n{i:02d}.npy"), noisy)
        np.save(os.path.join(root, f"c{i:02d}.npy"), clean)
        entries.append({"utt_id": f"u{i:02d}", "noisy": f"n{i:02d}.npy",
                        "clean": f"c{i:02d}.npy", "n_samples": len(clean),
                        "text": "".join(ALPHABET[t - 2] for t in tokens)})
    manifest = os.path.join(root, "manifest.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(json.dumps(e) for e in entries) + "\n")
    text = os.path.join(root, "text")
    with open(text, "w") as f:
        f.writelines(f"{e['utt_id']} {e['text']}\n" for e in entries)
    return manifest, text, entries


def latest_step(ckpt):
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        return json.load(f)["latest"]["step"]


def corpus_recipe(work):
    """Phase 17: the corpus recipe through its entry points at
    ``train.cli``'s default model (float32, 512 wide): train on a manifest
    and resume, train the LM on its transcripts, enhance it to ark/scp in
    both domains, decode it with the LM fused, and score the hypotheses
    with ``score_cli``."""
    root = os.path.join(work, "corpus")
    os.makedirs(root)
    n_utts = 32
    manifest, text, entries = write_corpus(root, n_utts, seed=17)
    exp, lm_dir = os.path.join(root, "exp"), os.path.join(root, "lm")
    seconds = {}

    argv = ["--mode", "joint", "--train-manifest", manifest,
            "--dev-manifest", manifest, "--batch-size", "16",
            "--ckpt-dir", exp, "--log-every", "1"]
    reset_counts()
    t0 = time.perf_counter()
    train_cli.main(argv + ["--epochs", "1"])
    first = latest_step(exp)
    train_cli.main(argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    seconds["train"] = time.perf_counter() - t0
    second = latest_step(exp)
    print(f"  train.cli --train-manifest: epoch 1 ended at step {first}, "
          f"the resume at {second}")
    require(first == n_utts // 16 and second == 2 * first,
            f"manifest training steps {first} then {second}")
    require(os.path.exists(os.path.join(exp, "tokenizer.json")),
            "train.cli wrote no tokenizer.json")
    launched, plain_calls = counts(KERNELS)
    require_launches("train.cli", launched, plain_calls,
                     ("blstm_train", "blstm_train_gx", "gemm", "ctc_nll",
                      "blstm_infer_row_tiled"), (), attention=True)
    require_resident("phase 17")

    t0 = time.perf_counter()
    train_cli.main(["--mode", "lm", "--train-manifest", manifest,
                    "--batch-size", "16", "--epochs", "2", "--ckpt-dir",
                    lm_dir])
    seconds["lm"] = time.perf_counter() - t0
    require(latest_step(lm_dir) == 2 * n_utts // 16,
            f"the LM trained {latest_step(lm_dir)} steps")
    with open(os.path.join(exp, "tokenizer.json")) as a, \
            open(os.path.join(lm_dir, "tokenizer.json")) as b:
        require(a.read() == b.read(), "the LM's tokenizer differs")

    n_mels = FrontendConfig().n_mels
    for domain, dim in (("logmel", n_mels),
                        ("power", FrontendConfig().n_freqs)):
        out = os.path.join(root, f"enhanced_{domain}")
        reset_counts()
        t0 = time.perf_counter()
        enhance_cli.main(["--manifest", manifest, "--ckpt-dir", exp,
                          "--out", out, "--domain", domain])
        torch.cuda.synchronize()
        seconds[f"enhance {domain}"] = time.perf_counter() - t0
        launched, plain_calls = counts(KERNELS)
        require_launches(f"enhance_cli --domain {domain}", launched,
                         plain_calls, ("blstm_infer_row_tiled",), ())
        mats = dict(kaldi_io.read_mat_scp(out + ".scp"))
        frames = {e["utt_id"]: num_frames(e["n_samples"], FrontendConfig())
                  for e in entries}
        got = {k: m.shape for k, m in mats.items()}
        print(f"  --domain {domain}: {len(mats)} matrices, frames "
              f"{min(s[0] for s in got.values())}-"
              f"{max(s[0] for s in got.values())}, dim {dim}")
        require(got == {k: (f, dim) for k, f in frames.items()},
                f"enhance_cli --domain {domain} wrote shapes {got}")
        require(all(np.isfinite(m).all() for m in mats.values()),
                f"enhance_cli --domain {domain} wrote non-finite values")

    dec = os.path.join(root, "decode")
    reset_counts()
    t0 = time.perf_counter()
    decode_cli.main(["--manifest", manifest, "--ckpt-dir", exp,
                     "--lm-dir", lm_dir, "--lm-weight", str(LM_WEIGHT),
                     "--out", dec])
    torch.cuda.synchronize()
    seconds["decode"] = time.perf_counter() - t0
    launched, plain_calls = counts(KERNELS)
    require_launches("decode.cli --lm-dir", launched, plain_calls,
                     ("blstm_infer_row_tiled", "att_loc_step_hyp",
                      "ctc_prefix_psi_utt", "ctc_prefix_state_utt",
                      "lm_step"), ("ctc_prefix_psi", "ctc_prefix_state"))
    with open(os.path.join(dec, "wer.json")) as f:
        wer = json.load(f)
    report_path = os.path.join(root, "score.json")
    score_cli.main(["--ref", text, "--hyp", os.path.join(dec, "hyp.txt"),
                    "--bootstrap", "200", "--out", report_path])
    with open(report_path) as f:
        report = json.load(f)
    for kind in ("wer", "cer"):
        rate, r = wer[kind]["error_rate"], report[kind]
        print(f"  {kind}: decode.cli {rate!r}, score_cli {r['error_rate']!r}"
              f" 95% CI [{r['ci_low']!r}, {r['ci_high']!r}]")
        require(r["error_rate"] == rate,
                f"score_cli's {kind} {r['error_rate']} != decode.cli's {rate}")
        require(r["ci_low"] <= rate <= r["ci_high"],
                f"the {kind} CI does not bracket {rate}: {r}")
    require(report["n_utts"] == n_utts and not report["n_missing_hyp"],
            f"score_cli scored {report['n_utts']} utterances")
    print("  seconds by step "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))


# ---------------------------------------------------------------------------
# phase 18: the paper-claim protocols at a smoke budget
# ---------------------------------------------------------------------------

# tools/adversarial_benefit.py::main's smoke budget (20 steps train
# nothing: the orderings are gated by the full runs, not here)
BENEFIT_SMOKE = dict(steps_a=20, steps_c=20, with_lm=True, eval_utts=16,
                     route_batches=2, lm_steps=20)
LM_BENEFIT_SMOKE = dict(asr_steps=20, lm_steps=20)
# the float32 training sections of the toy models: the frame loops on the
# resident route and gemm.cu's products; the CTC loss where the ASR
# trains, the D-step's inference BLSTM (float32: row-tiled) where the
# enhancer does; only the teacher-forced attention's plain version
ASR_SECTION = (("blstm_train", "gemm", "ctc_nll"), ("blstm_infer",), True)
BENEFIT_SECTIONS = {
    "asr": ASR_SECTION,
    "gan": (("blstm_train", "gemm", "blstm_infer_row_tiled"),
            ("ctc_nll", "blstm_infer"), False),
    "joint": TRAIN_SECTION,
    "lm": ((), (), False),  # the LM trains on its plain cells
    # the bfloat16 route gates, as phase 16's
    "routes": DRIVE_SECTIONS["routes"],
}
# the summaries' keys: the JAX scripts' and the tools' own
BENEFIT_KEYS = (
    "task", "scale", "model_params_m", "noisy_wer_no_enhancement",
    "noisy_wer_cascade_enhancement", "noisy_wer_joint_adversarial",
    "token_error_rates", "relative_improvement", "steps", "recipe",
    "eval_set", "snr_range_db", "reverb_t60", "babble_streams",
    "channel_tilt", "noisy_wer_joint_plus_lm", "lm_ppl", "wer_ci95",
    "ms_per_step", "synthesis_seconds", "routes", "card")
LM_BENEFIT_KEYS = ("task", "asr_steps", "lm_steps", "results",
                   "wer_improvement_vs_no_lm", "ms_per_step",
                   "synthesis_seconds", "card")


def decode_section(b: int, lm: bool = False):
    """What a float32 beam decode of B utterances must launch and must
    not: the encoder's BLSTM on the row-tiled route, the attention on the
    route ``att.utt_preferred`` picks, the CTC prefix on route "utt", with
    ``lm`` the LM step on route "tile"; no plain version."""
    n_sm, _ = device_limits(0)
    att_routes = ["att_loc_step_hyp", "att_loc_step"]
    if att.utt_preferred(b, 4, n_sm):
        att_routes.reverse()
    ran = ("blstm_infer_row_tiled", att_routes[0], "ctc_prefix_psi_utt",
           "ctc_prefix_state_utt") + (("lm_step",) if lm else ())
    not_ran = ("blstm_infer", "blstm_recurrence",
               "blstm_recurrence_row_tiled", att_routes[1], "att_dec_step",
               "att_dec_step_hyp", "ctc_prefix_psi", "ctc_prefix_state",
               "ctc_prefix_utt", "lm_step_lane") + (() if lm else ("lm_step",))
    return ran, not_ran, False


def benefit_phase(dev) -> None:
    """Phase 18: ``tools/adversarial_benefit.py::main`` and
    ``tools/lm_benefit.py::main`` on the card at ``BENEFIT_SMOKE`` and
    ``LM_BENEFIT_SMOKE``, each section's launches checked; every error
    rate finite and every summary key present."""
    seconds = {}
    b = BENEFIT_SMOKE["eval_utts"]
    sections = dict(BENEFIT_SECTIONS,
                    no_enhancement=decode_section(b),
                    cascade=decode_section(b),
                    joint_decode=decode_section(b),
                    lm_decode=decode_section(b, lm=True))
    out = adversarial_benefit.main(
        device=dev, check_claim=False,
        watch=section_watch("adversarial_benefit", sections, seconds,
                            ("asr", "gan", "joint")), **BENEFIT_SMOKE)
    missing = [k for k in BENEFIT_KEYS if k not in out]
    require(not missing, f"adversarial_benefit summary lacks {missing}")
    rates = adversarial_benefit.finite_wers(out)
    require(all(np.isfinite(rates)), f"adversarial_benefit rates {rates}")
    print(f"  adversarial_benefit word WER: no enhancement "
          f"{out['noisy_wer_no_enhancement']}, cascade "
          f"{out['noisy_wer_cascade_enhancement']}, joint "
          f"{out['noisy_wer_joint_adversarial']}, joint + LM "
          f"{out['noisy_wer_joint_plus_lm']}; ms/step {out['ms_per_step']}; "
          f"synthesis {out['synthesis_seconds']:.1f} s")
    lm_seconds = {}
    lm_sections = {"asr": ASR_SECTION, "lm": BENEFIT_SECTIONS["lm"],
                   "decode": decode_section(lm_benefit.EVAL_UTTS, lm=True)}
    lm_out = lm_benefit.main(
        device=dev, check_claim=False,
        watch=section_watch("lm_benefit", lm_sections, lm_seconds, ("asr",)),
        **LM_BENEFIT_SMOKE)
    missing = [k for k in LM_BENEFIT_KEYS if k not in lm_out]
    require(not missing, f"lm_benefit summary lacks {missing}")
    require(all(np.isfinite(v) for r in lm_out["results"].values()
                for v in r.values()), f"lm_benefit rates {lm_out}")
    print(f"  lm_benefit: {lm_out['results']}; ms/step "
          f"{lm_out['ms_per_step']}")
    print("  seconds by section: adversarial_benefit "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + "; lm_benefit "
          + ", ".join(f"{k} {v:.1f}" for k, v in lm_seconds.items()))


# ---------------------------------------------------------------------------
# phase 19: the Kaldi and precomputed-feature inputs
# ---------------------------------------------------------------------------

# the kernels of a float32 decode, whichever route each takes (float32 B=16
# leaves the BLSTM to the row-tiled kernel and the attention to "hyp")
F32_ROUTED = {"blstm": ("blstm_infer", "blstm_infer_row_tiled"),
              "attention": ("att_loc_step", "att_loc_step_hyp")}


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip() != "",
            f"nvidia-smi failed: {smi.stdout}")
    return smi.stdout.strip().splitlines()[0]


def kaldi_features(wav, lens, cfg, kind):
    """``data/featbin_cli.py``'s extraction on a batch: (B, T, D) log-mel
    (``kind`` "fbank") or log power spectra ("spectrogram") without CMVN,
    pad frames zeroed as a Kaldi batch reads, and each row's frames."""
    with torch.no_grad():
        feats, mask = featbin_cli.frontend(wav, lens, cfg, kind)
    return feats * mask[..., None], mask.sum(dim=-1).to(torch.int32)


def launched_now() -> dict:
    """The kernels launched since the last reset, by name."""
    launched, _ = counts(KERNELS)
    return {n: v for n, v in launched.items() if v}


def f32_search(model, cfg, bcfg, kind, use_enhancer, x, n, cmvn_batch=None):
    """(encoder outputs, result, launches) of one float32 search of 16
    utterances on the kernel path: each BLSTM layer launched once, every
    attention, CTC psi and state step on a kernel, no plain version."""
    search = make_beam_searcher(model, cfg.e2e, bcfg,
                                use_enhancer=use_enhancer, input_kind=kind,
                                log_domain=True)
    with torch.inference_mode():
        enc = search.encode(x, n, cmvn_batch)
    reset_counts()
    res = search(x, n, cmvn_batch)
    check_result(res, x.shape[0])
    launched = launched_now()
    _, plain_calls = counts(KERNELS)
    layers = cfg.e2e.encoder.num_layers + (
        cfg.enhancer.num_layers if use_enhancer else 0)
    got = {k: sum(launched.get(n, 0) for n in names)
           for k, names in F32_ROUTED.items()}
    require(got == {"blstm": layers, "attention": STEPS}
            and launched.get("ctc_prefix_psi_utt") == STEPS
            and launched.get("ctc_prefix_state_utt") == STEPS,
            f"{kind}: launches {launched}, not {layers} BLSTM layers and "
            f"{STEPS} of each beam-step kernel")
    require(not any(plain_calls.values()),
            f"{kind}: a plain version ran: {plain_calls}")
    return enc, res, launched


def floor_rows(spec, lens, log_floor):
    """Frames at the log floor in each row's valid frames."""
    valid = torch.arange(spec.shape[1], device=spec.device)[None] < lens[:, None]
    at = (spec <= np.log(log_floor) + 1e-6) & valid[..., None]
    return at.sum(dim=(1, 2)).tolist()


def kaldi_parity(state, dev):
    """Phase 19, step 1: the flagship in float32 (TF32 off) on 16
    utterances of phase 4's traffic: precomputed log-mel against the
    waveform without the enhancer, log spectra against the waveform with
    it; then the speaker branch against the global one."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    cfg = with_impls(flagship_config(VOCAB), "auto", "auto", "float32")
    fe = cfg.e2e.frontend
    model = load(cfg, state, dev)
    wav, lens = batch_tensors(16, 100, dev)
    mel, flens = kaldi_features(wav, lens, fe, "fbank")
    spec, slens = kaldi_features(wav, lens, fe, "spectrogram")
    require(torch.equal(flens, slens), "mel and spectra frame counts differ")
    runs = {}
    for tag, kind, use_enh, x, n in (
            ("wav, no enhancer", "wav", False, wav, lens),
            ("log-mel feats", "feats", False, mel, flens),
            ("wav, enhancer", "wav", True, wav, lens),
            ("log spectra", "spec", True, spec, slens)):
        runs[tag] = f32_search(model, cfg, bcfg, kind, use_enh, x, n)
        print(f"  {tag}: launches {runs[tag][2]}")
    for got, want in (("log-mel feats", "wav, no enhancer"),
                      ("log spectra", "wav, enhancer")):
        (hs_g, _, hl_g, ctc_g, _), res_g, _ = runs[got]
        (hs_w, _, hl_w, ctc_w, _), res_w, _ = runs[want]
        err = (ctc_g - ctc_w).abs().max().item()
        same = [bool(torch.equal(a, b)) for a, b in zip(res_g.tokens,
                                                        res_w.tokens)]
        print(f"  {got} vs {want}: hlens equal {torch.equal(hl_g, hl_w)}, "
              f"CTC logits max abs diff {err:.3e}, best hypotheses "
              f"token-identical {sum(same)}/16")
        if not all(same) and got == "log spectra":
            rows = [i for i, s in enumerate(same) if not s]
            floors = floor_rows(spec, slens, fe.log_floor)
            print(f"  rows that differ {rows}, their values at the log floor "
                  f"{[floors[i] for i in rows]} (all rows {floors})")
        require(torch.equal(hl_g, hl_w), f"{got}: hlens differ")
        require(torch.allclose(ctc_g, ctc_w, rtol=1e-4, atol=1e-4),
                f"{got}: CTC logits differ by {err:.3e}")
        require(all(same), f"{got}: tokens differ from {want}")

    # one speaker holding the global stats of these 16 utterances
    acc = cmvn.CmvnAccumulator(fe.n_mels)
    for row, n in zip(mel.cpu().numpy(), flens.tolist()):
        acc.add(row[:n])
    ids = [f"u{i}" for i in range(16)]
    speakers = cmvn.SpeakerCmvn({"spk": acc.stats()},
                                {u: "spk" for u in ids})
    cmvn_batch = tuple(torch.from_numpy(a).to(dev)
                       for a in speakers.lookup(ids))
    out = {}
    for mode in ("global", "speaker"):
        mcfg = dataclasses.replace(cfg, e2e=dataclasses.replace(
            cfg.e2e, frontend=dataclasses.replace(fe, cmvn=mode)))
        m = build_model(mcfg, cmvn_stats=acc.mean_inv_std()
                        if mode == "global" else None)
        m.load_state_dict(state)
        out[mode] = f32_search(m.to(dev).eval(), mcfg, bcfg, "feats", False,
                               mel, flens,
                               cmvn_batch if mode == "speaker" else None)
    (enc_g, res_g, _), (enc_s, res_s, _) = out["global"], out["speaker"]
    equal = (all(torch.equal(a, b) for a, b in zip(enc_g, enc_s))
             and torch.equal(res_g.tokens, res_s.tokens)
             and torch.equal(res_g.scores, res_s.scores))
    print(f"  speaker CMVN (one speaker, the global stats) vs global CMVN: "
          f"encoder outputs, tokens and scores equal {equal}")
    require(equal, "the speaker branch differs from the global one")
    return runs["log-mel feats"][2], runs["log spectra"][2]


def spec_train_step(state_g, state_d, dev):
    """Phase 19, step 2: the flagship's joint forward on log spectra
    against the waveforms they came from (phase 8's shape, float32, the
    clean speech dithered so that no clean bin sits at the log floor), then
    one ``input_kind="spec"`` joint step on the kernel path."""
    data = make_batch(16, TRAIN_SYNTH, np.random.default_rng(100))
    valid = (np.arange(data["clean_wav"].shape[1])[None]
             < data["wav_lengths"][:, None])
    data["clean_wav"] += (0.1 * np.random.default_rng(101).standard_normal(
        data["clean_wav"].shape) * valid).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    jcfg = train_cfg("auto", "auto", "float32")
    fe = jcfg.e2e.frontend
    spec, flens = kaldi_features(batch["noisy_wav"], batch["wav_lengths"],
                                 fe, "spectrogram")
    clean, _ = kaldi_features(batch["clean_wav"], batch["wav_lengths"], fe,
                              "spectrogram")
    state = train_state(jcfg, state_g, state_d, dev)
    model, disc = state.model, state.discriminator
    loss_type = jcfg.discriminator.loss_type

    def losses(out):
        loss_d, loss_adv = adversarial_losses(
            disc(out["clean_logmel"], out["frame_mask"]),
            disc(out["enhanced_logmel"], out["frame_mask"]), loss_type)
        return {"loss": out["loss"], "loss_ctc": out["loss_ctc"],
                "loss_att": out["loss_att"], "loss_d": loss_d,
                "loss_adv": loss_adv,
                "loss_enh": enhancement_loss(
                    out["enhanced_power"], out["clean_power"],
                    out["frame_mask"], kind=jcfg.enh_loss)}

    with torch.no_grad():
        w = losses(model.joint_forward(batch["noisy_wav"], batch["clean_wav"],
                                       batch["wav_lengths"], batch["labels"]))
        s = losses(model.joint_forward_spec(spec, clean, flens,
                                            batch["labels"], log_domain=True))
    ok = True
    for key in w:
        rel = abs(float(s[key]) - float(w[key])) / max(abs(float(w[key])),
                                                        1e-12)
        ok &= rel <= 1e-4
        print(f"  {key}: spectra {float(s[key]):.6g} waveforms "
              f"{float(w[key]):.6g} rel {rel:.2e} (limit 1e-4)")
    require(ok, "joint_forward_spec's losses differ from joint_forward's")

    grads = {}
    step_g = state.opt_g.step

    def keep_grads(gs):
        grads.update(zip((n for n, _ in model.named_parameters()), gs))
        return step_g(gs)

    state.opt_g.step = keep_grads
    step = train_steps.make_joint_train_step(jcfg, input_kind="spec",
                                             log_domain=True)
    reset_counts()
    check_metrics(step(state, {"feats": spec, "clean_feats": clean,
                               "feat_lengths": flens,
                               "labels": batch["labels"]}))
    torch.cuda.synchronize()
    launched = launched_now()
    enh = {n: g for n, g in grads.items() if n.startswith("enhancer.")}
    bad = [n for n, g in enh.items() if g is None
           or not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    print(f"  one spec joint step: {len(enh)} enhancer gradients, "
          f"norms {[round(float(g.norm()), 4) for g in enh.values()]}; "
          f"launches {launched}")
    require(enh and not bad, f"enhancer gradients zero or non-finite: {bad}")
    require_launches("the spec joint step", *counts(KERNELS),
                     ("blstm_train", "gemm", "ctc_nll"), (), attention=True)
    return launched


def spec_serving(b, n_batches, state, dev):
    """Phase 19, step 3: phase 4's traffic as log spectra through the
    flagship with the enhancer, bfloat16, beam 8, 48 steps. Reported, not
    gated: one call's host varies 1.5-2x."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    kcfg = with_impls(flagship_config(VOCAB), "auto", "auto", "bfloat16")
    model = load(kcfg, state, dev)
    search = make_beam_searcher(model, kcfg.e2e, bcfg, use_enhancer=True,
                                input_kind="spec", log_domain=True)
    batches = [kaldi_features(*batch_tensors(b, seed, dev),
                              kcfg.e2e.frontend, "spectrogram")
               for seed in range(n_batches)]
    check_result(search(*batches[0]), b)  # warm-up
    reset_counts()
    times = []
    for x, n in batches:
        res, ms = timed(lambda: search(x, n))
        check_result(res, b)
        times.append(ms)
    launches, plain_calls = counts(SERVING)
    require(all(v > 0 for v in launches.values()) and not any(
        plain_calls.values()), f"spec serving launches {launches}, plain "
                               f"calls {plain_calls}")
    print(f"  {card()}: spec serving B={b}: {b * 1e3 / mean(times):.2f} "
          f"utt/s, {mean(times):.1f} ms/batch "
          f"{['%.1f' % t for t in times]} ({n_batches} warm batches); "
          f"launches {launched_now()}")
    return launched_now()


def kaldi_recipe(work):
    """Phase 19, step 4: a Kaldi recipe of 32 utterances through ``python -m
    robust_e2e_gan_torch`` (its ``main``, in this process, so the launches
    count) at ``train.cli``'s default model: fbank, copy-feats, cmvn, the
    three Kaldi trainings, their decodes, enhance and score."""
    root = os.path.join(work, "kaldi")
    os.makedirs(root)
    n_utts = 32
    _, text, entries = write_corpus(root, n_utts, seed=19)

    def path(name):
        return os.path.join(root, name)

    for name, key in (("wav", "noisy"), ("clean_wav", "clean")):
        kaldi_io.write_ark_scp(
            ((e["utt_id"], np.load(path(e[key]))[None]) for e in entries),
            path(f"{name}.ark"), path(f"{name}.scp"))
    with open(path("utt2spk"), "w") as f:
        f.writelines(f"{e['utt_id']} spk{i % 4}\n"
                     for i, e in enumerate(entries))
    seconds = {}

    def run(name, argv, ran=(), not_ran=(), attention=False):
        reset_counts()
        t0 = time.perf_counter()
        unified_cli.main(argv)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        require_launches(name, *counts(KERNELS), ran, not_ran, attention)

    for name, src, kind in (("mel", "wav", "fbank"),
                            ("spec", "wav", "spectrogram"),
                            ("clean_spec", "clean_wav", "spectrogram")):
        run(f"fbank {name}", ["fbank", "--wav-scp", path(f"{src}.scp"),
                              "--feats-kind", kind, "--out-ark",
                              path(f"{name}.ark"), "--out-scp",
                              path(f"{name}.scp")])
    run("copy-feats", ["copy-feats", "--feats-scp", path("mel.scp"),
                       "--out-ark", path("mel_cm.ark"), "--out-scp",
                       path("mel_cm.scp"), "--compress", "1"])
    run("cmvn --utt2spk", ["cmvn", "--feats-scp", path("mel_cm.scp"),
                           "--utt2spk", path("utt2spk"), "--out",
                           path("spk_cmvn.ark")])
    run("cmvn", ["cmvn", "--wav-scp", path("wav.scp"), "--out",
                 path("cmvn.ark")])
    shapes = {}
    for name in ("mel", "mel_cm", "spec", "clean_spec"):
        mats = dict(kaldi_io.read_mat_scp(path(f"{name}.scp")))
        require(len(mats) == n_utts and all(np.isfinite(m).all()
                                            for m in mats.values()),
                f"{name}: {len(mats)} matrices or non-finite values")
        shapes[name] = {m.shape[1] for m in mats.values()}
    frames = max(num_frames(e["n_samples"], FrontendConfig())
                 for e in entries)
    require(shapes == {"mel": {80}, "mel_cm": {80}, "spec": {257},
                       "clean_spec": {257}}, f"feature widths {shapes}")
    arks = {name: list(dict(kaldi_io.read_mat_ark(path(name))))
            for name in ("spk_cmvn.ark", "cmvn.ark")}
    print(f"  features: 32 utterances, up to {frames} frames, widths "
          f"{shapes}; stats keys {arks}")
    require(arks == {"spk_cmvn.ark": ["spk0", "spk1", "spk2", "spk3"],
                     "cmvn.ark": ["global"]}, f"stats arks {arks}")

    frame_buckets = ["--length-buckets", str(frames)]
    common = ["--train-text", text, "--batch-size", "16", "--log-every", "1"]
    trains = {
        "asr": (["--mode", "asr", "--train-feats-scp", path("mel_cm.scp"),
                 "--cmvn", "speaker", "--cmvn-ark", path("spk_cmvn.ark"),
                 "--utt2spk", path("utt2spk")] + frame_buckets,
                ("blstm_train", "blstm_train_gx", "gemm", "ctc_nll")),
        "joint_spec": (["--mode", "joint", "--train-feats-scp",
                        path("spec.scp"), "--feats-kind", "log-spectrogram",
                        "--train-clean-feats-scp", path("clean_spec.scp")]
                       + frame_buckets,
                       ("blstm_train", "blstm_train_gx", "gemm", "ctc_nll",
                        "blstm_infer_row_tiled")),
        "joint_wav": (["--mode", "joint", "--train-noisy-scp",
                       path("wav.scp"), "--train-clean-scp",
                       path("clean_wav.scp"), "--cmvn", "global",
                       "--cmvn-ark", path("cmvn.ark"), "--index-cache",
                       path("index.json")],
                      ("blstm_train", "blstm_train_gx", "gemm", "ctc_nll",
                       "blstm_infer_row_tiled")),
    }
    probes = {"n": 0}
    probe = dataset._probe_shape

    def counted_probe(*a):
        probes["n"] += 1
        return probe(*a)

    dataset._probe_shape = counted_probe
    try:
        for name, (argv, ran) in trains.items():
            exp = path(f"exp_{name}")
            probes["n"] = 0
            run(f"train {name}", ["train", *argv, *common, "--ckpt-dir", exp,
                                  "--epochs", "1"], ran, attention=True)
            require(latest_step(exp) == n_utts // 16,
                    f"train {name} ended at step {latest_step(exp)}")
            if "--cmvn-ark" in argv:
                ark = argv[argv.index("--cmvn-ark") + 1]
                with open(ark, "rb") as a, \
                        open(os.path.join(exp, "cmvn.ark"), "rb") as b:
                    require(a.read() == b.read(),
                            f"train {name}: cmvn.ark not copied")
            print(f"  train {name}: {latest_step(exp)} steps, "
                  f"{probes['n']} ark headers probed")
        probes["n"] = 0
        exp = path("exp_joint_wav")
        run("train joint_wav resumed", ["train", *trains["joint_wav"][0],
                                        *common, "--ckpt-dir", exp,
                                        "--epochs", "2"],
            trains["joint_wav"][1], attention=True)
        print(f"  the resume: step {latest_step(exp)}, {probes['n']} ark "
              f"headers probed (lengths from the index cache)")
        require(latest_step(exp) == 2 * n_utts // 16 and probes["n"] == 0,
                f"resume ended at step {latest_step(exp)} after "
                f"{probes['n']} probes")
    finally:
        dataset._probe_shape = probe

    serving = ("blstm_infer_row_tiled", "ctc_prefix_psi_utt",
               "ctc_prefix_state_utt")
    decodes = {
        "asr": ["--feats-scp", path("mel_cm.scp"), "--utt2spk",
                path("utt2spk")] + frame_buckets,
        "joint_spec": ["--feats-scp", path("spec.scp")] + frame_buckets,
        "joint_wav": ["--noisy-scp", path("wav.scp"), "--index-cache",
                      path("index.json")],
    }
    for name, argv in decodes.items():
        out = path(f"decode_{name}")
        run(f"decode {name}", ["decode", *argv, "--text", text, "--ckpt-dir",
                               path(f"exp_{name}"), "--out", out], serving)
        with open(os.path.join(out, "wer.json")) as f:
            wer = json.load(f)
        run(f"score {name}", ["score", "--ref", text, "--hyp",
                              os.path.join(out, "hyp.txt"), "--out",
                              path(f"score_{name}.json")])
        with open(path(f"score_{name}.json")) as f:
            report = json.load(f)
        print(f"  decode {name}: wer {wer['wer']['error_rate']!r} cer "
              f"{wer['cer']['error_rate']!r} over {wer['n_utts']}; score "
              f"wer {report['wer']['error_rate']!r}")
        require(wer["n_utts"] == n_utts and all(
            np.isfinite(wer[k]["error_rate"]) for k in ("wer", "cer")),
                f"decode {name}: {wer}")
        for kind in ("wer", "cer"):
            require(report[kind]["error_rate"] == wer[kind]["error_rate"],
                    f"score {name}'s {kind} differs from wer.json")

    run("enhance", ["enhance", "--noisy-scp", path("wav.scp"), "--text",
                    text, "--ckpt-dir", path("exp_joint_wav"), "--out",
                    path("enhanced")], ("blstm_infer_row_tiled",))
    mats = dict(kaldi_io.read_mat_scp(path("enhanced.scp")))
    want = {k: (m.shape[0], 80) for k, m in kaldi_io.read_mat_scp(
        path("mel.scp"))}
    require({k: m.shape for k, m in mats.items()} == want
            and all(np.isfinite(m).all() for m in mats.values()),
            "enhance --noisy-scp wrote other shapes or non-finite values")
    print("  seconds by step "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))


def kaldi_phase(state, state_d, dev, work) -> None:
    """Phase 19: the Kaldi and precomputed-feature inputs."""
    t0 = time.perf_counter()
    print("  step 1: flagship parity (float32, B=16, phase 4's traffic)")
    feats_launches, spec_launches = kaldi_parity(state, dev)
    print("  step 2: one joint step on log spectra (phase 8's shape)")
    train_launches = spec_train_step(state, state_d, dev)
    print(f"  step 3: spec serving (phase 4's traffic, bfloat16, B={BATCH})")
    serve_launches = spec_serving(BATCH, N_BATCHES, state, dev)
    print("  step 4: the Kaldi recipe through python -m robust_e2e_gan_torch")
    kaldi_recipe(work)
    print("  phase 19 launches by path: "
          + json.dumps({"feats f32 B=16": feats_launches,
                        "spec f32 B=16": spec_launches,
                        "spec joint step": train_launches,
                        f"spec serving x{N_BATCHES}": serve_launches}))


# ---------------------------------------------------------------------------
# phase 20: the attention variants and model interchange
# ---------------------------------------------------------------------------

# the kernels no AttAdd or AttDot decode may launch: both attention routes
# and both fused-step routes are location-only
LOCATION_ONLY = ("att_loc_step", "att_loc_step_hyp", "att_dec_step",
                 "att_dec_step_hyp")
# the imported reference's units: ids 1-50, blank 0, sos = eos = 51
UNITS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWX"
INTERCHANGE_STEPS = 3
# two float32 searches whose best hypotheses differ: the two best scores
# must be this close (relative). On random weights a beam holds
# hypotheses within float32 summation noise of each other, and one prune
# decided the other way parts the two beams (AttDot, seed 100, utterance
# 1: best scores 2.2e-5 apart)
NEAR_TIE = 1e-4


def with_variant(jcfg, variant: str):
    return dataclasses.replace(jcfg, e2e=dataclasses.replace(
        jcfg.e2e, attention=dataclasses.replace(jcfg.e2e.attention,
                                                variant=variant)))


def variant_serving(variant, b, n_batches, dev) -> dict:
    """Phase 20, step 1 for one variant: phase 4's traffic in bfloat16
    through the flagship with ``variant`` attention (seed-0 weights), with
    the unfused and with ``step_impl="fused"`` (which such a model does
    not take): the cluster BLSTM and the CTC prefix on route "utt", no
    attention kernel, no fused step; utt/s reported; then the kernel path
    against the plain path in float32 at B=16."""
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    base = with_variant(flagship_config(VOCAB), variant)
    state = from_flax(init_params(base, seed=0))
    batches = [batch_tensors(b, seed, dev) for seed in range(n_batches)]
    n_layers = base.enhancer.num_layers + base.e2e.encoder.num_layers
    launched = {}
    for step_impl in ("auto", "fused"):
        cfg = with_step_impl(with_impls(base, "auto", "auto", "bfloat16"),
                             step_impl)
        model = load(cfg, state, dev)
        search = make_beam_searcher(model, cfg.e2e, bcfg)
        reset_counts()
        for wav, lens in batches:
            check_result(search(wav, lens), b)
        launched[step_impl] = launched_now()
        _, plain_calls = counts(KERNELS)
        where = f"{variant} step_impl={step_impl}"
        print(f"  {where}: launches {launched[step_impl]}")
        routes = dict(blstm.INFER_ROUTE_LAUNCHES)
        require(routes == {"cluster": n_batches * n_layers, "row_tiled": 0}
                and blstm.blstm_recurrence.launches == 0,
                f"{where}: BLSTM launches {routes}, not "
                f"{n_batches * n_layers} on the cluster route")
        require_utt_prefix(where, n_batches * STEPS, n_batches * STEPS)
        require(not any(launched[step_impl].get(n) for n in LOCATION_ONLY),
                f"{where}: a location-only kernel launched")
        require(not any(plain_calls.values()),
                f"{where}: a plain version ran: {plain_calls}")
        if step_impl == "auto":
            ms, enc_ms, search_ms = steady(batches, search, model, cfg, bcfg)
            print(f"  {variant}: {b * 1e3 / ms:.2f} utt/s, {ms:.1f} ms/batch "
                  f"(encode {enc_ms:.1f} ms + search {search_ms:.1f} ms; "
                  f"means over {n_batches} warm batches; {card()})")

    wav, lens = batch_tensors(16, 100, dev)
    out = {}
    for tag, lstm_impl, score, prefix in (("kernel", "auto", "auto", "auto"),
                                          ("plain", "scan", "xla", "twopass")):
        cfg = with_impls(base, lstm_impl, score, "float32")
        search = make_beam_searcher(
            load(cfg, state, dev), cfg.e2e,
            dataclasses.replace(bcfg, prefix_impl=prefix))
        reset_counts()
        out[tag] = search(wav, lens)
        check_result(out[tag], 16)
        if tag == "kernel":
            require_utt_prefix(f"{variant} f32", STEPS, STEPS)
    rel, same = compare_results(out["kernel"], out["plain"],
                                f"{variant} float32")
    print(f"  {variant} float32 B=16: best-score max rel diff {rel:.3e} "
          f"(limit 1e-3); best hypotheses token-identical {same}/16 (any "
          f"other a near tie)")
    require(rel <= 1e-3, f"{variant}: the kernel and plain paths disagree")
    return launched["auto"]


def compare_results(a, b, where):
    """(best-score max relative difference, best hypotheses identical) of
    two searches of one batch. Where the best hypotheses differ, the two
    are printed, and it passes only as a near tie: the two best scores
    within ``NEAR_TIE`` relative (the beams parted at a prune between
    hypotheses of nearly equal score)."""
    rel = ((a.scores - b.scores).abs()
           / b.scores.abs().clamp_min(1e-6))
    same = 0
    for j in range(a.tokens.shape[0]):
        if torch.equal(a.tokens[j], b.tokens[j]):
            same += 1
            continue
        ka, kb = hyp_tokens(a.tokens[j]), hyp_tokens(b.tokens[j])
        first = next((i for i, (x, y) in enumerate(zip(ka, kb)) if x != y),
                     min(len(ka), len(kb)))
        print(f"  {where}, utterance {j}: best hypotheses differ from token "
              f"{first} (lengths {len(ka)}, {len(kb)}); best scores "
              f"{a.scores[j].item():.4f} (kernel), {b.scores[j].item():.4f} "
              f"(plain), relative difference {rel[j].item():.3e}")
        require(rel[j].item() <= NEAR_TIE,
                f"{where}, utterance {j}: the paths' best hypotheses differ "
                f"by more than a near tie")
    return rel.max().item(), same


def hyp_tokens(row):
    return [int(t) for t in row.tolist() if t != -1]


def write_units_manifest(root, n, seed):
    """A manifest of ``n`` .npy utterances of phase 4's task, its texts in
    the ``UNITS`` table (token t is ``UNITS[t - 1]``; the table cannot
    write 51, its sos/eos), the units.txt, and its tokenizer."""
    units = os.path.join(root, "units.txt")
    with open(units, "w") as f:
        f.writelines(f"{u} {i + 1}\n" for i, u in enumerate(UNITS))
    tok = dataset.TableTokenizer.from_units(units)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        tokens = sample_transcript(SYNTH, rng)
        _, noisy = synth_utterance(tokens, SYNTH, rng)
        np.save(os.path.join(root, f"r{i:03d}.npy"), noisy)
        entries.append({"utt_id": f"r{i:03d}", "noisy": f"r{i:03d}.npy",
                        "n_samples": len(noisy),
                        "text": tok.decode(tokens)})
    manifest = os.path.join(root, "manifest.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(json.dumps(e) for e in entries) + "\n")
    return manifest, units, tok


def cli_batch(manifest, tok, dev):
    """The one batch ``decode.cli`` decodes from ``manifest`` (its batcher,
    its default length buckets): (waveforms, lengths, utterance ids)."""
    buckets = tuple(int(x) for x in decode_cli.build_parser().get_default(
        "length_buckets").split(","))
    ds = dataset.AudioTextDataset.from_jsonl(manifest, tokenizer=tok)
    batch = next(dataset.BucketBatcher(ds, BATCH, buckets, pad_final=True)
                 .epoch(shuffle=False))
    return (torch.from_numpy(batch["noisy_wav"]).to(dev),
            torch.from_numpy(batch["wav_lengths"]).to(dev), batch["utt_ids"])


def nbest_tokens(out_dir):
    """utt id -> the best hypothesis' tokens, from ``--nbest 1``."""
    with open(os.path.join(out_dir, "nbest.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["utt_id"]: r["nbest"][0]["tokens"] for r in rows}


def reference_import(work, dev) -> dict:
    """Phase 20, step 2: the flagship's seed-0 generator exported in the
    reference layout, imported with ``--units`` by the port's tool, then
    decoded with sos = eos = 51 by ``decode.cli`` (bfloat16, the default
    and the fused step) against the searcher on the original weights, and
    on the kernel and plain paths in float32 at B=16."""
    root = os.path.join(work, "import")
    os.makedirs(root)
    base = dataclasses.replace(flagship_config(VOCAB),
                               compute_dtype="bfloat16")
    params = init_params(base, seed=0)
    pth = os.path.join(root, "ref.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                import_reference_ckpt.export_state_dict(params, base).items()},
               pth)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(base), f)
    manifest, units, tok = write_units_manifest(root, BATCH, seed=20)
    exp = os.path.join(root, "exp")
    t0 = time.perf_counter()
    import_reference_ckpt.main([pth, exp, "--config", cfg_path,
                                "--units", units])
    print(f"  import: {time.perf_counter() - t0:.1f} s")

    saved = torch.load(os.path.join(exp, "ckpt_0.pt"), map_location="cpu",
                       weights_only=True)["model"]
    want = from_flax(params)
    require(set(saved) == set(want)
            and all(torch.equal(saved[k], v) for k, v in want.items()),
            "the imported parameters differ from the exported ones")
    got_tok = dataset.load_tokenizer(os.path.join(exp, "tokenizer.json"))
    with open(os.path.join(exp, "config.json")) as f:
        e2e = json.load(f)["joint"]["e2e"]
    ids = (e2e["blank_id"], e2e["sos_id"], e2e["eos_id"])
    print(f"  imported {len(saved)} tensors, bit-equal, enhancer included; "
          f"{type(got_tok).__name__} vocab {got_tok.vocab_size}, "
          f"blank/sos/eos {ids}")
    require(isinstance(got_tok, dataset.TableTokenizer)
            and got_tok.vocab_size == VOCAB and ids == (0, 51, 51),
            f"the imported tokenizer or ids: {got_tok}, {ids}")

    jcfg = config_lib.from_dict(JointConfig, dataclasses.asdict(base))
    jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(
        jcfg.e2e, sos_id=51, eos_id=51))
    wav, lens, utt_ids = cli_batch(manifest, tok, dev)
    argv = ["--manifest", manifest, "--ckpt-dir", exp, "--batch-size",
            str(BATCH), "--beam-size", str(BEAM), "--max-steps", str(STEPS),
            "--no-early-exit", "--nbest", "1"]
    launches = {}
    for impls, route_check in (("auto", "att_loc_step"),
                               ("fused", "att_dec_step")):
        out = os.path.join(root, f"decode_{impls}")
        args = argv + ["--serving-impls", impls, "--out", out]
        reset_counts()
        decode_cli.main(args)
        torch.cuda.synchronize()
        launches[impls] = launched_now()
        print(f"  decode.cli --serving-impls {impls}: launches "
              f"{launches[impls]}")
        require(launches[impls].get(route_check) == STEPS,
                f"--serving-impls {impls}: {route_check} launched "
                f"{launches[impls].get(route_check)} times, not {STEPS}")
        # the searcher on the original weights: the same batch, the same
        # impls and search
        bcfg = decode_cli.beam_config(decode_cli.build_parser()
                                      .parse_args(args))
        cfg = decode_cli.with_serving_impls(jcfg, impls)
        search = make_beam_searcher(load(cfg, want, dev), cfg.e2e, bcfg)
        res = search(wav, lens)
        check_result(res, BATCH)
        ref = {u: [int(t) for t in row if t != -1]
               for u, row in zip(utt_ids, res.tokens.tolist())}
        got = nbest_tokens(out)
        same = sum(got[u] == ref[u] for u in ref)
        print(f"  --serving-impls {impls}: best token ids identical to the "
              f"searcher's on the original weights {same}/{len(ref)}")
        require(same == len(ref) == BATCH,
                f"--serving-impls {impls}: the imported model decodes "
                f"other tokens")
        require(all(0 < t < 51 for toks in got.values() for t in toks),
                "a best hypothesis holds blank or sos/eos")

    out = {}
    wav16, lens16 = wav[:16], lens[:16]
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    for tag, lstm_impl, score, prefix in (("kernel", "auto", "auto", "auto"),
                                          ("plain", "scan", "xla", "twopass")):
        cfg = with_impls(jcfg, lstm_impl, score, "float32")
        search = make_beam_searcher(
            load(cfg, want, dev), cfg.e2e,
            dataclasses.replace(bcfg, prefix_impl=prefix))
        reset_counts()
        out[tag] = search(wav16, lens16)
        check_result(out[tag], len(wav16))
        if tag == "kernel":
            launches["f32 kernel"] = launched_now()
    rel, same = compare_results(out["kernel"], out["plain"], "eos 51")
    print(f"  eos 51, float32 B=16: best-score max rel diff {rel:.3e} "
          f"(limit 1e-3); token-identical {same}/{len(wav16)} (any other "
          f"a near tie); kernel launches {launches['f32 kernel']}")
    require(rel <= 1e-3, "eos 51: the kernel and plain paths disagree")
    return launches


def write_jax_experiment(ckpt, jdir, dev) -> None:
    """Phase 7's experiment as the JAX package writes one: its config and
    tokenizer, and each of its best and latest checkpoints as a JAX
    ``TrainState`` in flax msgpack (``ckpt_<step>.msgpack``)."""
    os.makedirs(jdir)
    for name in ("config.json", "tokenizer.json"):
        shutil.copy(os.path.join(ckpt, name), jdir)
    with open(os.path.join(ckpt, "config.json")) as f:
        saved = json.load(f)
    jcfg = config_lib.from_dict(JointConfig, saved["joint"])
    tcfg = config_lib.from_dict(TrainConfig, saved["train"])
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        meta = json.load(f)
    best, latest = meta.get("best"), meta["latest"]
    for step in sorted({e["step"] for e in (best, latest) if e}):
        state = train_loop.init_state(jcfg, tcfg, dev)
        which = "latest" if step == latest["step"] else "best"
        ckpt_lib.restore_checkpoint(ckpt, state, which)
        ckpt_lib.save_jax_checkpoint(
            jdir, state, step,
            metric=best["metric"] if best and step == best["step"] else None,
            extra=latest.get("extra") if step == latest["step"] else None)


def first_losses(run_dir):
    """The losses and accuracy of the first logged train step of a
    ``train.cli`` run."""
    with open(os.path.join(run_dir, "joint_metrics.csv")) as f:
        row = next(csv.DictReader(f))
    return {k: float(v) for k, v in row.items()
            if k.startswith(("loss", "acc")) and v != ""}


def jax_experiment(ckpt, work, dev) -> dict:
    """Phase 20, step 3: phase 7's experiment written in the JAX layout,
    then ``decode.cli``, ``enhance_cli`` and ``train.cli --init-from`` on
    it against the same on the ``.pt`` experiment, and ``--resume``
    refused."""
    root = os.path.join(work, "jax_layout")
    os.makedirs(root)
    jdir = os.path.join(root, "joint_jax")
    write_jax_experiment(ckpt, jdir, dev)
    print(f"  wrote {sorted(os.listdir(jdir))}")
    manifest, _ = write_manifest(root, BATCH, SyntheticConfig(), seed=21)
    launches = {}
    outs = {}
    for tag, exp in (("pt", ckpt), ("jax", jdir)):
        outs[tag] = os.path.join(root, f"decode_{tag}")
        reset_counts()
        decode_cli.main(["--manifest", manifest, "--ckpt-dir", exp,
                         "--batch-size", str(BATCH), "--beam-size",
                         str(BEAM), "--max-steps", str(STEPS),
                         "--no-early-exit", "--out", outs[tag]])
        torch.cuda.synchronize()
        launches[f"decode {tag}"] = launched_now()
        enhance_cli.main(["--manifest", manifest, "--ckpt-dir", exp,
                          "--out", os.path.join(root, f"enhanced_{tag}")])
    for name in ("hyp.txt", "wer.json"):
        with open(os.path.join(outs["pt"], name), "rb") as a, \
                open(os.path.join(outs["jax"], name), "rb") as b:
            require(a.read() == b.read(),
                    f"decode.cli's {name} differs on the JAX layout")
    for suffix in (".ark", ".scp"):
        with open(os.path.join(root, "enhanced_pt" + suffix), "rb") as a, \
                open(os.path.join(root, "enhanced_jax" + suffix), "rb") as b:
            pt_bytes, jax_bytes = a.read(), b.read()
        if suffix == ".scp":  # the scp names its own ark
            pt_bytes = pt_bytes.replace(b"enhanced_pt", b"enhanced_jax")
        require(pt_bytes == jax_bytes,
                f"enhance_cli's {suffix} differs on the JAX layout")
    print(f"  decode.cli hyp.txt and wer.json byte-identical, enhance_cli "
          f"ark/scp identical ({BATCH} utterances); decode launches "
          f"{launches['decode jax']}")

    argv = ["--mode", "joint", "--synthetic", "--synthetic-utts", "16",
            "--batch-size", "16", "--log-every", "1", "--epochs", "2"]
    first = {}
    for tag, exp in (("pt", ckpt), ("jax", jdir)):
        run = os.path.join(root, f"warm_{tag}")
        reset_counts()
        train_cli.main(argv + ["--ckpt-dir", run, "--init-from", exp])
        torch.cuda.synchronize()
        require(latest_step(run) == 2, f"--init-from {tag}: "
                f"{latest_step(run)} steps")
        first[tag] = first_losses(run)
        if tag == "jax":
            launched, plain_calls = counts(KERNELS)
            require_launches("train.cli --init-from <jax dir>", launched,
                             plain_calls, ("blstm_train", "blstm_train_gx",
                                           "ctc_nll"), (), attention=True)
    diff = max(abs(first["jax"][k] - v) / max(abs(v), 1.0)
               for k, v in first["pt"].items())
    print(f"  train.cli --init-from: first-step losses {first['jax']}; "
          f"max rel diff to the .pt warm start {diff:.3e} (limit 1e-6)")
    require(set(first["jax"]) == set(first["pt"]) and diff <= 1e-6,
            "the warm start from the JAX layout differs")
    try:
        train_cli.main(argv + ["--ckpt-dir", jdir])
    except NotImplementedError as e:
        print(f"  train.cli --resume on the JAX dir raised: {e}")
        require("random streams" in str(e), "the refusal gives no reason")
    else:
        require(False, "train.cli resumed a JAX run")
    return launches


def async_saver(state_g, state_d, work, dev) -> None:
    """Phase 20, step 4: ``INTERCHANGE_STEPS`` flagship joint steps
    (bfloat16, phase 6's batch), each followed by an ``AsyncCheckpointer``
    save while the next step updates the parameters in place; every
    checkpoint restores bit-equal to the state at its save."""
    root = os.path.join(work, "async")
    jcfg = train_cfg("auto", "auto", "bfloat16")
    state = train_state(jcfg, state_g, state_d, dev)
    step = train_steps.make_joint_train_step(jcfg)
    batch = train_batch(TRAIN_BATCH, 0, dev)

    def tensors(s):
        """Device copies of the modules' and optimizers' tensors."""
        out = {f"model.{k}": v for k, v in s.model.state_dict().items()}
        out.update({f"disc.{k}": v for k, v in
                    s.discriminator.state_dict().items()})
        for name, opt in (("opt_g", s.opt_g), ("opt_d", s.opt_d)):
            for i, p in enumerate(opt.params):
                out.update({f"{name}.{i}.{k}": v
                            for k, v in opt.opt.state.get(p, {}).items()
                            if torch.is_tensor(v)})
        return {k: v.detach().clone() for k, v in out.items()}

    check_metrics(step(state, batch))  # warm-up
    refs, blocked, step_ms = {}, [], []
    with ckpt_lib.AsyncCheckpointer() as saver:
        for _ in range(INTERCHANGE_STEPS):
            metrics, ms = timed(lambda: step(state, batch))
            check_metrics(metrics)
            step_ms.append(ms)
            refs[state.step] = tensors(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saver.save(root, state, state.step, keep=INTERCHANGE_STEPS + 1)
            blocked.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        saver.wait()
        write_ms = (time.perf_counter() - t0) * 1e3
    fresh = train_state(jcfg, state_g, state_d, dev)
    for n, ref in refs.items():
        saved = torch.load(os.path.join(root, f"ckpt_{n}.pt"),
                           map_location="cpu", weights_only=True)
        fresh.load_state_dict(saved)
        got = tensors(fresh)
        bad = [k for k, v in ref.items()
               if k not in got or not torch.equal(got[k], v)]
        require(not bad and fresh.step == n,
                f"checkpoint {n} differs from the state at its save: {bad}")
    size = os.path.getsize(os.path.join(root, f"ckpt_{state.step}.pt"))
    steps_ms = ['%.1f' % x for x in step_ms]
    print(f"  {INTERCHANGE_STEPS} joint steps (ms {steps_ms}), each saved "
          f"while the next updated in place: every checkpoint "
          f"({size / 1e6:.1f} MB) restores bit-equal; save() blocked the "
          f"training thread {['%.1f' % x for x in blocked]} ms "
          f"(snapshot, and the wait for the write before); the last write "
          f"took {write_ms:.1f} ms more on the saver's thread ({card()})")


def interchange_phase(state, state_d, dev, work, ckpt) -> None:
    """Phase 20: the attention variants and model interchange."""
    launches = {}
    for variant in ("add", "dot"):
        print(f"  step 1: {variant} attention, phase 4's traffic "
              f"(bfloat16, B={BATCH}) and the float32 B=16 parity")
        launches[f"{variant} serving x{N_BATCHES}"] = variant_serving(
            variant, BATCH, N_BATCHES, dev)
    print("  step 2: the reference-layout import (--units, eos 51)")
    launches.update({f"import {k}": v
                     for k, v in reference_import(work, dev).items()})
    print("  step 3: phase 7's experiment in the JAX layout")
    launches.update(jax_experiment(ckpt, work, dev))
    print("  step 4: the asynchronous saver at the flagship's size")
    async_saver(state, state_d, work, dev)
    print("  phase 20 launches by path: " + json.dumps(launches))


# ---------------------------------------------------------------------------
# phase 21: data parallelism
# ---------------------------------------------------------------------------

DP_STEPS = 3
# metrics of the first step, two ranks against one process
# (tests/test_parallel.py:93-96 of the JAX package)
DP_RTOL, DP_ATOL = 2e-4, 2e-5
# the parameters after DP_STEPS float32 Adadelta steps, by module: a
# gradient summed in another order moves an update by at most its own
# change (Adadelta's slope is at most 1, at g = 0) and a saturated one
# (~4.5e-4 * sign(g)) not at all. The discriminator's gradients (norm
# ~716 at the flagship's seed) take cuDNN's convolutions at B=8 against
# B=16: on an H100 its conv1 kernel ends 8.778e-05 from one process's on
# the kernel path and on the plain path alike, the generator 8.9e-06
# (PERF.md, data parallelism). A wrong reduction moves whole updates.
DP_PARAM_ATOL = {"g": 5e-5, "d": 2e-4}
PREFETCH_STEPS = 6
DP_LIMIT_S = 300.0


def dp_batches():
    """Phase 8's float32 B=16 traffic, one batch a step (seeds 100 on),
    each second shard cut to TRAIN_SYNTH.min_tokens labels a row: the two
    shards' valid-token counts differ, so the global denominators count."""
    out = []
    for i in range(DP_STEPS):
        batch = make_batch(16, TRAIN_SYNTH, np.random.default_rng(100 + i))
        batch["labels"][8:, TRAIN_SYNTH.min_tokens:] = -1
        toks = (batch["labels"] != -1).sum(axis=1)
        require(toks[:8].sum() != toks[8:].sum(),
                f"phase 21: the shards hold equal token counts {toks}")
        out.append(batch)
    return out


def dp_gate_launches(where, launches, kernels, plain):
    """Every kernel of ``kernels`` launched (a tuple: one of its routes),
    no plain version of ``plain`` ran."""
    ran = {" or ".join(k) if isinstance(k, tuple) else k:
           sum(launches[n] for n in (k if isinstance(k, tuple) else (k,)))
           for k in kernels}
    require(all(v > 0 for v in ran.values()),
            f"{where}: a kernel never launched: {ran}")
    ran_plain = {n: launches[n] for n in plain if launches[n]}
    require(not ran_plain, f"{where}: a plain version ran: {ran_plain}")
    return ran


def dp_train_checks(ranks, one):
    """Two ranks' joint steps against one process's: first-step metrics,
    later steps reported, parameters after the last step (the generator's
    and the discriminator's apart)."""
    worst = []
    for i in range(DP_STEPS):
        want = one["metrics"][i]
        rel = {}
        for r in ranks:
            for k, w in want.items():
                g = r["metrics"][i][k]
                rel[k] = max(rel.get(k, 0.0),
                             abs(g - w) / max(abs(w), 1e-12))
                if i == 0:
                    require(abs(g - w) <= DP_ATOL + DP_RTOL * abs(w),
                            f"phase 21: step 1 {k} two ranks {g!r}, one "
                            f"process {w!r}")
        if i == 0:
            print("  train step 1, rel diff by metric: " + " ".join(
                f"{k}={v:.2e}" for k, v in rel.items()))
        k = max(rel, key=rel.get)
        worst.append(f"{rel[k]:.2e} ({k})")
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in one["params"])
    diffs = {k: (ranks[0]["params"][k].float()
                 - one["params"][k].float()).abs().max().item()
             for k in one["params"]}
    by_module = {}
    for m in ("g", "d"):
        keys = [k for k in diffs if k.startswith(m + ".")]
        top = max(keys, key=diffs.get)
        by_module[m] = (diffs[top], top)
    m = ranks[0]["metrics"][0]
    print(f"  train: first-step metrics within rtol {DP_RTOL:g} / atol "
          f"{DP_ATOL:g} (loss_att {m['loss_att']:.6g}, grad_norm_g "
          f"{m['grad_norm_g']:.6g}, grad_norm_d {m['grad_norm_d']:.6g}); "
          f"max rel diff by step {worst}; the ranks' parameters bit-equal "
          f"{same}; against one process after {DP_STEPS} steps max abs: "
          f"generator {by_module['g'][0]:.3e} ({by_module['g'][1]}; limit "
          f"{DP_PARAM_ATOL['g']:g}), discriminator {by_module['d'][0]:.3e} "
          f"({by_module['d'][1]}; limit {DP_PARAM_ATOL['d']:g})")
    require(same, "phase 21: the two ranks' parameters differ")
    require(all(by_module[m][0] <= DP_PARAM_ATOL[m] for m in by_module),
            f"phase 21: parameters {by_module} from one process's")


def dp_decode_checks(ranks, one):
    tokens = np.concatenate([r["tokens"] for r in ranks])
    scores = np.concatenate([r["scores"] for r in ranks])
    same = int(sum(np.array_equal(a, b) for a, b in zip(tokens,
                                                         one["tokens"])))
    rel = float(np.max(np.abs(scores - one["scores"])
                       / np.maximum(np.abs(one["scores"]), 1e-6)))
    print(f"  decode: tokens identical {same}/16, best-score max rel "
          f"{rel:.3e} (limit 1e-3)")
    require(same == 16, "phase 21: two ranks' tokens differ from one "
                        "process's")
    require(rel <= 1e-3, "phase 21: two ranks' scores differ")


def prefetch_report(dev, work) -> None:
    """Phase 7's train traffic (train.cli's default model, f32, B=16)
    through a depth-2 ``Prefetcher``: the ms the training thread waited in
    ``next()`` each step, and the collation ms of a batch timed alone;
    then the loop's ms a step (collation included) with the Prefetcher
    and with batches collated on the training thread, in turns (A, B, B,
    A). Reported, not gated."""
    args = train_cli.build_parser().parse_args(
        ["--mode", "joint", "--synthetic", "--ckpt-dir", work,
         "--batch-size", "16", "--synthetic-utts",
         str(16 * PREFETCH_STEPS)])
    train_b, _, vocab, _ = train_cli._synthetic_factories(args)
    jcfg, tcfg = train_cli.configs_from_args(args, vocab)
    t0 = time.perf_counter()
    n = sum(1 for _ in train_b())
    collate_ms = (time.perf_counter() - t0) * 1e3 / n
    state = train_loop.init_state(jcfg, tcfg, dev)
    step = train_steps.make_joint_train_step(jcfg)

    def run(batches, waits=None):
        """ms a step of the loop over ``batches``, each step synchronised."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            batch = next(batches, None)
            if waits is not None:
                waits.append((time.perf_counter() - t1) * 1e3)
            if batch is None:
                break
            step(state, train_loop.device_batch(batch, dev))
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    waits = []
    with dataset.Prefetcher(train_b(), 2) as batches:
        run(batches, waits)  # also the warm-up
    loop_ms = {"prefetch": [], "inline": []}
    for tag in ("prefetch", "inline", "inline", "prefetch"):
        if tag == "inline":
            loop_ms[tag].append(run(iter(train_b())))
        else:
            with dataset.Prefetcher(train_b(), 2) as batches:
                loop_ms[tag].append(run(batches))
    print(f"  prefetch (phase 7's traffic, depth 2, {n} steps): next() "
          f"waited {['%.2f' % x for x in waits[:-1]]} ms (mean after the "
          f"first {mean(waits[1:-1]):.3f}); collation alone "
          f"{collate_ms:.2f} ms a batch; the loop's ms a step with the "
          f"Prefetcher {['%.1f' % x for x in loop_ms['prefetch']]}, "
          f"collating on the training thread "
          f"{['%.1f' % x for x in loop_ms['inline']]} (in turns; {card()})")


def dp_phase(state, state_d, dev, work) -> None:
    """Phase 21: data parallelism on the card."""
    jcfg = train_cfg("auto", "auto", "float32")
    tcfg = TrainConfig()
    batches = dp_batches()
    dcfg = with_impls(flagship_config(VOCAB), "auto", "auto", "float32")
    data = make_batch(16, SYNTH, np.random.default_rng(100))
    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=True)
    calls = [(dp_phases.joint_steps, (jcfg, tcfg, state, state_d, batches),
              {}),
             (dp_phases.beam_decode, (dcfg, state, data["noisy_wav"],
                                      data["wav_lengths"], bcfg), {})]
    # two ranks on one card take gloo (NCCL refuses them); one a card NCCL
    shared = "cuda:0" if dev.type == "cuda" else "cpu"
    print(f"  (1-2) two gloo ranks on {shared}: {DP_STEPS} float32 joint "
          f"steps of phase 8's B=16 (8 rows a rank), then phase 5's B=16 "
          f"decode with early exit, against one process")
    t0 = time.perf_counter()
    ranks = launch(dp_phases.run_all, make_mesh(2, 1, shared), calls,
                   limit_s=DP_LIMIT_S)
    ranks_s = time.perf_counter() - t0
    one_train = dp_phases.joint_steps(None, jcfg, tcfg, state, state_d,
                                      batches, device=str(dev))
    one_dec = dp_phases.beam_decode(None, dcfg, state, data["noisy_wav"],
                                    data["wav_lengths"], bcfg,
                                    device=str(dev))
    for r, (train, dec) in enumerate(ranks):
        ran = dp_gate_launches(
            f"phase 21 rank {r} train", train["launches"],
            ("blstm_train", "gemm", "ctc_nll"),
            ("blstm_train_plain", "gemm_plain", "ctc_nll_plain"))
        ran.update(dp_gate_launches(
            f"phase 21 rank {r} decode", dec["launches"],
            (("blstm_infer_cluster", "blstm_infer_row_tiled"),
             ("att_loc_step_utt", "att_loc_step_hyp"), "psi", "state"),
            ("blstm_infer_plain", "att_plain", "psi_plain", "state_plain")))
        by_route = {k: v for k, v in {**train["launches"],
                                      **dec["launches"]}.items() if v}
        print(f"  rank {r} launches {ran}; by kernel and route {by_route}")
    dp_train_checks([t for t, _ in ranks], one_train)
    dp_decode_checks([d for _, d in ranks], one_dec)
    print(f"  the launch took {ranks_s:.1f} s (spawn, import, both ranks' "
          "work time-sliced on one card: no speed of data parallelism)")

    # (3) NCCL at world size 1, deterministic algorithms in both runs
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        plain = dp_phases.joint_steps(None, jcfg, tcfg, state, state_d,
                                      batches[:1], device=str(dev))
        nccl = launch(dp_phases.joint_steps, make_mesh(1, 1, dev.type), jcfg,
                      tcfg, state, state_d, batches[:1],
                      limit_s=DP_LIMIT_S)[0]
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
    metrics_equal = nccl["metrics"] == plain["metrics"]
    params_equal = all(torch.equal(nccl["params"][k], plain["params"][k])
                       for k in plain["params"])
    print(f"  (3) one {make_mesh(1, 1, dev.type).backend} rank, one step "
          f"through the reduction: "
          f"metrics bit-equal {metrics_equal}, parameters bit-equal "
          f"{params_equal} (launches {nccl['launches']['blstm_train']} "
          f"blstm_train, {nccl['launches']['gemm']} gemm)")
    require(metrics_equal and params_equal,
            "phase 21: the world-1 NCCL step differs from the step without "
            "a mesh")
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        ckpt = os.path.join(work, "dp_cli")
        train_cli.main(["--mode", "joint", "--synthetic", "--ckpt-dir", ckpt,
                        "--synthetic-utts", "32", "--batch-size", "16",
                        "--epochs", "1", "--log-every", "1",
                        "--mesh-data", "2"])
        step = latest_step(ckpt)
        print(f"  train.cli --mesh-data 2 over NCCL on 2 cards: step {step}")
        require(step == 2, f"train.cli --mesh-data 2 ended at step {step}")
    else:
        print("  train.cli --mesh-data 2 over NCCL: not run (one card; it "
              "needs two)")

    # (4) the Prefetcher
    prefetch_report(dev, os.path.join(work, "prefetch"))


# ---------------------------------------------------------------------------
# phase 22: the host-side overlap
# ---------------------------------------------------------------------------

HOST_BATCH = 32
HOST_BATCHES = 8
LOOP_STEPS = 2  # of the manifest's batches, a timed run of the loop
WER_UTTS = 1024
STAGED_RTOL = 1e-5
CLI_STAGED_BATCH = 16


def in_turns_ms(fns):
    """({tag: [ms of each call]}, {tag: its first call's result}), the
    callables timed in turns (A, B, B, A), each ending in a
    synchronise."""
    tags = list(fns)
    ms, first = {tag: [] for tag in tags}, {}
    for tag in tags + tags[::-1]:
        out, t = timed(fns[tag])
        first.setdefault(tag, out)
        ms[tag].append(t)
    return ms, first


def fmt_ms(ms: dict, per: int = 1) -> str:
    return "; ".join(f"{tag} {['%.2f' % (x / per) for x in xs]}"
                     for tag, xs in ms.items())


def collation_report(work):
    """(1a) B=32 batches of the train cell's traffic from a ``.npy``
    manifest, the C++ reader against the numpy one; one CM-compressed
    feature batch; ``wer_details`` on 1,024 utterances. Returns the
    manifest."""
    root = os.path.join(work, "host")
    os.makedirs(root)
    manifest, tok = write_manifest(root, HOST_BATCH * HOST_BATCHES,
                                   TRAIN_SYNTH, seed=22)
    ds = dataset.AudioTextDataset.from_jsonl(manifest, tokenizer=tok)
    batcher = dataset.BucketBatcher(ds, HOST_BATCH,
                                    (TRAIN_SYNTH.max_samples,))

    def collate():
        return list(batcher.epoch(shuffle=False))

    def collate_plain():
        with dataset._force_plain_collation():
            return collate()

    ms, runs = in_turns_ms({"native": collate, "plain": collate_plain})
    got, want = runs["native"], runs["plain"]
    same = len(got) == len(want) == HOST_BATCHES and all(
        g.keys() == w.keys() and all(
            np.array_equal(g[k], w[k]) and (k == "utt_ids"
                                            or g[k].dtype == w[k].dtype)
            for k in g) for g, w in zip(got, want))
    print(f"  (1a) .npy manifest, {HOST_BATCHES} batches of B={HOST_BATCH} "
          f"padded to {TRAIN_SYNTH.max_samples} samples: native bit-equal "
          f"to plain {same}; ms a batch (in turns) "
          f"{fmt_ms(ms, HOST_BATCHES)}")
    require(same, "phase 22: the native .npy batches differ from numpy's")

    rng = np.random.default_rng(22)
    t = num_frames(TRAIN_SYNTH.max_samples, FrontendConfig())
    mats = {f"c{i}": (3 * rng.standard_normal((t - i, 80)) - 5).astype(
        np.float32) for i in range(HOST_BATCH)}
    scp = os.path.join(root, "feats_cm.scp")
    kaldi_io.write_ark_scp(iter(mats.items()), os.path.join(
        root, "feats_cm.ark"), scp, compress=1)
    entries = list(kaldi_io.read_scp_index(scp).values())
    fns = {"native": lambda: native.native_load_kaldi_feats_batch(
               entries, t, 80),
           "plain": lambda: dataset.load_kaldi_feats_batch_plain(
               entries, t, 80)}
    ms, runs = in_turns_ms(fns)
    (a, _), (b, _) = runs["native"], runs["plain"]
    ulps = max(float(np.abs(x - y).max() / np.spacing(np.abs(y).max()))
               for x, y in zip(a, b))
    print(f"  (1b) one CM-compressed feats batch ({HOST_BATCH} x {t} x 80): "
          f"native within {ulps:.2f} ulps of each matrix's largest "
          f"magnitude of plain; ms (in turns) {fmt_ms(ms)}")

    refs = [rng.integers(3, 52, size=int(rng.integers(45, 56))).tolist()
            for _ in range(WER_UTTS)]
    hyps = []
    for r in refs:
        h = list(r)
        for _ in range(int(rng.integers(0, 6))):
            j = int(rng.integers(0, len(h)))
            h[j:j + 1] = [[], [int(rng.integers(3, 52))],
                          [h[j], int(rng.integers(3, 52))]][j % 3]
        hyps.append(h)
    fns = {"native": lambda: editdistance.wer_details(refs, hyps),
           "plain": lambda: editdistance.wer_details_plain(refs, hyps)}
    ms, runs = in_turns_ms(fns)
    same = runs["native"] == runs["plain"]
    print(f"  (1c) wer_details on {WER_UTTS} utterances of ~50 tokens: "
          f"native equal to plain {same}; ms (in turns) {fmt_ms(ms)}")
    require(same, "phase 22: the native corpus scorer differs from plain")
    return manifest


def loader_loop_report(manifest, work, dev) -> None:
    """(1d) The loop's ms a step over the manifest's batches on phase 7's
    model (train.cli's default, float32) with a depth-2 ``Prefetcher``,
    collated by the C++ readers and by numpy, in turns (A, B, B, A)."""
    args = train_cli.build_parser().parse_args(
        ["--mode", "joint", "--train-manifest", manifest, "--ckpt-dir",
         os.path.join(work, "host_run"), "--batch-size", str(HOST_BATCH),
         "--length-buckets", str(TRAIN_SYNTH.max_samples)])
    train_b, _, vocab, _ = train_cli._corpus_factories(args)
    jcfg, tcfg = train_cli.configs_from_args(args, vocab)
    state = train_loop.init_state(jcfg, tcfg, dev)
    step = train_steps.make_joint_train_step(jcfg)

    def run(plain: bool, steps: int) -> float:
        ctx = (dataset._force_plain_collation() if plain
               else contextlib.nullcontext())
        with ctx, dataset.Prefetcher(train_b(), 2) as batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                check_metrics(step(state, train_loop.device_batch(
                    next(batches), dev)))
                torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    run(False, 1)  # warm-up
    ms = {"native": [], "plain": []}
    for tag in ("native", "plain", "plain", "native"):
        ms[tag].append(run(tag == "plain", LOOP_STEPS))
    print(f"  (1d) the loop over {LOOP_STEPS} of them a run, train.cli's "
          f"default model (f32), depth-2 Prefetcher: ms a step (in turns) "
          f"{fmt_ms(ms)}; {card()}")


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def measure_ms(intervals) -> float:
    return sum(b - a for a, b in merged(intervals)) / 1e3


def intersect(x, y):
    """The intersection of two unions of intervals."""
    x, y, out, i, j = merged(x), merged(y), [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def stream_rows(fn):
    """fn once under torch.profiler, the device's activity alone: [(stream,
    name, start us, end us)] of its device rows."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.device_resource_id, e.name, e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def overlap_report(rows, wall_ms, tag) -> float:
    """Print the device's busy ms (any stream) and share of ``wall_ms``,
    each stream's busy ms and the ms in which two streams ran at once;
    return the latter."""
    by_stream = {}
    for stream, _, a, b in rows:
        by_stream.setdefault(stream, []).append((a, b))
    busy = measure_ms([(a, b) for _, _, a, b in rows])
    streams = sorted(by_stream, key=lambda k: -measure_ms(by_stream[k]))
    both = []
    for i, x in enumerate(streams):
        for y in streams[i + 1:]:
            both += intersect(by_stream[x], by_stream[y])
    overlap = measure_ms(both)
    print(f"    {tag}: device busy {busy:.1f} ms of an unprofiled "
          f"{wall_ms:.1f} ms (busy share {busy / wall_ms:.3f}); by stream "
          + ", ".join(f"{k}: {measure_ms(by_stream[k]):.1f} ms"
                      for k in streams)
          + f"; two streams at once {overlap:.2f} ms")
    return overlap


def host_batches(b, n, seed0=0, synth=SYNTH):
    """{"noisy_wav" and "clean_wav": ``n`` batches of ``b`` as CPU tensors,
    as a decode CLI hands them to its searcher}."""
    out = {"noisy_wav": [], "clean_wav": []}
    for seed in range(seed0, seed0 + n):
        data = make_batch(b, synth, np.random.default_rng(seed))
        for wav, batches in out.items():
            batches.append((torch.from_numpy(data[wav]),
                            torch.from_numpy(data["wav_lengths"])))
    return out


def read_result(res):
    """What a consumer reads of a BeamResult: on the host."""
    return res.tokens.cpu(), res.beam_tokens.cpu(), res.scores.cpu()


def sequential_pass(search, batches, dev):
    return [read_result(search(w.to(dev), n.to(dev))) for w, n in batches]


def staged_pass(run, batches):
    return [read_result(r) for r in run(iter(batches))]


def staged_checks(got, want, where) -> bool:
    """Tokens identical and best scores within STAGED_RTOL; returns
    whether every result is bit-equal."""
    require(len(got) == len(want), f"{where}: {len(got)} results, "
                                   f"{len(want)} batches")
    same = all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
               for g, w in zip(got, want))
    rel = max(float(((g[2] - w[2]).abs() / w[2].abs().clamp_min(1e-6))
                    .max()) for g, w in zip(got, want))
    bit = all(torch.equal(g[2], w[2]) for g, w in zip(got, want)) and same
    print(f"    {where}: tokens identical {same}, best-score max rel diff "
          f"{rel:.3e} (limit {STAGED_RTOL:g}), bit-equal {bit}")
    require(same, f"{where}: the staged searcher's tokens differ")
    require(rel <= STAGED_RTOL, f"{where}: the staged scores differ")
    return bit


def staged_ab(model, e2e, bcfg, batches, dev, tag, profile=True, **kw):
    """The staged searcher against the sequential one on ``batches``:
    gated, then timed in turns with a profiled pass of each over the first
    two batches."""
    seq = make_beam_searcher(model, e2e, bcfg, **kw)
    run = make_pipelined_beam_searcher(model, e2e, bcfg, **kw)
    fns = {"sequential": lambda: sequential_pass(seq, batches, dev),
           "staged": lambda: staged_pass(run, batches)}
    if not profile:
        staged_checks(fns["staged"](), fns["sequential"](), tag)
        return fns
    n = len(batches)
    ms, first = in_turns_ms(fns)
    staged_checks(first["staged"], first["sequential"], tag)
    print(f"    {tag}: ms a batch over {n} batches (in turns) "
          f"{fmt_ms(ms, n)}")
    two = batches[:2]
    for name, fn in (("sequential", lambda: sequential_pass(seq, two, dev)),
                     ("staged", lambda: staged_pass(run, two))):
        overlap_report(stream_rows(fn), 2 * mean(ms[name]) / n,
                       f"{tag}, {name}, a profiled pass of 2 batches "
                       f"(against 2 x its mean ms a batch)")
    return fns


def random_model(jcfg, seed, dev):
    """``jcfg``'s model with random weights drawn on the card from
    ``seed``: N(0, 1 / fan-in) for each weight (its leading dims' product
    the fan-in, as the flax layouts keep the output last), N(0, 0.02^2)
    for each vector. Seconds, where ``init_params`` takes ~8 s of host
    time for the wide encoder."""
    model = build_model(jcfg).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = (0.02 if p.ndim == 1
                   else (p.numel() // p.shape[-1]) ** -0.5)
            p.normal_(0.0, std, generator=gen)
    return model


def staged_searcher_report(state, dev) -> None:
    """(2) The staged searcher against the sequential one: phase 4's
    traffic with early exit on and off; phase 9's clean decode with the LM
    and the fused frontend; the fused step; a pair of B=16 batches through
    phase 15's wide float32 encoder with the fused step."""
    t0 = time.perf_counter()
    kcfg = with_impls(flagship_config(VOCAB), "auto", "auto", "bfloat16")
    model = load(kcfg, state, dev)
    both = host_batches(BATCH, N_BATCHES)
    batches = both["noisy_wav"]
    for early_exit in (True, False):
        bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3,
                                max_steps=STEPS, early_exit=early_exit)
        staged_ab(model, kcfg.e2e, bcfg, batches, dev,
                  f"phase 4's traffic, early exit {early_exit}")

    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False, lm_weight=LM_WEIGHT)
    ccfg = clean_cfg("auto", "auto", "bfloat16")
    reset_counts()
    staged_ab(load(ccfg, state, dev), ccfg.e2e, bcfg,
              both["clean_wav"], dev,
              "phase 9's clean decode (LM, fused frontend)", profile=False,
              use_enhancer=False, lm=make_lm("auto", dev))
    ran = counts(("fbank_fused", "lm_step"))[0]
    print(f"    launches {ran}, LM by route {dict(lm_step.LM_ROUTE_LAUNCHES)}"
          f", frontend by route {dict(fbank_fused.FBANK_ROUTE_LAUNCHES)}")
    require(ran["fbank_fused"] > 0 and ran["lm_step"] > 0,
            f"phase 22: the clean decode's kernels did not launch: {ran}")

    bcfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.3, max_steps=STEPS,
                            early_exit=False)
    fcfg = with_step_impl(kcfg, "fused")
    reset_counts()
    staged_ab(load(fcfg, state, dev), fcfg.e2e, bcfg, batches, dev,
              "phase 13's fused step", profile=False)
    require(launch_count("att_dec_step") > 0,
            "phase 22: the fused step did not launch")
    print(f"    ({time.perf_counter() - t0:.1f} s so far)")

    wcfg = with_step_impl(wide_config("float32"), "fused")
    wide = random_model(wcfg, 3, dev)
    reset_counts()
    fns = staged_ab(wide, wcfg.e2e, bcfg,
                    host_batches(16, 2, seed0=100)["noisy_wav"],
                    dev, "phase 15's wide f32 encoder, fused step, B=16 x 2",
                    profile=False)
    ran = {"blstm_recurrence (grid)": blstm.GX_ROUTE_LAUNCHES["grid"],
           "att_dec_step (utt)": att_dec.DEC_ROUTE_LAUNCHES["utt"]}
    print(f"    cooperative launches {ran}")
    require(all(ran.values()), f"phase 22: a cooperative grid of the wide "
                               f"pass did not launch: {ran}")
    rows = stream_rows(fns["staged"])
    grid = [(a, b) for _, name, a, b in rows if "blstm_gx_grid" in name]
    step = [(a, b) for _, name, a, b in rows if "att_dec_utt" in name]
    both = intersect(grid, step)
    overlap_report(rows, timed(fns["staged"])[1],
                   "wide encoder, staged, profiled pass")
    print(f"    the encode's grid recurrence ({len(grid)} launches, "
          f"{measure_ms(grid):.2f} ms, on stream(s) "
          f"{sorted({s for s, n, _, _ in rows if 'blstm_gx_grid' in n})}) "
          f"and the loop's fused step ({len(step)} launches, "
          f"{measure_ms(step):.2f} ms, on stream(s) "
          f"{sorted({s for s, n, _, _ in rows if 'att_dec_utt' in n})}) "
          f"ran at once for {measure_ms(both):.3f} ms in {len(both)} "
          f"spans, the longest {max([b - a for a, b in both], default=0)} "
          f"us")


def staged_cli_report(ckpt, work) -> None:
    """(3) ``decode.cli --pipelined on`` on phase 7's experiment, default
    impls and ``--serving-impls fused``: its three files byte-identical
    to ``--pipelined off``'s."""
    root = os.path.join(work, "staged_cli")
    os.makedirs(root)
    manifest, tok = write_manifest(root, 2 * CLI_STAGED_BATCH,
                                   SyntheticConfig(), seed=22)
    tok.save(os.path.join(ckpt, "tokenizer.json"))
    argv = ["--manifest", manifest, "--ckpt-dir", ckpt, "--batch-size",
            str(CLI_STAGED_BATCH), "--beam-size", str(BEAM), "--max-steps",
            str(STEPS // 2), "--nbest", "2"]
    for impls in ("auto", "fused"):
        secs, outs = {}, {}
        for schedule in ("off", "on"):
            outs[schedule] = os.path.join(root, f"{impls}_{schedule}")
            t0 = time.perf_counter()
            decode_cli.main(argv + ["--serving-impls", impls, "--pipelined",
                                    schedule, "--out", outs[schedule]])
            torch.cuda.synchronize()
            secs[schedule] = time.perf_counter() - t0
        same = {}
        for name in ("hyp.txt", "wer.json", "nbest.jsonl"):
            with open(os.path.join(outs["off"], name), "rb") as a, \
                    open(os.path.join(outs["on"], name), "rb") as b:
                same[name] = a.read() == b.read()
        print(f"  (3) decode.cli --serving-impls {impls}, 2 batches of "
              f"{CLI_STAGED_BATCH}: --pipelined on {secs['on']:.2f} s, off "
              f"{secs['off']:.2f} s wall; byte-identical {same}")
        require(all(same.values()),
                f"phase 22: --pipelined on wrote other files: {same}")


def host_overlap_phase(state, dev, work, ckpt, host_build_s) -> None:
    """Phase 22: the C++ host loaders and scorer, and the staged decode."""
    print(f"  (1) host library: built in {host_build_s:.2f} s at phase 2 by "
          f"{native.compiler_version()}")
    t0 = time.perf_counter()
    manifest = collation_report(work)
    t1 = time.perf_counter()
    loader_loop_report(manifest, work, dev)
    t2 = time.perf_counter()
    print("  (2) the staged searcher (each next batch's copy and encode on "
          "a side stream) against the sequential one:")
    staged_searcher_report(state, dev)
    t3 = time.perf_counter()
    staged_cli_report(ckpt, work)
    print(f"  phase 22 by part: (1a-c) {t1 - t0:.1f} s, (1d) {t2 - t1:.1f} s, "
          f"(2) {t3 - t2:.1f} s, (3) {time.perf_counter() - t3:.1f} s")


# ---------------------------------------------------------------------------
# phase 23: the paper-claim protocol at the reference scale
# ---------------------------------------------------------------------------

# the JAX record's reference-scale recipe (results/adversarial_benefit_
# reference*.json): Adam 3e-4, 600 warmup steps, batches of 32
REF_TCFG = dict(optimizer="adam", learning_rate=3e-4, warmup_steps=600,
                batch_size=32, seed=0)
REF_STEPS = 6
REF_DECODE = 64
REF_PARITY = 16
# (4): 4 + 2 x 2 + 2 = 10 global steps, saved after steps 3, 6 and 9; the
# cut comes before global step 6, right after the second save
REF_RESUME = dict(scale="reference", steps_a=4, steps_c=2, bs=32, lr=3e-4,
                  warmup=600, save_every=3, eval_utts=16, route_batches=1,
                  check_claim=False)
REF_CUT = 6
# what the reference model's 6 joint steps must launch and must not: the
# frame loops (resident), gemm.cu's products and the CTC loss, the
# D-step's enhancer forward on the inference BLSTM's cluster route (H =
# 512 in bfloat16: clusters of 16 blocks)
REF_JOINT = (("blstm_train", "gemm", "ctc_nll", "blstm_infer"),
             ("blstm_infer_row_tiled", "blstm_train_gx"), True)


class Cut(Exception):
    pass


def reference_steps(jcfg, state, stream, rng, dev) -> None:
    """Phase 23 (1): ``REF_STEPS`` joint steps of the reference model at
    B=32 on the hard-task stream, their launches checked."""
    step = train_steps.make_joint_train_step(jcfg, with_asr=True)
    seconds = {}
    watch = section_watch("phase 23", {"joint": REF_JOINT}, seconds,
                          ("joint",))
    batches = [train_loop.device_batch(stream.batch(REF_TCFG["batch_size"],
                                                    rng), dev)
               for _ in range(REF_STEPS)]
    times = []
    with watch("joint"):
        for batch in batches:
            metrics, ms = timed(lambda: step(state, batch))
            check_metrics(metrics)
            times.append(ms)
        gemm_routes = dict(blstm_train.GEMM_ROUTE_LAUNCHES)
        infer_routes = dict(blstm.INFER_ROUTE_LAUNCHES)
    n_enh = jcfg.enhancer.num_layers
    print(f"  blstm_infer launches by route {infer_routes}; gemm launches "
          f"by route {gemm_routes}")
    require(infer_routes == {"cluster": n_enh * REF_STEPS, "row_tiled": 0},
            f"phase 23: the D-step's enhancer forward did not take the "
            f"cluster route at every step: {infer_routes}")
    require(gemm_routes["simt"] == 0 and gemm_routes["tc"] > 0,
            f"phase 23: not every product took the tensor-core kernel: "
            f"{gemm_routes}")
    warm = mean(times[1:])
    print(f"  (1) {REF_STEPS} joint steps B={REF_TCFG['batch_size']}: ms "
          f"{['%.1f' % t for t in times]}; {warm:.1f} ms/step over the last "
          f"{REF_STEPS - 1} (host clock ending in torch.cuda.synchronize(); "
          f"{card()}); metrics " + " ".join(
              f"{k}={float(v):.4g}" for k, v in metrics.items()))


def reference_decode(jcfg, params, dev) -> None:
    """Phase 23 (2): ``REF_DECODE`` eval utterances in bfloat16 (beam 4,
    ``max_label_len + 2`` steps, no early exit), every launch on its
    route; then the kernel path against the plain path in float32 at
    B=16."""
    scfg = adversarial_benefit.SCFG
    bcfg = dataclasses.replace(adversarial_benefit.beam_config(scfg),
                               early_exit=False)
    steps = bcfg.max_steps
    stream = adversarial_benefit.Stream(scfg)
    data = stream.batch(REF_DECODE, np.random.default_rng(
        adversarial_benefit.EVAL_SEED))
    wav = torch.from_numpy(data["noisy_wav"]).to(dev)
    lens = torch.from_numpy(data["wav_lengths"]).to(dev)
    model = load(jcfg, params, dev)
    search = make_beam_searcher(model, jcfg.e2e, bcfg, use_enhancer=True)
    search(wav, lens)  # warm-up
    reset_counts()
    res, ms = timed(lambda: search(wav, lens))
    require(bool(torch.isfinite(res.scores).all())
            and res.tokens.shape == (REF_DECODE, steps),
            f"phase 23: decode result {tuple(res.tokens.shape)}")
    launched, plain_calls = counts(KERNELS)
    routes = dict(blstm.INFER_ROUTE_LAUNCHES)
    n_layers = jcfg.enhancer.num_layers + jcfg.e2e.encoder.num_layers
    print(f"  blstm_infer launches by route {routes}")
    require(routes == {"cluster": n_layers, "row_tiled": 0},
            f"phase 23: the decode's BLSTM launches {routes}, not "
            f"{n_layers} on the cluster route")
    require_utt_attention("phase 23", steps)
    require_utt_prefix("phase 23", steps, steps)
    require(not any(plain_calls.values()),
            f"phase 23: a plain version ran: {plain_calls}")
    refs = labels_to_list(data["labels"])
    wer = editdistance.wer_details(refs, verify_drive.token_lists(
        res.tokens))["error_rate"]
    print(f"  (2) bf16 decode of {REF_DECODE} eval utterances, beam "
          f"{bcfg.beam_size}, {steps} steps: {ms:.1f} ms "
          f"({REF_DECODE * 1e3 / ms:.2f} utt/s; {card()}); TER {wer:.4f} "
          f"after {REF_STEPS} steps")

    wav, lens = wav[:REF_PARITY], lens[:REF_PARITY]
    out = {}
    for tag, lstm_impl, score, prefix in (("kernel", "auto", "auto", "auto"),
                                          ("plain", "scan", "xla", "twopass")):
        cfg = with_impls(jcfg, lstm_impl, score, "float32")
        searcher = make_beam_searcher(
            load(cfg, params, dev), cfg.e2e,
            dataclasses.replace(bcfg, prefix_impl=prefix))
        reset_counts()
        out[tag] = searcher(wav, lens)
        if tag == "kernel":
            launched = launched_now()
            print(f"  float32 kernel path launches {launched}")
            require(launched.get("blstm_infer_row_tiled") == n_layers,
                    f"phase 23: float32 BLSTM launches {launched}")
    rel, same = compare_results(out["kernel"], out["plain"],
                                "phase 23 float32")
    print(f"  float32 B={REF_PARITY}: best-score max rel diff {rel:.3e} "
          f"(limit 1e-3); best hypotheses token-identical {same}/"
          f"{REF_PARITY} (any other a near tie)")
    require(rel <= 1e-3, "phase 23: the kernel and plain paths disagree")


def reference_row_1a(jcfg, dev) -> dict:
    """Phase 23 (3): row 1a at every inference BLSTM layer of the reference
    model (H=512, bfloat16): the decode's five at B=64 (enhancer layers 0
    and 1 at T=279, encoder layers 0-2 at T=70) and the D-step's two at
    B=32. At each, the plan must take the cluster route (clusters of 16
    blocks); the cluster route (run twice: bit-identical), the row-tiled
    route and cuDNN's LSTM from x are timed in turns, both routes held
    against the plain version within 2e-2 max|plain| and the cluster route
    against the row-tiled one, and the cluster route must be the faster.
    Returns each layer's entry of the cluster route."""
    enc, enh = jcfg.e2e.encoder, jcfg.enhancer
    t_enh = num_frames(adversarial_benefit.PAD_TO, jcfg.e2e.frontend)
    t_enc = subsampled_frames(t_enh)
    d_vgg = subsampled_frames(enc.input_dim) * enc.vgg_channels[-1]
    enhancer = [("enhancer0", t_enh, enh.input_dim, enh.hidden_dim),
                ("enhancer1", t_enh, 2 * enh.hidden_dim, enh.hidden_dim)]
    layers = [(REF_DECODE, *lay) for lay in enhancer + [
        ("encoder0", t_enc, d_vgg, enc.hidden_dim),
        ("encoder1", t_enc, enc.proj_dim, enc.hidden_dim),
        ("encoder2", t_enc, enc.proj_dim, enc.hidden_dim)]]
    layers += [(REF_TCFG["batch_size"], f"D-step {tag}", t, d, h)
               for tag, t, d, h in enhancer]
    dt = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    print(f"  (3) row 1a at the reference model's layers, bf16 ({card()}):")
    rows = {}
    for b, tag, t, d, h in layers:
        x, wx, wh, bias, lengths, _ = train_inputs(gen, b, t, d, h, dt, dev)
        x = x.to(dt)
        plan = blstm.card_infer_route(b, d, h, dt, dev.index or 0)
        require(plan is not None,
                f"phase 23: the cluster plan does not fit {tag} B={b} D={d}")

        def kernel(x=x, wx=wx, wh=wh, bias=bias, lengths=lengths):
            return blstm.blstm_infer(x, lengths, wx, wh, bias)

        def plain(x=x, wx=wx, wh=wh, bias=bias, lengths=lengths):
            return blstm.blstm_infer_plain(x, lengths, wx, wh, bias)

        want = plain()
        reset_counts()
        got = [kernel(), kernel()]
        launched = dict(blstm.INFER_ROUTE_LAUNCHES)
        tiled = on_infer_route("row_tiled", kernel)()
        name = f"{tag} B={b} T={t} D={d} H={h} {dt}"
        err, ok = compare(f"blstm_infer cluster {name}", got[:1], [want],
                          scale_atol=2e-2)
        err_t, ok_t = compare(f"blstm_infer row_tiled {name}", [tiled],
                              [want], scale_atol=2e-2)
        _, ok_a = compare("    cluster vs row_tiled", got[:1], [tiled],
                          scale_atol=2e-2)
        same = torch.equal(got[0], got[1])
        print(f"    plan (C, R, F, W_x resident, shared memory bytes) "
              f"{plan}; launches {launched}; rerun bit-identical {same}")
        require(ok and ok_t and ok_a and same
                and launched == {"cluster": 2, "row_tiled": 0},
                f"phase 23: row 1a at {name}")
        ms = cuda_ms_in_turns(
            [kernel, on_infer_route("row_tiled", kernel),
             lstm_library_fn(x, lengths, h, train=False)], 3)
        print(f"    {tag} (valid frames {int(lengths.sum())}), ms in turns: "
              f"cluster {ms[0]:.3f}, row-tiled {ms[1]:.3f}, cuDNN "
              f"{ms[2]:.3f}")
        require(ms[0] < ms[1], f"phase 23: the cluster route is not faster "
                f"than the row-tiled one at {name}")
        flops = 2 * int(lengths.sum()) * 2 * 4 * h * (d + h)
        moved = nbytes(x, wx, wh, bias, lengths, want)
        rows[f"{tag} B={b}"] = entry(
            f"blstm_infer H=512 {tag} B={b}", err, ms[0], cuda_ms(plain, 1),
            flops, moved, dt, ms[2])
        entry(f"blstm_infer_row_tiled H=512 {tag} B={b}", err_t, ms[1],
              rows[f"{tag} B={b}"]["plain_ms"], flops, moved, dt, ms[2])
    return rows


def stream_digest(batch) -> str:
    digest = hashlib.sha256()
    for k in sorted(batch):
        digest.update(batch[k].tobytes())
    return digest.hexdigest()


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def reference_resume(dev, work) -> None:
    """Phase 23 (4): ``tools/adversarial_benefit.py::main`` at the
    reference scale (``REF_RESUME``) uncut, then cut before global step
    ``REF_CUT`` in another checkpoint dir and run again there: the
    restored state bit-equal to the state at its save, the resumed stream
    bit-equal to the uncut run's, the decoded stage reused, every summary
    key present."""
    def run(ckpt_dir, cut=None, resumed=False):
        seen, snap = {}, {}

        def hook(gstep, batch, state):
            if gstep == cut or (resumed and not snap):
                snap[gstep] = ckpt_lib.host_snapshot(state.state_dict())
            if gstep == cut:
                raise Cut
            seen[gstep] = stream_digest(batch)

        t0 = time.perf_counter()
        try:
            out = adversarial_benefit.main(device=dev, ckpt_dir=ckpt_dir,
                                           step_hook=hook, **REF_RESUME)
        except Cut:
            out = None
        return out, seen, snap, time.perf_counter() - t0

    uncut, useen, _, us = run(os.path.join(work, "ref_uncut"))
    cut_dir = os.path.join(work, "ref_cut")
    _, _, cut_snap, cs = run(cut_dir, cut=REF_CUT)
    resumed, rseen, rsnap, rs = run(cut_dir, resumed=True)
    require(ckpt_lib.read_extra(cut_dir)["global_step"] == 8,
            "phase 23: the resumed run's last save")
    restored = same_tree(cut_snap[REF_CUT], rsnap[REF_CUT])
    stream_same = sorted(rseen) == list(range(REF_CUT, 10)) and all(
        rseen[g] == useen[g] for g in rseen)
    keys = [k for k in BENEFIT_KEYS if k not in ("noisy_wer_joint_plus_lm",
                                                 "lm_ppl")] + ["resume"]
    missing = [k for k in keys if k not in resumed]
    rates = {k: (uncut[k], resumed[k]) for k in (
        "noisy_wer_no_enhancement", "noisy_wer_cascade_enhancement",
        "noisy_wer_joint_adversarial", "token_error_rates")}
    print(f"  (4) --scale reference {REF_RESUME['steps_a']} "
          f"{REF_RESUME['steps_c']}, --save-every {REF_RESUME['save_every']}"
          f": uncut {us:.1f} s, cut before global step {REF_CUT} {cs:.1f} s, "
          f"resumed {rs:.1f} s; restored state bit-equal to its save "
          f"{restored}; resumed stream bit-equal {stream_same}; stages "
          f"reused {resumed['resume']['stages_reused']}; steps run "
          f"{resumed['resume']['steps_run']}")
    for k, (a, b) in rates.items():
        print(f"    {k}: uncut {a}, resumed {b}")
    print(f"    rates bit-equal: {all(a == b for a, b in rates.values())}; "
          f"routes {json.dumps(resumed['routes'])}")
    require(restored, "phase 23: the restored state differs from its save")
    require(stream_same, "phase 23: the resumed stream differs")
    require(resumed["resume"]["stages_reused"] == ["noisy_raw"],
            f"phase 23: stages reused {resumed['resume']}")
    require(not missing, f"phase 23: the summary lacks {missing}")
    require(all(np.isfinite(adversarial_benefit.finite_wers(resumed))),
            "phase 23: a rate is not finite")
    require("not_run" not in resumed["routes"]["blstm cluster"]
            and resumed["routes"]["default"]["launches"].get(
                "blstm_infer/cluster"),
            f"phase 23: route gates {resumed['routes']}")


def reference_kernel_parity(jcfg, dev) -> None:
    """Phase 23 (5): the kernels of the reference model's training and
    decode against their plain versions at its widths, bfloat16: the
    training BLSTM (forward and every gradient, so ``gemm.cu``'s products
    too) at the enhancer's and the encoder's layer 0 at B=32, on the route
    its plan gives (resident); the CTC loss and its gradient at V=32 in
    both dtypes; the attention step's utt route at A=512 at the decode's
    B=64. Phase 3's limits."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    f32, bf16 = torch.float32, torch.bfloat16
    b = REF_TCFG["batch_size"]
    enc, acfg = jcfg.e2e.encoder, jcfg.e2e.attention
    t_enh = num_frames(adversarial_benefit.PAD_TO, jcfg.e2e.frontend)
    t_enc = subsampled_frames(t_enh)
    d_enc = subsampled_frames(enc.input_dim) * enc.vgg_channels[-1]
    out_tol, g_tol = grad_tols(bf16)
    ok_all = True
    for tag, t, d, h in (("enhancer0", t_enh, jcfg.enhancer.input_dim,
                          jcfg.enhancer.hidden_dim),
                         ("encoder0", t_enc, d_enc, enc.hidden_dim)):
        x, wx, wh, bias, lengths, dy = train_inputs(gen, b, t, d, h, bf16,
                                                    dev)

        def run(fn, x=x, wx=wx, wh=wh, bias=bias, lengths=lengths, dy=dy):
            return with_grads(lambda *a: fn(a[0], lengths, *a[1:]),
                              [x, wx, wh, bias], dy)

        want = run(blstm_train.blstm_train_plain)
        reset_counts()
        got = run(blstm_train.blstm_train)
        require_resident(f"phase 23 {tag}")
        gemm_routes = dict(blstm_train.GEMM_ROUTE_LAUNCHES)
        require(gemm_routes["simt"] == 0 and gemm_routes["tc"] > 0,
                f"phase 23 {tag}: products by route {gemm_routes}")
        for name, g, w in zip(("y", "dx", "dwx", "dwh", "dbias"), got, want):
            ok_all &= compare(
                f"blstm_train resident {tag} {name} B={b} T={t} D={d} H={h} "
                f"{bf16}", [g], [w], **(out_tol if name == "y" else g_tol))[1]

    v, s_len = adversarial_benefit.VOCAB, adversarial_benefit.SCFG.max_label_len
    logits = 3 * torch.randn((b, t_enc, v), generator=gen, device=dev)
    labels = torch.randint(2, v, (b, s_len), generator=gen, device=dev)
    label_lengths = torch.randint(s_len // 2, s_len + 1, (b,), generator=gen,
                                  device=dev)
    logit_lengths = torch.randint(t_enc - 12, t_enc + 1, (b,), generator=gen,
                                  device=dev)

    def run_ctc(impl, lg):
        lg = lg.detach().requires_grad_()
        loss = ctc.ctc_loss(lg, logit_lengths, labels, label_lengths,
                            impl=impl, reduction="none")
        return [loss, torch.autograd.grad(loss.sum(), lg)[0]]

    for dt in (f32, bf16):
        reset_counts()
        got = run_ctc("auto", logits.to(dt))
        require(launch_count("ctc_nll") == 2,
                f"phase 23: ctc_nll launched {launch_count('ctc_nll')} times")
        ok_all &= compare(
            f"ctc_nll loss+grad B={b} T={t_enc} S={s_len} V={v} {dt}", got,
            run_ctc("scan", logits.to(dt)),
            **(dict(atol=1e-4) if dt == f32 else dict(scale_atol=2e-2)))[1]

    beam = adversarial_benefit.beam_config(adversarial_benefit.SCFG).beam_size
    args = att_inputs(gen, REF_DECODE, beam, t_enc, acfg.conv_channels,
                      acfg.dim, enc.proj_dim, bf16, dev)
    reset_counts()
    got = on_att_route("utt", att.att_loc_step)(*args, acfg.sharpening)
    require_utt_attention("phase 23", 1)
    ok_all &= compare(
        f"att_loc_step utt B={REF_DECODE} K={beam} T={t_enc} "
        f"C={acfg.conv_channels} A={acfg.dim} E={enc.proj_dim} {bf16}", got,
        att.att_loc_step_plain(*args, acfg.sharpening), scale_atol=2e-2)[1]
    print("  (5) the training BLSTM, the CTC loss and the utt attention at "
          "the reference widths against their plain versions")
    require(ok_all, "phase 23: a kernel disagrees with its plain version at "
            "the reference widths")


def reference_phase(dev, work) -> None:
    """Phase 23: the reference-scale model through the kernels."""
    jcfg = verify_drive.kernel_config(adversarial_benefit.jcfg_for(
        "reference"))
    tcfg = dataclasses.replace(adversarial_benefit.TCFG, **REF_TCFG)
    t0 = time.perf_counter()
    state = train_loop.init_state(jcfg, tcfg, dev)
    n = sum(p.numel() for p in state.model.parameters())
    print(f"  reference model: {n / 1e6:.1f} M parameters, bf16 compute; "
          f"init {time.perf_counter() - t0:.1f} s")
    stream = adversarial_benefit.Stream(adversarial_benefit.SCFG)
    rng = np.random.default_rng(0)
    t = [time.perf_counter()]
    reference_steps(jcfg, state, stream, rng, dev)
    t.append(time.perf_counter())
    reference_decode(jcfg, state.model.state_dict(), dev)
    t.append(time.perf_counter())
    del state
    reference_row_1a(jcfg, dev)
    t.append(time.perf_counter())
    reference_resume(dev, work)
    t.append(time.perf_counter())
    reference_kernel_parity(jcfg, dev)
    t.append(time.perf_counter())
    print("  phase 23 by part: " + ", ".join(
        f"({i + 1}) {b - a:.1f} s" for i, (a, b) in enumerate(zip(t, t[1:]))))


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 1
    print(card())
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    print(f"build: {build():.1f} s")
    host_build_s = native.build()
    print(f"host library (csrc/host, {native.compiler_version()}): "
          f"{host_build_s:.2f} s")

    jcfg = flagship_config(VOCAB)
    # make_batch pads every batch to SYNTH.max_samples
    t_enh = num_frames(SYNTH.max_samples, jcfg.e2e.frontend)
    t_enc = subsampled_frames(t_enh)

    # 3. kernel parity
    print("kernel parity (kernel vs plain version on the card):")
    timings = kernel_parity(BATCH, t_enh, t_enc, jcfg, dev)
    oversize_blstm(dev)
    t_train = num_frames(TRAIN_SYNTH.max_samples, jcfg.e2e.frontend)
    train_timings, alpha_launches = train_kernel_parity(
        jcfg, t_train, subsampled_frames(t_train), dev)
    timings.update(train_timings)
    timings.update(gemm_products(jcfg, t_train, subsampled_frames(t_train),
                                 dev))
    clean_timings, bwd_launches = clean_kernel_parity(jcfg, dev)
    timings.update(clean_timings)

    # 4. main path
    state = from_flax(init_params(jcfg, seed=0))
    print("main path (flagship, bfloat16 compute, beam 8, 48 steps):")
    launches, phase4_ms = main_path(BATCH, N_BATCHES, state, dev)

    # 5. slice parity
    print("slice parity (kernel path vs plain path):")
    slice_parity(state, dev)

    # 6. train step
    state_d = from_flax(init_disc_params(jcfg.discriminator, seed=1))
    print("train step (flagship, bfloat16 compute, joint D/G, Adadelta):")
    train_launches = train_path(state, state_d, dev)
    launches.update({n: train_launches[n] for n in ("blstm_train",
                                                     "ctc_nll", "gemm")})
    # no path runs the backward of the fused frontend or the bare alpha
    # recursion: phase 3's launches
    launches["fbank_fused_bwd"] = bwd_launches
    launches["ctc_alpha"] = alpha_launches

    # 7-23, in a scratch dir: phases 12 and 20 read phase 7's experiment
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches.update(later_phases(state, state_d, dev, work, phase4_ms,
                                     host_build_s))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = [
        dict(name=n, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launches[n], **timings[n])
        for n, k in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def later_phases(state, state_d, dev, work, phase4_ms, host_build_s) -> dict:
    """Phases 7-23; returns the launches of the kernels phases 7-15
    hold."""
    # 7. entry point
    print("train CLI (--mode joint --synthetic, default model, float32):")
    ckpt = os.path.join(work, "joint")
    cli_launches = cli_path(ckpt)

    # 8. train-slice parity
    print("train-slice parity (float32 B=16, kernel vs plain step):")
    train_slice_parity(state, state_d, dev)

    # 9. clean-speech serving
    print("clean-speech serving (flagship, fused frontend, no enhancer, "
          "RNNLM fusion, bfloat16 compute, beam 8, 48 steps):")
    clean_launches = clean_path(BATCH, N_BATCHES, state, dev)

    # 10. its slice parity
    print("clean-speech slice parity (float32 B=16, kernel vs plain path):")
    clean_slice_parity(state, dev)

    # 11. the clean-speech recipe through its entry points
    print("clean-speech recipe (train.cli --mode asr --fused-frontend, "
          "--mode lm, restore, decode with LM fusion):")
    clean_recipe(dev)

    # 12. the decode CLI
    print("decode CLI (phase 7's experiment, --serving-impls fused vs xla, "
          f"B={BATCH}, beam {BEAM}, {STEPS} steps, no early exit):")
    dec_launches = decode_cli_path(ckpt, work)

    # 13. the fused-step A/B
    print("fused decoder step A/B (phase 4's traffic, bfloat16):")
    fused_launches = fused_step_ab(BATCH, N_BATCHES, state, dev, phase4_ms)

    # 14. the per-utterance prefix search
    print("per-utterance CTC prefix search (phase 4's traffic, "
          "prefix_impl=pallas):")
    utt_launches = utt_prefix_path(BATCH, N_BATCHES, state, dev)

    # 15. serving with the wide encoder
    print(f"wide-encoder serving (phase 4's traffic, encoder 3 x {WIDE} "
          "BLSTMP, float32):")
    wide_launches = wide_encoder_path(BATCH, N_BATCHES, dev)

    # 16. the verify drive
    print(f"verify drive (tools/verify_drive.py, {DRIVE_STEPS} joint steps "
          "B=16 float32, then the bf16 token gates):")
    t0 = time.perf_counter()
    drive_phase(dev)
    print(f"  phase 16: {time.perf_counter() - t0:.1f} s")

    # 17. the corpus recipe
    print("corpus recipe (train.cli on a manifest + resume, --mode lm, "
          "enhance_cli, decode.cli with the LM, score_cli):")
    t0 = time.perf_counter()
    corpus_recipe(work)
    print(f"  phase 17: {time.perf_counter() - t0:.1f} s")

    # 18. the paper-claim protocols
    print("paper-claim protocols (tools/adversarial_benefit.py 20 20 --lm, "
          "tools/lm_benefit.py 20 20; the hard task):")
    t0 = time.perf_counter()
    benefit_phase(dev)
    print(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    # 19. the Kaldi and precomputed-feature inputs
    print("Kaldi and precomputed-feature inputs (log-mel and log spectra "
          "against the waveform path, a spec joint step, spec serving, the "
          "Kaldi recipe through python -m robust_e2e_gan_torch):")
    t0 = time.perf_counter()
    kaldi_phase(state, state_d, dev, work)
    print(f"  phase 19: {time.perf_counter() - t0:.1f} s")

    # 20. the attention variants and model interchange
    print("attention variants and model interchange (AttAdd and AttDot "
          "serving, the reference import with --units, phase 7's "
          "experiment in the JAX layout, the asynchronous saver):")
    t0 = time.perf_counter()
    interchange_phase(state, state_d, dev, work, ckpt)
    print(f"  phase 20: {time.perf_counter() - t0:.1f} s")

    # 21. data parallelism
    print("data parallelism (two gloo ranks on card 0 against one process: "
          f"{DP_STEPS} float32 joint steps and a decode; a world-1 NCCL step; "
          "the Prefetcher on phase 7's traffic):")
    t0 = time.perf_counter()
    dp_phase(state, state_d, dev, work)
    print(f"  phase 21: {time.perf_counter() - t0:.1f} s")

    # 22. the host-side overlap
    print("host-side overlap (the C++ loaders and scorer against numpy and "
          "Python; the staged decode against the sequential one; "
          "decode.cli --pipelined on):")
    t0 = time.perf_counter()
    host_overlap_phase(state, dev, work, ckpt, host_build_s)
    print(f"  phase 22: {time.perf_counter() - t0:.1f} s")

    # 23. the paper-claim protocol at the reference scale
    print("paper-claim protocol at the reference scale (36.3 M parameters, "
          "bf16: joint steps, a decode, row 1a at H=512, a cut and "
          "resumed run of tools/adversarial_benefit.py):")
    t0 = time.perf_counter()
    reference_phase(dev, work)
    print(f"  phase 23: {time.perf_counter() - t0:.1f} s")

    return {"blstm_train_gx": cli_launches["blstm_train_gx"],
            "fbank_fused": clean_launches["fbank_fused"],
            "lm_step": clean_launches["lm_step"],
            "lm_step_lane": clean_launches["lm_step_lane"],
            "att_dec_step": dec_launches["att_dec_step"],
            "att_dec_step_hyp": fused_launches["att_dec_step_hyp"],
            "blstm_infer_row_tiled": dec_launches["blstm_infer_row_tiled"],
            "ctc_prefix_utt": utt_launches["ctc_prefix_utt"],
            "blstm_recurrence": wide_launches["blstm_recurrence"],
            "blstm_recurrence_row_tiled":
                wide_launches["blstm_recurrence_row_tiled"]}


if __name__ == "__main__":
    sys.exit(main())
