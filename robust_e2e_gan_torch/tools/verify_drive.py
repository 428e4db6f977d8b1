"""The verify drive on the GPU: train the joint model, then gate its tokens.

    python -m robust_e2e_gan_torch.tools.verify_drive [steps]

(``steps`` 0 runs section 5 alone.) Port of ``scripts/verify_drive.py`` with the same constants (``JCFG``,
``SCFG``, ``TCFG``), run with the BLSTM layers on the kernels (the JAX
drive's ``lstm_impl="scan"`` is its XLA scan; ``kernel_config`` sets
``"auto"``, which takes the CUDA kernels on the card):

1. ``steps`` (500) joint adversarial steps at B=16 in float32 (Adam 1e-3,
   the random stream of ``default_rng(0)``), with the accuracy and losses
   every 100 steps and the ms per step (host clock, ending in a device
   synchronisation); gate: accuracy > 0.9;
2. one noisy eval batch of 16 through the enhancer: greedy CTC, the beam
   search (``BCFG``: beam 4, CTC weight 0.3, 10 steps) in float32 and the
   same parameters with bfloat16 compute; gates: greedy WER <= 0.05, beam
   <= greedy, bfloat16 beam within ``BF16_MARGIN`` (0.02) of float32;
3. the bfloat16 token gates: 128 further eval utterances (8 batches of 16
   from the same stream) decoded in bfloat16 on the default routes, then
   once with each of ``ROUTES``' changes (the fused decoder step, the
   per-utterance psi kernel, the inference BLSTM forced to its row-tiled
   and to its cluster route); gate: each WER within ``BF16_MARGIN`` of the
   default's; prints each route's token-identical share and, on the card,
   its launches by route, and requires each route's kernel to have run
   (the default's inference BLSTM on the route ``cluster_plan`` gives each
   layer); a forced route whose plan does not fit the model (the cluster
   route at H = 512) is not run and is reported with the plan's reason;
4. the probes: an enhanced utterance, an all-ignore ASR loss and an
   utterance shorter than one frame are finite;
5. ``drive_loop_and_data``: 8 ``.npy`` utterances through
   ``AudioTextDataset.from_jsonl`` and ``BucketBatcher`` into
   ``train/loop.py::train`` (Adadelta), one epoch, then a resume to two;
   gates: the step count doubles, a "best" checkpoint exists.

A failed gate raises ``DriveFailure``. ``main(watch=...)`` wraps each of
the five sections in ``watch(name)``, a context manager factory, with the
names "train", "decode", "routes", "probes" and "loop": ``chip_smoke.py``
uses it to check each section's kernel launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

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
    TrainConfig,
)
from robust_e2e_gan_torch.convert import from_flax, init_disc_params, init_params
from robust_e2e_gan_torch.data.dataset import AudioTextDataset, BucketBatcher
from robust_e2e_gan_torch.data.synthetic import (
    SyntheticConfig,
    make_batch,
    synth_utterance,
)
from robust_e2e_gan_torch.decode.beam import make_beam_searcher
from robust_e2e_gan_torch.models.enhancement import Discriminator
from robust_e2e_gan_torch.models.rnn import BLSTM
from robust_e2e_gan_torch.ops import blstm
from robust_e2e_gan_torch.ops.ctc import ctc_greedy_decode
from robust_e2e_gan_torch.ops.editdistance import wer_details
from robust_e2e_gan_torch.pipeline import build_model
from robust_e2e_gan_torch.train.loop import device_batch, resolve_device, train
from robust_e2e_gan_torch.train.steps import (
    init_train_state,
    make_joint_train_step,
)
from robust_e2e_gan_torch.utils import checkpoint as ckpt
from robust_e2e_gan_torch.utils import trace
from robust_e2e_gan_torch.utils.build import build

VOCAB = 12
JCFG = JointConfig(
    e2e=E2EConfig(
        frontend=FrontendConfig(n_mels=40),
        encoder=EncoderConfig(input_dim=40, vgg_channels=(8, 16), num_layers=1,
                              hidden_dim=64, proj_dim=64),
        attention=AttentionConfig(dim=48, conv_channels=8, conv_kernel=31),
        decoder=DecoderConfig(vocab_size=VOCAB, embed_dim=32, hidden_dim=64),
    ),
    enhancer=EnhancerConfig(input_dim=257, num_layers=1, hidden_dim=64),
    discriminator=DiscriminatorConfig(input_dim=40, channels=(8, 16)),
)
SCFG = SyntheticConfig(vocab_size=VOCAB, min_tokens=2, max_tokens=6,
                       noise_snr_db=5.0)
TCFG = TrainConfig(optimizer="adam", learning_rate=1e-3)
BCFG = BeamSearchConfig(beam_size=4, ctc_weight=0.3, max_steps=10)
BATCH = 16
# the route gates' utterances: batches of BATCH
ROUTE_BATCHES = 8
# the JAX drive's bfloat16 margin on a WER (verify_drive.py:123)
BF16_MARGIN = 0.02


class DriveFailure(RuntimeError):
    pass


def gate(cond: bool, msg: str) -> None:
    if not cond:
        raise DriveFailure(msg)


def kernel_config(jcfg: JointConfig) -> JointConfig:
    """``jcfg`` with its BLSTM layers on the kernels (``lstm_impl="auto"``)."""
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(e2e, encoder=dataclasses.replace(
            e2e.encoder, lstm_impl="auto")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))


def bf16_config(jcfg: JointConfig, step_impl: str = "auto") -> JointConfig:
    """``jcfg`` with bfloat16 compute and the decoder step ``step_impl``."""
    e2e = jcfg.e2e
    return dataclasses.replace(
        jcfg, compute_dtype="bfloat16",
        e2e=dataclasses.replace(e2e, decoder=dataclasses.replace(
            e2e.decoder, step_impl=step_impl)))


# name -> (decoder step_impl, prefix_impl, forced blstm_infer route or
# None, the route launches that must run, those that must not)
ROUTES = {
    "fused step": ("fused", "auto", None, ("att_dec_step/utt",),
                   ("att_loc_step/utt",)),
    "pallas prefix": ("auto", "pallas", None, ("ctc_prefix_utt",),
                      ("ctc_prefix_psi/utt",)),
    "blstm row_tiled": ("auto", "auto", "row_tiled",
                        ("blstm_infer/row_tiled",), ("blstm_infer/cluster",)),
    "blstm cluster": ("auto", "auto", "cluster", ("blstm_infer/cluster",),
                      ("blstm_infer/row_tiled",)),
}


def infer_layers(model, b: int) -> List[Tuple[int, int, torch.dtype]]:
    """(D, H, dtype) of each BLSTM layer of ``model`` that a decode of
    ``b`` rows runs in ``blstm_infer`` (the kernel path and ``ops/blstm.py::
    infer_kernel_for``'s W_x-resident choice), in module order."""
    return [(m.wx.shape[1], m.wh.shape[1], m.dtype)
            for m in model.modules() if isinstance(m, BLSTM) and m.use_kernel
            and blstm.infer_kernel_for(b, 1, m.wx.shape[1], m.wh.shape[1],
                                       m.dtype) == "fused"]


def cluster_fits(layers, b: int, dev: torch.device) -> Optional[List[bool]]:
    """Whether ``blstm_infer`` takes its cluster route at each of
    ``layers`` (``infer_layers``) in a decode of ``b`` rows on the card
    ``dev`` (``ops/blstm.py::card_infer_route``, the wrapper's own rule);
    None on the CPU, whose tensors take the plain version."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return [blstm.card_infer_route(b, d, h, dt, index) is not None
            for d, h, dt in layers]


def route_misfit(name: str, layers, fits: Optional[List[bool]], b: int
                 ) -> Optional[str]:
    """Why route ``name`` of ``ROUTES`` cannot run on a model whose
    inference BLSTM ``layers`` fit the cluster route as ``fits`` says at
    ``b`` rows, or None where it can: a forced "cluster" needs the plan to
    fit every layer (the wrapper raises where it does not)."""
    if ROUTES[name][2] != "cluster" or fits is None or all(fits):
        return None
    hs = sorted({h for (_, h, _), fit in zip(layers, fits) if not fit})
    return (f"ops/blstm.py::cluster_plan does not fit "
            f"H={', '.join(map(str, hs))} at B={b}")


def route_launches() -> Dict[str, int]:
    """Launches so far by kernel and route, ``utils/trace.py::counters``'
    ``route.<kernel>.<route>`` as ``<kernel>/<route>``, and of the
    per-utterance psi kernel (``ctc_prefix_utt``)."""
    counts = trace.counters()
    out = {k[len("route."):].replace(".", "/"): n
           for k, n in counts.items() if k.startswith("route.")}
    out["ctc_prefix_utt"] = counts["launch.prefix_psi_utt"]
    return out


def token_lists(tokens: torch.Tensor) -> List[List[int]]:
    return [[int(x) for x in row if x != -1] for row in tokens.cpu().numpy()]


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serving_model(jcfg: JointConfig, params, dev):
    """The model of ``jcfg`` with ``params`` (a state dict), for decoding."""
    model = build_model(jcfg)
    model.load_state_dict(params)
    return model.to(dev).eval()


def train_joint(jcfg, steps, rng, dev) -> dict:
    """Section 1: ``steps`` joint steps from fresh parameters (seeds 0 and
    1); the state and each logged step's metrics."""
    model = build_model(jcfg)
    model.load_state_dict(from_flax(init_params(jcfg, seed=0)))
    disc = Discriminator(jcfg.discriminator, model.dtype)
    disc.load_state_dict(from_flax(init_disc_params(jcfg.discriminator,
                                                    seed=1)))
    state = init_train_state(model.to(dev), disc.to(dev), TCFG, seed=0)
    step = make_joint_train_step(jcfg, with_asr=True)
    history = []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = step(state, device_batch(make_batch(BATCH, SCFG, rng), dev))
        if i % 100 == 0 or i == steps - 1:
            m = {k: float(metrics[k])
                 for k in ("acc", "loss_ctc", "loss_att", "loss_d")}
            history.append({"step": i, **m})
            print(f"step {i}: acc={m['acc']:.3f} ctc={m['loss_ctc']:.3f} "
                  f"att={m['loss_att']:.3f} d={m['loss_d']:.3f} "
                  f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.0f} "
                  "ms/step)", flush=True)
    synchronize(dev)
    ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    print(f"{steps} steps: {ms:.2f} ms/step (host clock, ending in a device "
          "synchronisation)")
    return {"state": state, "history": history, "ms_per_step": ms}


def decode_gates(jcfg, model, eval_b, dev) -> dict:
    """Section 2: greedy, beam and bfloat16 beam WERs on one eval batch."""
    wav = torch.from_numpy(eval_b["noisy_wav"]).to(dev)
    lens = torch.from_numpy(eval_b["wav_lengths"]).to(dev)
    refs = token_lists(torch.from_numpy(eval_b["labels"]))
    with torch.inference_mode():
        _, _, hlens, ctc_logits, _ = model.encode_for_decode(wav, lens, True)
        greedy = ctc_greedy_decode(ctc_logits, hlens, blank_id=0)
    wer_g = wer_details(refs, token_lists(greedy))
    print("greedy WER:", wer_g)
    res = make_beam_searcher(model, jcfg.e2e, BCFG, use_enhancer=True)(
        wav, lens)
    wer_b = wer_details(refs, token_lists(res.tokens))
    print("beam   WER:", wer_b)
    gate(wer_g["error_rate"] <= 0.05, f"greedy WER {wer_g}")
    gate(wer_b["error_rate"] <= wer_g["error_rate"] + 1e-9,
         f"beam WER {wer_b} above greedy {wer_g}")
    # the same float32 parameters with bfloat16 compute
    model_bf = serving_model(bf16_config(jcfg), model.state_dict(), dev)
    res_bf = make_beam_searcher(model_bf, jcfg.e2e, BCFG, use_enhancer=True)(
        wav, lens)
    wer_bf = wer_details(refs, token_lists(res_bf.tokens))
    print("beam   WER (bf16 compute):", wer_bf)
    gate(wer_bf["error_rate"] <= wer_b["error_rate"] + BF16_MARGIN,
         f"bf16 beam WER {wer_bf} beyond f32's {wer_b} + {BF16_MARGIN}")
    return {"greedy": wer_g["error_rate"], "beam": wer_b["error_rate"],
            "beam_bf16": wer_bf["error_rate"]}


def route_gates(jcfg, params, batches, dev, bcfg=BCFG) -> dict:
    """Section 3: the bfloat16 decode of ``batches`` with the beam config
    ``bcfg`` on the default routes and with each of ``ROUTES``' changes;
    each route's WER, token-identical share against the default and
    launches by route. On the card the default must launch the inference
    BLSTM routes the plans give its layers (``cluster_fits``) and no
    other, and a route whose plan does not fit the model
    (``route_misfit``) is not run and is reported as ``{"not_run":
    reason}``."""
    refs = [r for b in batches for r in token_lists(
        torch.from_numpy(b["labels"]))]
    inputs = [(torch.from_numpy(b["noisy_wav"]).to(dev),
               torch.from_numpy(b["wav_lengths"]).to(dev)) for b in batches]
    rows = max(b["noisy_wav"].shape[0] for b in batches)
    out = {}
    for name, (step_impl, prefix_impl, infer_route, ran, not_ran) in (
            ("default", ("auto", "auto", None, None, None)),
            *ROUTES.items()):
        if name != "default":
            misfit = route_misfit(name, layers, fits, rows)
            if misfit:
                out[name] = {"not_run": misfit}
                print(f"  {name}: not run: {misfit}")
                continue
        model = serving_model(bf16_config(jcfg, step_impl), params, dev)
        if name == "default":
            layers = infer_layers(model, rows)
            fits = cluster_fits(layers, rows, dev)
            plan = {"cluster" if fit else "row_tiled" for fit in fits or ()}
            ran = tuple(f"blstm_infer/{r}" for r in sorted(plan))
            not_ran = tuple(f"blstm_infer/{r}"
                            for r in blstm.INFER_ROUTE_LAUNCHES
                            if r not in plan)
        search = make_beam_searcher(
            model, jcfg.e2e,
            dataclasses.replace(bcfg, prefix_impl=prefix_impl),
            use_enhancer=True)
        before = route_launches()
        hyps = []
        for wav, lens in inputs:
            with (blstm._force_infer_route(infer_route) if infer_route
                  else contextlib.nullcontext()):
                hyps += token_lists(search(wav, lens).tokens)
        synchronize(dev)
        launches = {k: n - before[k] for k, n in route_launches().items()
                    if n != before[k]}
        wer = wer_details(refs, hyps)["error_rate"]
        same = (len(hyps) if name == "default" else
                sum(a == b for a, b in zip(hyps, out["default"]["hyps"])))
        out[name] = {"wer": wer, "identical": same, "n": len(hyps),
                     "launches": launches, "hyps": hyps}
        print(f"  {name}: WER {wer:.4f}, token-identical with the default "
              f"{same}/{len(hyps)}; launches by route {launches}")
        if dev.type == "cuda" and ran:
            gate(all(launches.get(k, 0) > 0 for k in ran)
                 and not any(launches.get(k, 0) for k in not_ran),
                 f"{name}: {ran} did not run alone: {launches}")
    for name in ROUTES:
        if "not_run" in out[name]:
            continue
        gate(abs(out[name]["wer"] - out["default"]["wer"]) <= BF16_MARGIN,
             f"{name}: WER {out[name]['wer']} beyond the bf16 default's "
             f"{out['default']['wer']} +- {BF16_MARGIN}")
    return {k: v if "not_run" in v else
            {f: v[f] for f in ("wer", "identical", "n", "launches")}
            for k, v in out.items()}


def probes(model, eval_b, dev) -> None:
    """Section 4: finite outputs at the edges."""
    wav = torch.from_numpy(eval_b["noisy_wav"]).to(dev)
    lens = torch.from_numpy(eval_b["wav_lengths"]).to(dev)
    labels = torch.from_numpy(eval_b["labels"]).to(dev)
    with torch.no_grad():
        e1, _, _ = model.enhance(wav[:1], lens[:1])
        gate(bool(torch.isfinite(e1).all()), "non-finite enhanced power")
        out = model.asr_forward(wav[:2], lens[:2],
                                torch.full_like(labels[:2], -1))
        gate(bool(torch.isfinite(out["loss"])), f"all-ignore loss {out}")
        short = torch.zeros((1, wav.shape[1]), device=dev)
        short_len = torch.tensor([300], dtype=torch.int32, device=dev)
        e2, _, _ = model.enhance(short, short_len)  # < one frame
        gate(bool(torch.isfinite(e2).all()), "non-finite short utterance")
    print("probes OK")


def main(steps: int = 500, device="cuda",
         watch: Optional[Callable[[str], contextlib.AbstractContextManager]]
         = None) -> dict:
    """The drive; returns its numbers (ms per step, the logged metrics,
    every WER, each route's WER, token-identical share and launches)."""
    watch = watch or (lambda name: contextlib.nullcontext())
    dev = resolve_device(device)
    if dev.type == "cuda":  # the kernels' build stays out of the timing
        print(f"build: {build():.1f} s")
    jcfg = kernel_config(JCFG)
    rng = np.random.default_rng(0)
    make_batch(BATCH, SCFG, rng)  # the JAX drive's init batch: its stream
    with watch("train"):
        trained = train_joint(jcfg, steps, rng, dev)
    acc = trained["history"][-1]["acc"]
    gate(acc > 0.9, f"training did not converge: acc={acc}")
    model = trained["state"].model.eval()

    eval_b = make_batch(BATCH, SCFG, rng)
    with watch("decode"):
        wers = decode_gates(jcfg, model, eval_b, dev)
    print(f"bf16 token gates ({ROUTE_BATCHES} x {BATCH} utterances):")
    batches = [make_batch(BATCH, SCFG, rng) for _ in range(ROUTE_BATCHES)]
    with watch("routes"):
        routes = route_gates(jcfg, model.state_dict(), batches, dev)
    with watch("probes"):
        probes(model, eval_b, dev)
    with watch("loop"):
        steps_run = drive_loop_and_data(device=dev)
    print("VERIFY PASS")
    return {"ms_per_step": trained["ms_per_step"],
            "history": trained["history"], "wer": wers, "routes": routes,
            "loop_steps": steps_run}


def drive_loop_and_data(device="cuda"):
    """Section 5: the dataset layer, the training loop and a checkpoint
    resume through the public API (``train/loop.py``,
    ``data/dataset.py``); returns the step counts of the two runs."""
    tmp = tempfile.mkdtemp(prefix="rg_verify_")
    try:
        rng = np.random.default_rng(0)
        alphabet = "abcdefghij"  # 10 chars -> ids 3..12 after specials
        entries = []
        for i in range(8):
            n_tok = int(rng.integers(2, 5))
            toks = rng.integers(2, VOCAB, size=(n_tok,)).astype(np.int32)
            clean, noisy = synth_utterance(toks, SCFG, rng)
            np.save(f"{tmp}/n{i}.npy", noisy)
            np.save(f"{tmp}/c{i}.npy", clean)
            entries.append({"utt_id": f"u{i}", "noisy": f"n{i}.npy",
                            "clean": f"c{i}.npy", "n_samples": len(clean),
                            "text": "".join(alphabet[t - 2] for t in toks)})
        with open(f"{tmp}/manifest.jsonl", "w") as f:
            f.write("\n".join(json.dumps(e) for e in entries))

        ds = AudioTextDataset.from_jsonl(f"{tmp}/manifest.jsonl")
        gate(3 < ds.tokenizer.vocab_size <= VOCAB + 1,  # specials + chars
             f"tokenizer vocab {ds.tokenizer.vocab_size}")

        def batches():
            return BucketBatcher(ds, batch_size=4,
                                 length_buckets=(SCFG.max_samples,),
                                 max_label_len=8).epoch(shuffle=False)

        # the tokenizer's vocabulary (<unk> included) sizes the decoder
        jcfg = kernel_config(JCFG)
        jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(
            jcfg.e2e, decoder=dataclasses.replace(
                jcfg.e2e.decoder, vocab_size=ds.tokenizer.vocab_size)))
        runs = []
        for epochs in (1, 2):  # the second run resumes the first
            tcfg = TrainConfig(optimizer="adadelta", learning_rate=1.0,
                               num_epochs=epochs, checkpoint_dir=f"{tmp}/ck",
                               log_every=2)
            state = train(jcfg, tcfg, batches, dev_batches=batches,
                          mode="joint", log_dir=f"{tmp}/logs", device=device)
            runs.append(state.step)
            if epochs == 1:
                gate(ckpt.has_checkpoint(tcfg.checkpoint_dir, "best"),
                     "no 'best' checkpoint after one epoch")
        gate(runs[1] == 2 * runs[0], f"resume step counts {runs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("loop+data+checkpoint drive OK")
    return runs


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    if n == 0:  # the data, loop and checkpoint section alone
        drive_loop_and_data()
        print("VERIFY PASS (loop/data only)")
    else:
        main(n)
