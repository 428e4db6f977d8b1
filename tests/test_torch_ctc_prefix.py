"""The port's CTC prefix scoring against the JAX package: the twopass XLA
forms (``batched_prefix_psi``, ``prefix_state_for_token``), the tiled
Pallas kernels and the per-utterance psi kernel (interpret mode); the
state of a beam step's survivors (``prefix_state_step``) and the twopass
searcher; the CUDA route plans as integer arithmetic."""

import dataclasses
import functools
import os
import re

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.decode.beam import (  # noqa: E402
    batched_prefix_psi,
    prefix_state_for_token,
)
from robust_e2e_gan_tpu.decode.beam import (  # noqa: E402
    beam_search_from_encoder as jax_beam_search_from_encoder,
)
from robust_e2e_gan_tpu.ops.ctc_prefix_pallas import (  # noqa: E402
    prefix_scores_psi_pallas,
)
from robust_e2e_gan_tpu.ops.ctc_prefix_tiled import (  # noqa: E402
    prefix_psi_tiled,
    prefix_state_tiled,
)
from robust_e2e_gan_torch.config import BeamSearchConfig  # noqa: E402
from robust_e2e_gan_torch.configs import tiny_config  # noqa: E402
from robust_e2e_gan_torch.decode.beam import beam_search_from_encoder  # noqa: E402
from robust_e2e_gan_torch.ops import ctc_prefix as ops  # noqa: E402

BLANK, EOS = 0, 1
# log-space sums over T frames: values reach tens of nats, so compare at
# 1e-3 absolute (a few float32 ulps of the largest partial sums)
ATOL = 1e-3


def _state(seed, b=2, k=3, t=13, v=7):
    """Masked CTC log-probs and plausible parent states: the forward
    variables of random prefixes, built by running the JAX recursion."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    lpz = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    hl = np.array([t, t - 4][:b])
    lpz[1, hl[1]:] = -1e10
    lpz[1, hl[1]:, BLANK] = 0.0
    r_b = np.broadcast_to(np.cumsum(lpz[:, :, BLANK], 1)[:, None],
                          (b, k, t)).copy()
    r_n = np.full((b, k, t), -1e10, np.float32)
    last = np.full((b, k), EOS, np.int32)
    lens = np.zeros((b, k), np.int32)
    for _ in range(2):  # extend some lanes twice, with repeats
        tok = rng.integers(2, v, (b, k)).astype(np.int32)
        tok[0, 0] = last[0, 0] if lens[0, 0] else tok[0, 0]
        grow = rng.random((b, k)) < 0.7
        rn_s, rb_s = prefix_state_for_token(
            jnp.asarray(lpz), jnp.asarray(tok), jnp.asarray(last),
            jnp.asarray(lens), jnp.asarray(r_n), jnp.asarray(r_b), BLANK)
        r_n = np.where(grow[..., None], np.asarray(rn_s), r_n)
        r_b = np.where(grow[..., None], np.asarray(rb_s), r_b)
        last = np.where(grow, tok, last)
        lens = lens + grow
    tok = rng.integers(2, v, (b, k)).astype(np.int32)
    tok[1, -1] = last[1, -1]  # a repeated token
    return dict(lpz=lpz, last=last, lens=lens.astype(np.int32),
                r_n=r_n.astype(np.float32), r_b=r_b.astype(np.float32), tok=tok)


@pytest.mark.parametrize("seed", [0, 1])
def test_psi_matches_jax_twopass_and_tiled_kernel(seed):
    s = _state(seed)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = batched_prefix_psi(j["lpz"], j["last"], j["lens"], j["r_n"],
                              j["r_b"], BLANK, EOS)
    want_kernel = prefix_psi_tiled(j["lpz"], j["last"], j["lens"], j["r_n"],
                                   j["r_b"], BLANK, EOS, interpret=True)
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    for fn in (ops.prefix_psi_plain, ops.prefix_psi):
        got = fn(t_["lpz"], t_["last"], t_["lens"], t_["r_n"], t_["r_b"],
                 BLANK, EOS).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_state_matches_jax_twopass_and_tiled_kernel(seed):
    s = _state(seed)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = prefix_state_for_token(j["lpz"], j["tok"], j["last"], j["lens"],
                                  j["r_n"], j["r_b"], BLANK)
    want_kernel = prefix_state_tiled(j["lpz"], j["tok"], j["last"], j["lens"],
                                     j["r_n"], j["r_b"], BLANK, interpret=True)
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    for fn in (ops.prefix_state_plain, ops.prefix_state):
        got = fn(t_["lpz"], t_["tok"], t_["last"], t_["lens"], t_["r_n"],
                 t_["r_b"], BLANK)
        for g, w, wk in zip(got, want, want_kernel):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=0,
                                       atol=ATOL)


def test_wrappers_take_plain_versions_on_cpu():
    s = {n: torch.from_numpy(np.ascontiguousarray(a))
         for n, a in _state(2).items()}
    before = (ops.prefix_psi.launches, ops.prefix_state.launches,
              ops.prefix_psi_recursion_plain.calls,
              ops.prefix_state_plain.calls)
    ops.prefix_psi(s["lpz"], s["last"], s["lens"], s["r_n"], s["r_b"],
                   BLANK, EOS)
    ops.prefix_state(s["lpz"], s["tok"], s["last"], s["lens"], s["r_n"],
                     s["r_b"], BLANK)
    after = (ops.prefix_psi.launches, ops.prefix_state.launches,
             ops.prefix_psi_recursion_plain.calls,
             ops.prefix_state_plain.calls)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_psi_utt_matches_jax_per_utterance_kernel(seed):
    """``prefix_psi_utt`` (on the CPU, its plain version
    ``prefix_psi_plain``) against ``prefix_scores_psi_pallas``, eos and
    blank columns included."""
    s = _state(seed, b=3, k=4, t=17, v=9)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = prefix_scores_psi_pallas(j["lpz"], j["last"], j["lens"], j["r_n"],
                                    j["r_b"], BLANK, EOS, interpret=True)
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    before = (ops.prefix_psi_utt.launches,
              ops.prefix_psi_recursion_plain.calls)
    got = ops.prefix_psi_utt(t_["lpz"], t_["last"], t_["lens"], t_["r_n"],
                             t_["r_b"], BLANK, EOS).numpy()
    assert (ops.prefix_psi_utt.launches,
            ops.prefix_psi_recursion_plain.calls) == (before[0],
                                                      before[1] + 1)
    # the same float32 log-space sums, in the same frame order
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert (got[..., BLANK] == -1e10).all()


def _take(x, k_idx):
    """Rows of x (B, K, ...) picked by k_idx (B, K), in numpy."""
    idx = k_idx.reshape(k_idx.shape + (1,) * (x.ndim - 2))
    return np.take_along_axis(x, idx, axis=1)


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 3), (2, 1)])
def test_state_step_matches_jax_gather_tiled_kernel_select(seed, k):
    """``prefix_state_step`` (on the CPU, its plain version) against the
    JAX searcher's sequence around the tiled state kernel (interpret
    mode): parents gathered by k_idx, the kernel, the parents' rows kept
    where nothing is appended. Lanes with append false, a repeated token
    and an empty parent prefix; K=1."""
    s = _state(seed, k=k)
    rng = np.random.default_rng(10 + seed)
    b = s["lpz"].shape[0]
    k_idx = rng.integers(0, k, (b, k))
    append = rng.random((b, k)) < 0.6
    append[0, 0], append[1, -1] = False, True
    s["lens"][1, k_idx[1, -1]] = 0  # an empty parent that is extended
    tok = s["tok"]
    tok[0, -1] = _take(s["last"], k_idx)[0, -1]  # a repeated token
    rn_par, rb_par = _take(s["r_n"], k_idx), _take(s["r_b"], k_idx)
    rn_sel, rb_sel = prefix_state_tiled(
        jnp.asarray(s["lpz"]), jnp.asarray(tok),
        jnp.asarray(_take(s["last"], k_idx)),
        jnp.asarray(_take(s["lens"], k_idx)), jnp.asarray(rn_par),
        jnp.asarray(rb_par), BLANK, interpret=True)
    want = (np.where(append[..., None], np.asarray(rn_sel), rn_par),
            np.where(append[..., None], np.asarray(rb_sel), rb_par))
    t_ = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in s.items()}
    args = (t_["lpz"], torch.from_numpy(k_idx), t_["tok"],
            torch.from_numpy(append), t_["last"], t_["lens"], t_["r_n"],
            t_["r_b"], BLANK)
    before = (ops.prefix_state_step.launches, ops.prefix_state_plain.calls)
    for fn in (ops.prefix_state_step_plain, ops.prefix_state_step):
        got = fn(*args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    assert (ops.prefix_state_step.launches,
            ops.prefix_state_plain.calls) == (before[0], before[1] + 2)
    # rows with nothing appended are their parents' exactly
    np.testing.assert_array_equal(got[0].numpy()[~append], rn_par[~append])


def _toy_decoder(v, seed):
    """A decoder step of the searchers' signature from numpy weights:
    carry c (N, V), c' = tanh(c U + W[tokens]), logits 3 c'; one function
    for each framework."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((v, v)).astype(np.float32)
    u = (rng.standard_normal((v, v)) / np.sqrt(v)).astype(np.float32)

    def jax_step(carry, tokens, enc, enc_proj, enc_mask):
        c = jnp.tanh(carry[0] @ jnp.asarray(u) + jnp.asarray(w)[tokens])
        return (c,), (3.0 * c, jnp.zeros((c.shape[0], enc.shape[1])))

    def torch_step(carry, tokens, enc, enc_proj, enc_mask):
        c = torch.tanh(carry[0] @ torch.from_numpy(u)
                       + torch.from_numpy(w)[tokens.long()])
        return (c,), (3.0 * c, torch.zeros((c.shape[0], enc.shape[1])))

    return ((jax_step, lambda n, mask: (jnp.zeros((n, v)),)),
            (torch_step, lambda n, mask: (torch.zeros((n, v)),)))


@pytest.mark.parametrize("prefix_impl", ["twopass", "auto"])
def test_twopass_searcher_matches_jax(prefix_impl):
    """The searcher's CTC prefix path (``prefix_state_step`` after the
    pruning) against the JAX searcher over one toy decoder and random CTC
    logits with ragged lengths: token-exact, scores to float32 ulps. On
    the CPU "auto" runs the wrappers' plain versions, as JAX's "auto"
    runs twopass."""
    b, t, v = 3, 20, 12
    ecfg = tiny_config(v).e2e
    bcfg = BeamSearchConfig(beam_size=3, ctc_weight=0.5, max_steps=8,
                            early_exit=False, prefix_impl=prefix_impl)
    rng = np.random.default_rng(5)
    ctc_logits = (2 * rng.standard_normal((b, t, v))).astype(np.float32)
    hlens = np.array([t, 13, 6], np.int32)
    mask = (np.arange(t)[None] < hlens[:, None]).astype(np.float32)
    enc = np.zeros((b, t, 4), np.float32)
    (jstep, jinit), (tstep, tinit) = _toy_decoder(v, 6)

    def jax_cfg(cfg):
        return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                    dataclasses.asdict(cfg))

    want = jax_beam_search_from_encoder(
        jstep, jinit, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(hlens),
        jnp.asarray(enc), jnp.asarray(ctc_logits), jax_cfg(ecfg),
        jax_cfg(bcfg))
    calls = ops.prefix_state_plain.calls
    got = beam_search_from_encoder(
        tstep, tinit, torch.from_numpy(enc), torch.from_numpy(mask),
        torch.from_numpy(hlens), torch.from_numpy(enc),
        torch.from_numpy(ctc_logits), ecfg, bcfg)
    assert ops.prefix_state_plain.calls == calls + bcfg.max_steps
    np.testing.assert_array_equal(got.beam_tokens.numpy(),
                                  np.asarray(want.beam_tokens))
    np.testing.assert_array_equal(got.beam_lengths.numpy(),
                                  np.asarray(want.beam_lengths))
    np.testing.assert_allclose(got.beam_scores.numpy(),
                               np.asarray(want.beam_scores), rtol=1e-4,
                               atol=1e-4)


SMEM = 232_448  # bytes of shared memory one H100 block may opt into


def test_prefix_route_plans():
    """The "utt" plans as integer arithmetic: the decode shape, small and
    long shapes, and the shapes past each plan."""
    # the flagship decode: 416 psi lanes in 2 frame splits, one 192-frame
    # chunk; the state in 64-frame chunks (two buffers, 38,912 bytes)
    assert ops.psi_plan(8, 174, 52, SMEM) == (2, 192)
    assert ops.psi_smem(8, 52, 2, 192) == 4 * 192 * (52 + 16)
    assert ops.state_plan(8, 174, 52, SMEM) == 64
    assert ops.state_smem(8, 52, 64) == 38_912
    # K=1, V=9: 8 splits; T=1: the chunks cut to 32 and 8 frames; a long T
    # streams 256-frame psi chunks
    assert ops.psi_plan(1, 29, 9, SMEM) == (8, 32)
    assert ops.psi_plan(8, 1, 9, SMEM) == (8, 32)
    assert ops.state_plan(1, 1, 9, SMEM) == 8
    assert ops.psi_plan(4, 700, 9, SMEM) == (8, 256)
    assert ops.state_plan(16, 700, 52, SMEM) == 64
    # the partial pairs outgrow a small chunk's tables
    assert ops.psi_smem(16, 8, 8, 32) == 8 * 16 * 8 * 8
    # past the plans: more lanes than a block's threads, more hypotheses
    # than the chain's warp, lpz chunks wider than shared memory
    assert ops.psi_plan(40, 9, 30, SMEM) is None
    assert ops.state_plan(33, 9, 30, SMEM) is None
    assert ops.state_plan(32, 9, 30, SMEM) == 16
    assert ops.psi_plan(1, 174, 1000, SMEM) == (1, 32)
    assert ops.psi_plan(1, 174, 1000, 49_152) is None
    assert ops.state_plan(8, 174, 5000, SMEM) is None


def test_force_prefix_route():
    """``_force_prefix_route``: an unknown route raises; a forced "utt"
    that does not fit raises; "lane" takes the lane kernel whatever the
    plan; the default takes the plan where it fits; the route in force
    comes back after the block."""
    with pytest.raises(ValueError, match="unknown route"):
        with ops._force_prefix_route("tiled"):
            pass
    assert ops._route(64, "the state") == 64
    assert ops._route(None, "the state") is None
    with ops._force_prefix_route("utt"):
        assert ops._route((2, 192), "psi") == (2, 192)
        with pytest.raises(ValueError, match="utt route does not fit"):
            ops._route(None, "psi")
        with ops._force_prefix_route("lane"):
            assert ops._route((2, 192), "psi") is None
        with pytest.raises(ValueError, match="utt route does not fit"):
            ops._route(None, "the state")
    assert ops._forced_prefix_route is None


# --------------------------------------------------------------------------
# csrc/ctc_prefix_utt.cu: the plan, the kernel's constants, and its
# summation order emulated in numpy against the JAX per-utterance kernel
# --------------------------------------------------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "robust_e2e_gan_torch", "csrc")


@pytest.mark.parametrize("k,t,v,smem,want", [
    # the flagship decode: 216 units (208 lane pairs, 8 last-token lanes)
    # in 4 splits, the utterance in one 176-frame chunk, 2 stages: 2 x
    # 36,640 (lpz) + 46,208 (4 phi buffers) + 13,824 (pairs) + 96 + 64 bytes
    (8, 174, 52, SMEM, (4, 176, 2, 133_472)),
    # 1,200 frames: 7 chunks of 192 through a ring of 3, where staging the
    # whole utterance took 4 x (1,200 x 52 + 2 x 8 x 1,200) = 326,400 bytes
    (8, 1200, 52, SMEM, (4, 192, 3, 184_208)),
    # 1,024 lanes: 528 units, one split; 64-frame chunks keep the 1,024
    # phi items of a chunk within two a consumer
    (16, 174, 64, SMEM, (1, 64, 3, 92_912)),
    # short T: one chunk of T rounded up to 4, two stages
    (4, 17, 9, SMEM, (8, 20, 2, 7_888)),
    # wide V: the chunk falls to 16 frames
    (1, 174, 1000, SMEM, (1, 16, 3, 200_976)),
    # past the plan: 1,025 lanes; 993 units, one more than the consumers;
    # shared memory too small for one chunk
    (25, 174, 41, SMEM, None),
    (331, 5, 3, SMEM, None),
    (8, 174, 52, 12_000, None),
])
def test_utt_psi_plan(k, t, v, smem, want):
    """``utt_psi_plan`` as integer arithmetic, with ``utt_psi_smem`` the
    hand sum of the kernel's layout."""
    plan = ops.utt_psi_plan(k, t, v, smem)
    if want is None:
        assert plan is None
        return
    splits, chunk, stages = plan
    assert (splits, chunk, stages,
            ops.utt_psi_smem(k, v, splits, chunk, stages)) == want
    assert chunk % 4 == 0 and 2 <= stages <= 4
    consumers = ops.utt_consumers(k, v, splits)
    assert consumers % 32 == 0 and consumers + 32 <= ops.UTT_MAX_THREADS
    assert ops.utt_units(k, v) * splits <= consumers
    assert k * chunk <= ops.UTT_AHEAD * consumers
    assert ops.utt_psi_smem(k, v, splits, chunk, stages) <= smem


def test_utt_constants_are_the_kernels():
    """The plan's constants are those of ``csrc/ctc_prefix_utt.cu``."""
    with open(os.path.join(CSRC, "ctc_prefix_utt.cu")) as f:
        src = f.read()
    for name, value in (("kUttMaxThreads", ops.UTT_MAX_THREADS),
                        ("kUttMaxSplits", ops.UTT_MAX_SPLITS),
                        ("kUttAhead", ops.UTT_AHEAD),
                        ("kUttTabs", ops.UTT_TABLES)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == \
            str(value)


def _utt_emulate(s, splits, chunk):
    """psi of ``csrc/ctc_prefix_utt.cu`` in its summation order, in float32
    numpy: the phi table once per (k, t); per chunk of ``chunk`` frames,
    split j takes the j-th run of round_up(ceil(fc / S), 4) frames two at a
    time: the pair's (max, 1 + exp(-|t0 - t1|)) merged into the running
    (m, acc) by scaling the side with the smaller max; then the S pairs
    and the LOG_ZERO start term in split order."""
    f32 = np.float32
    lpz, last, lens = s["lpz"], s["last"], s["lens"]
    r_n, r_b = s["r_n"], s["r_b"]
    b, t, v = lpz.shape
    k = last.shape[1]
    phi0 = np.where(lens == 0, f32(0), f32(-1e10))[..., None]
    rs = np.concatenate([phi0, np.logaddexp(r_n, r_b)[..., :-1]], -1)
    rb = np.concatenate([phi0, r_b[..., :-1]], -1)
    is_last = ((np.arange(v)[None, None] == last[..., None])
               & (lens[..., None] > 0))
    phi = np.where(is_last[:, :, None, :], rb[..., None], rs[..., None])
    terms = (phi + lpz[:, None]).astype(f32)  # (B, K, T, V)
    m = np.full((splits, b, k, v), -np.inf, f32)
    acc = np.zeros((splits, b, k, v), f32)
    none = np.full((b, k, v), -np.inf, f32)
    with np.errstate(invalid="ignore", over="ignore"):
        for t0 in range(0, t, chunk):
            fc = min(chunk, t - t0)
            per = -(-(-(-fc // splits)) // 4) * 4
            for j in range(splits):
                a = t0 + j * per
                for i in range(a, t0 + min(fc, j * per + per), 2):
                    x0 = terms[:, :, i]
                    x1 = (terms[:, :, i + 1] if i + 1 < t0 + min(
                        fc, j * per + per) else none)
                    pair = (f32(1) + np.exp(-np.abs(x1 - x0))).astype(f32)
                    top = np.maximum(x0, x1)
                    d = top - m[j]
                    e = np.exp(-np.abs(d)).astype(f32)
                    acc[j] = np.where(d > 0, acc[j] * e + pair,
                                      pair * e + acc[j])
                    m[j] = np.maximum(m[j], top)
    top = np.maximum(f32(-1e10), m.max(axis=0))
    total = np.exp(f32(-1e10) - top)
    for j in range(splits):
        total = (total + acc[j] * np.exp(m[j] - top)).astype(f32)
    out = (top + np.log(total)).astype(f32)
    out[..., EOS] = np.logaddexp(r_n[..., -1], r_b[..., -1])
    out[..., BLANK] = -1e10
    return out


_UTT_SHAPE = dict(b=3, k=4, t=41, v=9)


@functools.lru_cache(maxsize=None)
def _utt_reference(seed):
    s = _state(seed, **_UTT_SHAPE)
    j = {n: jnp.asarray(a) for n, a in s.items()}
    want = prefix_scores_psi_pallas(j["lpz"], j["last"], j["lens"], j["r_n"],
                                    j["r_b"], BLANK, EOS, interpret=True)
    return s, np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("splits,chunk", [
    (0, 0),    # the plan: 8 splits, one 44-frame chunk, runs of 8
    (2, 8),    # six chunks of runs of 4, a last of 1 frame
    (2, 32),   # a 32-frame chunk (runs of 16) and a 9-frame one (12 and 0)
    (1, 16),   # one split: runs of 16 and a 9-frame tail (an odd count)
    (3, 20),   # runs of 8, 8 and 4 frames
], ids=["plan", "s2f8", "s2f32", "s1f16", "s3f20"])
def test_utt_summation_order_matches_jax_per_utterance_kernel(seed, splits,
                                                              chunk):
    """The kernel's summation order (frame splits, chunks, pairs of
    frames, the fixed combine), emulated in float32 numpy, against
    ``prefix_scores_psi_pallas`` (interpret mode): the same sums in
    another order, so at the tolerance of the per-utterance test."""
    s, want = _utt_reference(seed)
    if splits == 0:
        splits, chunk, _ = ops.utt_psi_plan(_UTT_SHAPE["k"], _UTT_SHAPE["t"],
                                            _UTT_SHAPE["v"], SMEM)
        assert (splits, chunk) == (8, 44)
    got = _utt_emulate(s, splits, chunk)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got[..., BLANK] == -1e10).all()
