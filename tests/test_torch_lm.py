"""The port's RNNLM (``models/lm.py``, ``ops/lm_step.py``, ``train/lm.py``)
against the JAX package's on the CPU, float32: the beam-search step through
the plain cells and through the kernel's plain version against both JAX
step impls (the fused one in interpret mode), the teacher-forced pass and
its loss, and one Adam train step; the "tile" route's plan, and its 3xTF32
products emulated against the JAX kernel."""

import dataclasses
import os
import re
import types

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.models import lm as jax_lm  # noqa: E402
from robust_e2e_gan_tpu.models.e2e import (  # noqa: E402
    add_sos_eos as jax_add_sos_eos,
)
from robust_e2e_gan_tpu.ops.lm_step_pallas import (  # noqa: E402
    lm_step_fused as jax_lm_step_fused,
)
from robust_e2e_gan_tpu.train import lm as jax_train_lm  # noqa: E402
from robust_e2e_gan_torch.config import LMConfig, TrainConfig  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, to_flax  # noqa: E402
from robust_e2e_gan_torch.models.e2e import add_sos_eos  # noqa: E402
from robust_e2e_gan_torch.models.lm import RNNLM, lm_loss  # noqa: E402
from robust_e2e_gan_torch.ops import lm_step as lm_ops  # noqa: E402
from robust_e2e_gan_torch.train.lm import (  # noqa: E402
    LMState,
    make_lm_train_step,
)
from robust_e2e_gan_torch.train.steps import create_optimizer  # noqa: E402
from test_torch_train_step import PARAM_ATOL, _close_trees  # noqa: E402

VOCAB = 200
SHAPES = {"1layer": (1, 12, 24, 16), "2layer": (2, 9, 128, 128)}  # L, N, H, E


def _jax_lm(cfg):
    return jax_lm.RNNLM(jax_lm.LMConfig(**dataclasses.asdict(cfg)))


def _models(cfg, seed=0):
    """A JAX RNNLM with its init parameters and the port's RNNLM holding
    the same parameters."""
    jlm = _jax_lm(cfg)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    lm = RNNLM(cfg)
    lm.load_state_dict(from_flax(params["params"]))
    return jlm, params, lm


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lm_step_matches_jax(shape, impl):
    """The port's "xla" step (plain cells) and "fused" step (the kernel
    wrapper: its plain version on CPU tensors) against the JAX step of the
    same impl."""
    layers, n, hid, emb = SHAPES[shape]
    cfg = LMConfig(vocab_size=VOCAB, embed_dim=emb, hidden_dim=hid,
                   num_layers=layers, step_impl=impl)
    jlm, params, lm = _models(cfg)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, VOCAB, size=(n,)).astype(np.int32)
    h0, c0 = (0.3 * rng.standard_normal((layers, n, hid))
              .astype(np.float32) for _ in range(2))
    (h_w, c_w), lg_w = jlm.apply(params, (jnp.asarray(h0), jnp.asarray(c0)),
                                 jnp.asarray(tok), method=jax_lm.RNNLM.step)
    calls = lm_ops.lm_step_plain.calls
    with torch.no_grad():
        (h, c), lg = lm.step((torch.from_numpy(h0), torch.from_numpy(c0)),
                             torch.from_numpy(tok))
    # the fused impl goes through the kernel wrapper, the xla one does not
    assert lm_ops.lm_step_plain.calls - calls == (impl == "fused")
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_w), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_w), rtol=0, atol=1e-6)


def _labels(seed, b=4, s=7, vocab=12):
    rng = np.random.default_rng(seed)
    ys = np.full((b, s), -1, np.int32)
    for i in range(b):
        n = int(rng.integers(1, s + 1))
        ys[i, :n] = rng.integers(2, vocab, size=n)
    return ys


def test_lm_forward_and_loss_match_jax():
    cfg = LMConfig(vocab_size=12, embed_dim=16, hidden_dim=24, num_layers=2)
    jlm, params, lm = _models(cfg, seed=2)
    ys = _labels(3)
    jin, jout, _ = jax_add_sos_eos(jnp.asarray(ys), cfg.sos_id, cfg.eos_id,
                                   cfg.ignore_id)
    want = jlm.apply(params, jin)
    want_loss, want_ppl = jax_lm.lm_loss(want, jout, cfg.ignore_id)
    ys_in, ys_out, _ = add_sos_eos(torch.from_numpy(ys), cfg.sos_id,
                                   cfg.eos_id, cfg.ignore_id)
    with torch.no_grad():
        got = lm(ys_in)
        loss, ppl = lm_loss(got, ys_out, cfg.ignore_id)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ppl), float(want_ppl), rtol=1e-5)


def test_lm_train_step_matches_jax():
    """One Adam step with warmup: loss, ppl, grad_norm and every updated
    parameter (Adam's first update compared as in the joint-step test)."""
    cfg = LMConfig(vocab_size=12, embed_dim=16, hidden_dim=24)
    tcfg = TrainConfig(optimizer="adam", learning_rate=1e-3, warmup_steps=2)
    jlm = _jax_lm(cfg)
    jstate, opt = jax_train_lm.init_lm_state(
        jlm, jax_config.from_dict(jax_config.TrainConfig,
                                  dataclasses.asdict(tcfg)), seed=4)
    before = jax.tree_util.tree_map(np.asarray, jstate.params)
    ys = _labels(5)
    jstate, want = jax_train_lm.make_lm_train_step(jlm, opt)(
        jstate, jnp.asarray(ys))

    lm = RNNLM(cfg)
    lm.load_state_dict(from_flax({"step_mod": before["step_mod"]}))
    state = LMState(lm, create_optimizer(lm.parameters(), tcfg))
    got = make_lm_train_step()(state, torch.from_numpy(ys))
    assert state.step == 1 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    # the first warmup step's learning rate: lr / warmup_steps
    _close_trees(to_flax(lm.state_dict()),
                 jax.tree_util.tree_map(np.asarray, jstate.params),
                 PARAM_ATOL, to_flax(from_flax(before)),
                 tcfg.learning_rate / 2)


# ---------------------------------------------------------------------------
# route "tile" (csrc/lm_step_tile.cu): its plan, and its numerics
# ---------------------------------------------------------------------------

H100_SMS, H100_SMEM = 132, 232_448
# the clean decode's LM (LMConfig) at B K = 128 x 8 and 16 x 8 lanes, two
# layers, and the decode CLI's widths: N, V, E, H, L, itemsize
TILE_SHAPES = {"lmconfig-n1024": (1024, 52, 128, 256, 1, 4),
               "lmconfig-n128": (128, 52, 128, 256, 1, 4),
               "lmconfig-bf16": (1024, 52, 128, 256, 1, 2),
               "2layers": (1024, 52, 128, 256, 2, 4),
               "cli-e512-h512": (1024, 12, 512, 512, 1, 4)}


def _tile_constants():
    """TM, TU, NS, the W and gates rows' strides, KC and the readout lanes
    (bf16, f32) as csrc/lm_step_tile.cu defines them."""
    path = os.path.join(os.path.dirname(lm_ops.__file__), os.pardir, "csrc",
                        "lm_step_tile.cu")
    with open(path) as f:
        src = f.read()

    def const(pattern):
        return int(re.search(pattern, src).group(1))

    tm, tu = const(r"constexpr int TM = (\d+);"), const(r"constexpr int TU = (\d+);")
    ns = const(r"constexpr int NS = (\d+);")
    nt = const(r"constexpr int NT = (\d+);")
    ws = 4 * tu + const(r"constexpr int WS = TN \+ (\d+);")
    gs = 4 * tu + const(r"constexpr int GS = TN \+ (\d+);")
    kc = re.search(r"kChunk = kB16<T> \? (\d+) : (\d+);", src)
    rl = re.search(r"kReadLanes = kB16<T> \? (\d+) : (\d+);", src)
    return (tm, tu, ns, nt, ws, gs,
            {2: int(kc.group(1)), 4: int(kc.group(2))},
            {2: int(rl.group(1)), 4: int(rl.group(2))})


@pytest.mark.parametrize("name", list(TILE_SHAPES))
def test_tile_plan_fits_the_cells(name):
    """The "tile" plan (integer arithmetic, the kernel's constants read from
    its source) on an H100: a grid of one block a tile of 64 lanes by 32
    units, at most one an SM (the CLI's 256 tiles on 132 blocks), and the
    shared memory of the largest of the gate buffers, the gates tile and
    the readout."""
    n, v, e, h, layers, isz = TILE_SHAPES[name]
    tm, tu, ns, nt, ws, gs, kc, rl = _tile_constants()
    assert (tm, tu, ns, nt, ws, gs, kc, rl) == (
        lm_ops.TILE_LANES, lm_ops.TILE_UNITS, lm_ops.TILE_STAGES,
        lm_ops.TILE_THREADS, lm_ops.TILE_W_STRIDE, lm_ops.TILE_GATE_STRIDE,
        lm_ops.TILE_CHUNK, lm_ops.READ_LANES)
    plan = lm_ops.tile_plan(n, v, e, h, layers, isz, H100_SMS, H100_SMEM)
    assert plan is not None
    chunk, stages, grid, smem = plan
    tiles = -(-n // tm) * -(-h // tu)
    assert (chunk, stages) == (kc[isz], ns)
    assert grid == min(tiles, H100_SMS)
    assert {"lmconfig-n1024": 128, "lmconfig-n128": 16, "lmconfig-bf16": 128,
            "2layers": 128, "cli-e512-h512": 132}[name] == grid

    def r16(x):
        return -(-x // 16) * 16

    bufs = ns * (tm * (kc[isz] + 16 // isz) + kc[isz] * ws) * isz
    if isz == 2:
        hp, vp = r16(h), r16(v)
        readout = (r16(2 * rl[2] * (hp + 8)) + r16(2 * hp * (vp + 8))
                   + 4 * 16 * max(nt // 2, vp))
    else:
        readout = r16(4 * rl[4] * h) + r16(4 * h * v) + 4 * rl[4] * nt
    assert smem == max(bufs, tm * gs * 4, readout) <= H100_SMEM
    assert smem == 106_496  # the gate buffers bind at these widths


@pytest.mark.parametrize("change", ["e_off_piece_f32", "h_off_piece_bf16",
                                    "wout_too_big", "itemsize_8"])
def test_tile_plan_none_past_its_limits(change):
    """None where E or H is not whole 16-byte pieces (4 float32, 8
    bfloat16 elements), where the staged Wout does not fit the shared
    memory, and for a compute dtype of neither 2 nor 4 bytes."""
    n, v, e, h, layers, isz = TILE_SHAPES["lmconfig-n1024"]
    if change == "e_off_piece_f32":
        e = 130
    elif change == "h_off_piece_bf16":
        h, isz = 252, 2
    elif change == "wout_too_big":
        v = 300  # 256 x 300 float32 = 307,200 bytes
    else:
        isz = 8
    assert lm_ops.tile_plan(n, v, e, h, layers, isz, H100_SMS,
                            H100_SMEM) is None
    assert lm_ops.tile_plan(n, 200, 128, 252, 1, 4, H100_SMS, H100_SMEM)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits; to nearest, ties away from
    zero, as cvt.rna.tf32.f32) by masking its float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b as the "tile" route multiplies float32 on the tensor cores:
    each operand split into hi = tf32(x) and lo = tf32(x - hi), and
    lo hi + hi lo + hi hi summed in float32 (``passes=1``: hi hi alone,
    single-pass TF32)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tile_step_emulated(tok, emb, wxs, whs, biases, out_w, out_b, h, c,
                        passes=3):
    """The "tile" route's float32 LM step: per layer one product of
    [x | h] with [Wx; Wh] in 3xTF32, the bias, the cell; the readout on
    the CUDA cores (float32)."""
    inp = emb[tok.long()]
    hs, cs = [], []
    for li, (wx, wh, b) in enumerate(zip(wxs, whs, biases)):
        gates = _mm_3xtf32(torch.cat([inp, h[li]], 1), torch.cat([wx, wh]),
                           passes) + b
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c[li] + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return torch.stack(hs), torch.stack(cs), inp @ out_w + out_b


@pytest.mark.parametrize("layers", [1, 2])
def test_tile_3xtf32_matches_the_jax_kernel(layers):
    """The "tile" route's float32 numerics (3xTF32 products, emulated with
    tf32 rounding by bit masking) against the JAX ``lm_step_fused`` in
    interpret mode at ``LMConfig`` widths (V=52, E=128, H=256) and 24
    lanes: within the float32 tolerance, rtol 1e-4 / atol 1e-5, where
    single-pass TF32 is not."""
    v, e, h, n = 52, 128, 256, 24
    rng = np.random.default_rng(7 + layers)

    def rnd(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    tok = rng.integers(0, v, size=(n,)).astype(np.int32)
    emb = rnd(v, e, scale=e ** -0.5)
    wxs = [rnd(e if i == 0 else h, 4 * h, scale=(e if i == 0 else h) ** -0.5)
           for i in range(layers)]
    whs = [rnd(h, 4 * h, scale=h ** -0.5) for _ in range(layers)]
    biases = [rnd(4 * h, scale=0.1) for _ in range(layers)]
    out_w, out_b = rnd(h, v, scale=h ** -0.5), rnd(v, scale=0.1)
    h0, c0 = rnd(layers, n, h, scale=0.5), rnd(layers, n, h, scale=0.5)
    want = jax_lm_step_fused(
        jnp.asarray(tok), jnp.asarray(emb), tuple(map(jnp.asarray, wxs)),
        tuple(map(jnp.asarray, whs)), tuple(map(jnp.asarray, biases)),
        jnp.asarray(out_w), jnp.asarray(out_b), jnp.asarray(h0),
        jnp.asarray(c0), dtype=jnp.float32)
    t = torch.from_numpy
    args = (t(tok), t(emb), [t(w) for w in wxs], [t(w) for w in whs],
            [t(b) for b in biases], t(out_w), t(out_b), t(h0), t(c0))
    got = _tile_step_emulated(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    one_pass = _tile_step_emulated(*args, passes=1)
    assert any(not np.allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-5)
               for g, w in zip(one_pass, want))


def test_force_lm_route_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="unknown route"):
        with lm_ops._force_lm_route("utt"):
            pass
    assert lm_ops._forced_lm_route is None


@pytest.mark.parametrize("e, v", [(130, 52), (128, 300)])
def test_forced_tile_route_past_the_plan_raises_on_the_card_path(
        monkeypatch, e, v):
    """On the card path, forcing route "tile" past its plan (E not whole
    16-byte pieces, a Wout beyond shared memory) raises before any launch;
    unforced, the same shapes go to the "lane" kernel, and shapes the plan
    fits to the "tile" kernel with its grid and the barrier counter's
    value, which then grows by L x grid."""
    launched = []
    monkeypatch.setattr(lm_ops, "on_cuda", lambda *t: True)
    monkeypatch.setattr(lm_ops, "device_limits",
                        lambda index: (H100_SMS, H100_SMEM))
    monkeypatch.setattr(lm_ops, "launch",
                        lambda name, *args: launched.append((name, args)))
    monkeypatch.setattr(lm_ops, "grid_barrier",
                        lambda dev, stream, b=[torch.zeros(1), 5]: b)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    lm_ops._tile_plan_on.cache_clear()
    n, h, layers = 70, 256, 2

    def z(*shape):
        return torch.zeros(shape)

    def args(e, v):
        return (torch.zeros(n, dtype=torch.long), z(v, e),
                [z(e, 4 * h), z(h, 4 * h)], [z(h, 4 * h)] * 2, [z(4 * h)] * 2,
                z(h, v), z(v), z(layers, n, h), z(layers, n, h))

    routes = dict(lm_ops.LM_ROUTE_LAUNCHES)
    with pytest.raises(ValueError, match="tile route does not fit"):
        with lm_ops._force_lm_route("tile"):
            lm_ops.lm_step(*args(e, v))
    assert launched == [] and lm_ops.LM_ROUTE_LAUNCHES == routes
    lm_ops.lm_step(*args(e, v))
    lm_ops.lm_step(*args(128, 52))
    assert [name for name, _ in launched] == ["lm_step", "lm_step_tile"]
    grid = 2 * 8  # ceil(70 / 64) lane tiles x 8 unit tiles
    # ..., N, V, E, H, L, KC, NS, grid, smem, the counter's value, bf16,
    # stream
    assert launched[1][1][-12:] == (n, 52, 128, h, layers, 32, 4, grid,
                                    106_496, 5, 0, 0)
    assert lm_ops.grid_barrier(None, 0)[1] == 5 + layers * grid
    assert lm_ops.LM_ROUTE_LAUNCHES == {"tile": routes["tile"] + 1,
                                        "lane": routes["lane"] + 1}
    lm_ops.LM_ROUTE_LAUNCHES.update(routes)
    lm_ops._tile_plan_on.cache_clear()

