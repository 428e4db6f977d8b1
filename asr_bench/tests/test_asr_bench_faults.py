"""The comparison has to fail what it guards against: whole tiny runs with
the timed path broken underneath come out not correct, and so does the
control, the reference in the precision below the configuration's in the
program's place (bfloat16 for this float32 configuration)."""

import pytest
import torch

import bench_tiny
from asr_bench import calibrate, core
from asr_bench.drivers import decode as decode_driver
from asr_bench.drivers import train as train_driver


def _token_altered(*args):
    """The searcher's best tokens altered where they are produced."""
    model, searcher, lm = decode_driver.program(*args)

    def search(wav, lens):
        res = searcher(wav, lens)
        toks = res.tokens.clone()
        first = toks[:, 0]
        toks[:, 0] = torch.where(first >= 0, torch.where(first == 2, 3, 2),
                                 first)
        return res._replace(tokens=toks)

    return model, search, lm


def _half_batch(*args):
    """Half of the batch left out, its rows filled from the other half."""
    model, searcher, lm = decode_driver.program(*args)

    def search(wav, lens):
        h = wav.shape[0] // 2
        res = searcher(wav[:h], lens[:h])
        return type(res)(*(torch.cat([x, x[:wav.shape[0] - h]])
                           for x in res))

    return model, search, lm


def _not_the_best_served(*args):
    """The searcher serves the last of its K final hypotheses, with that
    hypothesis's own tokens and score, in place of its best."""
    model, searcher, lm = decode_driver.program(*args)

    def search(wav, lens):
        res = searcher(wav, lens)
        k = res.beam_scores.shape[1] - 1
        n = res.tokens.shape[1]
        return res._replace(tokens=res.beam_tokens[:, k, :n],
                            lengths=res.beam_lengths[:, k],
                            scores=res.beam_scores[:, k])

    return model, search, lm


def _state_unchanged(*args):
    """A step that leaves the parameters as they were."""
    state, step = train_driver.program(*args)
    params = list(state.model.parameters()) + list(
        state.discriminator.parameters())

    def frozen(st, batch):
        saved = [p.detach().clone() for p in params]
        metrics = step(st, batch)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return metrics

    return state, frozen


def _half_train_batch(*args):
    """Half of the batch left out, the mean taken over the rest."""
    state, step = train_driver.program(*args)

    def half(st, batch):
        h = batch["noisy_wav"].shape[0] // 2
        return step(st, {k: v[:h] for k, v in batch.items()})

    return state, half


@pytest.mark.parametrize("fault", [_token_altered, _half_batch,
                                   _not_the_best_served])
def test_a_broken_decode_is_not_correct(fault):
    result, _, _ = bench_tiny.run("flagship.decode_enh",
                                  bench_tiny.decode_traffic(), program=fault)
    assert not result["correct"], result["checks"]
    if fault is _not_the_best_served:
        assert result["checks"]["select_rel"]["value"] > 0.0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_train_batch])
def test_a_broken_train_step_is_not_correct(fault):
    result, _, _ = bench_tiny.run("reference.train_joint",
                                  bench_tiny.train_traffic(), program=fault)
    assert not result["correct"], result["checks"]
    if fault is _state_unchanged:
        assert result["checks"]["change_rel"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("traffic", [bench_tiny.decode_traffic(),
                                     bench_tiny.decode_traffic(True),
                                     bench_tiny.train_traffic()],
                         ids=["decode_enh", "decode_clean_lm", "train"])
def test_the_control_is_not_correct(traffic):
    ctx = calibrate._Ctx(cfg=bench_tiny.config(), traffic=traffic,
                         device=torch.device("cpu"))
    drv = core.driver(traffic["kind"])
    seed = 2**31 + 99
    if traffic["kind"] == "decode":
        program = calibrate.decode_reading(ctx, drv, seed, None)
        control = calibrate.decode_reading(ctx, drv, seed, "bf16")
    else:
        program = calibrate.train_reading(ctx, drv, seed, None, None)
        control = calibrate.train_reading(ctx, drv, seed, "bf16", None)
    limits = bench_tiny.limits_for(traffic)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(not control[k] <= lim for k, lim in limits.items()), control
