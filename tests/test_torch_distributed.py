"""The port's sharded training against the reference, in one 4-rank gloo
world on the CPU.

The module-scoped `world` fixture spawns ONE world of 4 ranks (one torch
thread each, a free localhost port) that runs every case of
`torch_dist_ranks.cases` and returns numpy results; this process computes
the reference's expectations on its one CPU device and holds the port to
them with the reference tests' own tolerances (tests/test_multidevice.py):

  * TINY dense, grad_accum 2, on (2, 2) and on (1, 4) (the kv heads, 2 of
    4 ranks, replicated): two steps against the reference's single-device
    `make_train_step` (loss 2e-4, params rtol 2e-3 / atol 2e-4);
  * TINY moe under "ep" on (2, 2), capacity_factor 8: the forward and the
    gradients against the reference's "scatter" (3e-4; 5e-3 / 5e-4);
  * the vocab-parallel lookup against `jnp.take` (1e-6; 1e-5);
  * `ring_allreduce_int8` against each rank's block through the
    reference's quantizer summed in ring order, and under 0.02 of the
    exact sum; `bucket_psum` equal to per-leaf all-reduces;
    `compressed_tree_psum` and its error feedback against the reference's
    arithmetic;
  * the autograd collectives' backwards (all-gather: reduce-scatter;
    the row-parallel all-reduce: identity; the copy into a tensor-parallel
    region: all-reduce);
  * GPipe against the sequential forward (2e-5; bubble 3/9);
  * one sharded step of TINY ssm and hybrid (mixers gathered) against the
    port's single-device step;
  * a reference checkpoint written on 1x1 restored by `elastic_restore`
    on (2, 2), and the trajectory across a (2, 2) -> (4, 1) restart
    against the reference's uninterrupted run.

A world that does not finish within `WORLD_TIMEOUT` seconds fails (it is
stopped, never left to hang the suite); so does a rank that raises.  The
launcher's `--mesh 2x2` is held to `--mesh 1x1`.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import TINY, tiny_batch
from torch_port_helpers import np_tree, one_torch_thread  # noqa: F401
import torch_dist_ranks as R

from repro.distribution.collectives import dequantize_int8, quantize_int8
from repro.models import registry as ref_registry
from repro.train import train_step as RTS
from repro.train.checkpoint import CheckpointManager as RefCheckpoints
from repro.train.optimizer import OptimizerConfig as RefOptConfig
from repro.train.optimizer import make_optimizer as ref_optimizer
from repro.utils.tree import tree_flatten_with_names as ref_names

from repro_torch.distribution.pipeline import gpipe_bubble_fraction
from repro_torch.launch.world import run_world
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

WORLD_TIMEOUT = 240          # seconds for the whole 4-rank world
LOSS_TOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


def _np_batch(cfg, batch, seq, seed=0):
    return {k: np.asarray(v) for k, v in
            tiny_batch(cfg, batch=batch, seq=seq, seed=seed).items()}


def _names(tree) -> dict:
    return {n: np.asarray(x, np.float32) for n, x in ref_names(tree)}


def _ref_opt():
    return ref_optimizer(RefOptConfig(**R.OPT))


def _quant(x):
    q, s = quantize_int8(jnp.asarray(x))
    return np.asarray(dequantize_int8(q, s))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the reference's expectations, the ranks' results).  The
    world starts as soon as its inputs exist and runs while this process
    computes the rest of the reference's side."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    dense = TINY["dense"]
    moe = TINY["moe"].replace(capacity_factor=8.0, moe_dispatch="ep")
    opt = _ref_opt()
    state = RTS.init_train_state(jax.random.key(0), dense, opt)
    batches = [_np_batch(dense, 8, 32, seed=s) for s in range(3)]
    ref = {}
    # a reference checkpoint at step 1 (the world restores it)
    step1 = jax.jit(RTS.make_train_step(dense, opt, grad_accum=1))
    s1, _ = step1(state, batches[0])
    RefCheckpoints(str(tmp / "ref_ckpt"), async_save=False).save(s1, 1)
    fam = ref_registry.get_family(moe)
    mparams = fam.init(jax.random.key(8), moe)
    mbatch = _np_batch(moe, 4, 16, seed=4)
    gp_w = (jax.random.normal(jax.random.key(0), (8, 16, 16))
            / np.sqrt(16)).astype(jnp.float32)
    gp_x = jax.random.normal(jax.random.key(1), (6, 4, 16))
    inp = {
        "dense_cfg": dataclasses.asdict(dense),
        "dense_params": np_tree(state.params), "dense_batch": batches[0],
        "dense_batches": batches, "ckpt": str(tmp / "ref_ckpt"),
        "tmp": str(tmp),
        "moe_cfg": dataclasses.asdict(moe), "moe_params": np_tree(mparams),
        "moe_batch": mbatch,
        "vocab_emb": rng.standard_normal((128, 64)).astype(np.float32),
        "vocab_toks": rng.integers(0, 128, (4, 16)),
        "ring_x": rng.standard_normal((4, 256)).astype(np.float32),
        "bucket": {"a": rng.integers(-50, 50, (4, 10)).astype(np.float32),
                   "b": rng.integers(-50, 50, (4, 3, 7)).astype(np.float32),
                   "c": rng.integers(-50, 50, (4, 50)).astype(np.float32)},
        "compressed": [
            {"w": rng.standard_normal((4, 8, 16)).astype(np.float32),
             "b": rng.standard_normal((4, 16)).astype(np.float32)}
            for _ in range(2)],
        "gpipe_w": np.asarray(gp_w), "gpipe_x": np.asarray(gp_x),
        "ag_x": rng.standard_normal((4, 2, 3)).astype(np.float32),
        "ag_w": rng.standard_normal((4, 8, 3)).astype(np.float32),
        "ssm_cfg": dataclasses.asdict(TINY["ssm"]),
        "ssm_batch": _np_batch(TINY["ssm"], 8, 32),
        "hybrid_cfg": dataclasses.asdict(TINY["hybrid"]),
        "hybrid_batch": _np_batch(TINY["hybrid"], 8, 32),
    }
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_world, R.cases, 4, (inp,),
                          timeout=WORLD_TIMEOUT)
        ref["ckpt"] = (_names(s1.params), _names(s1.opt_state))
        elastic = []
        for b in batches[1:]:          # the checkpoint's uninterrupted run
            s1, m = step1(s1, b)
            elastic.append(float(m["loss"]))
        ref["elastic"] = elastic
        # the single-device reference: two steps, grad_accum 2
        step2 = jax.jit(RTS.make_train_step(dense, opt, grad_accum=2))
        s, losses = state, []
        for _ in range(2):
            s, m = step2(s, batches[0])
            losses.append(float(m["loss"]))
        ref["dense"] = (losses, _names(s.params))
        # MoE: the reference's scatter forward and gradients
        scatter = moe.replace(moe_dispatch="scatter")
        ref["moe_logits"] = np.asarray(fam.forward(mparams, scatter, mbatch))
        ref["moe_grads"] = _names(jax.grad(
            lambda p: fam.loss_fn(p, scatter, mbatch))(mparams))
        want = gp_x
        for i in range(8):
            want = jnp.tanh(want @ gp_w[i])
        ref["gpipe"] = np.asarray(want)
        return inp, ref, ranks.result()


def _close_params(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_sharded_dense_step_equals_reference_single_device(world, shape):
    _, ref, ranks = world
    losses, params = ranks[0][f"dense_{shape}"]
    want_losses, want_params = ref["dense"]
    assert np.abs(np.array(losses) - np.array(want_losses)).max() < LOSS_TOL
    _close_params(params, want_params)


def test_moe_ep_forward_equals_reference_scatter(world):
    _, ref, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r["moe"][0], ref["moe_logits"],
                                   rtol=3e-4, atol=3e-4)


def test_moe_ep_gradients_equal_reference_scatter(world):
    _, ref, ranks = world
    grads = ranks[0]["moe"][2]
    assert set(grads) == set(ref["moe_grads"])
    for k, want in ref["moe_grads"].items():
        np.testing.assert_allclose(grads[k], want, rtol=5e-3, atol=5e-4,
                                   err_msg=k)


def test_vocab_parallel_lookup_forward_and_gradient(world):
    inp, _, ranks = world
    emb, toks = inp["vocab_emb"], inp["vocab_toks"]
    plain = np.asarray(jnp.take(jnp.asarray(emb), jnp.asarray(toks), axis=0))
    grad = np.asarray(jax.grad(lambda e: (jnp.take(e, toks, axis=0) ** 2)
                               .sum())(jnp.asarray(emb)))
    for r in ranks:
        np.testing.assert_allclose(r["vocab"][0], plain, rtol=1e-6)
    for data in (0, 1):        # a model group's local grads sum to the whole
        mine = [r["vocab"][1] for r in ranks if r["coords"]["data"] == data]
        np.testing.assert_allclose(sum(mine), grad, rtol=1e-5)
        # each rank's gradient stays in its own rows of the table
        v_loc = emb.shape[0] // 2
        for i, g in enumerate(mine):
            outside = np.delete(g, np.s_[i * v_loc:(i + 1) * v_loc], axis=0)
            assert not outside.any()


def test_int8_ring_matches_reference_quantizer_in_ring_order(world):
    inp, _, ranks = world
    x = inp["ring_x"]
    exact = x.sum(0)
    for i, r in enumerate(ranks):
        want = _quant(x[i])
        for h in range(1, 4):
            want = want + _quant(x[(i - h) % 4])
        np.testing.assert_allclose(r["ring"], want, rtol=1e-6, atol=1e-6)
        assert np.abs(r["ring"] - exact).max() / np.abs(exact).max() < 0.02


def test_bucket_psum_equals_per_leaf_all_reduce(world):
    inp, _, ranks = world
    for r in ranks:
        got, want = r["bucket"]
        for k in inp["bucket"]:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], inp["bucket"][k].sum(0))


def test_compressed_tree_psum_and_error_feedback(world):
    inp, _, ranks = world
    err = {k: np.zeros_like(v) for k, v in inp["compressed"][0].items()}
    for c, call in enumerate(inp["compressed"]):
        xs = {k: call[k] + err[k] for k in call}
        for i, r in enumerate(ranks):
            red, new_err = r["compressed"][c]
            for k in call:
                want = _quant(xs[k][i])
                for h in range(1, 4):
                    want = want + _quant(xs[k][(i - h) % 4])
                np.testing.assert_allclose(red[k], want / 4, rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(new_err[k],
                                           xs[k][i] - _quant(xs[k][i]),
                                           rtol=1e-6, atol=1e-7)
        err = {k: np.stack([xs[k][i] - _quant(xs[k][i]) for i in range(4)])
               for k in call}


def test_autograd_collectives_and_their_backwards(world):
    inp, _, ranks = world
    x, w = inp["ag_x"], inp["ag_w"]
    for i, r in enumerate(ranks):
        y, gx, red, gz, gu = r["autograd"]
        np.testing.assert_allclose(y, x.reshape(8, 3), rtol=1e-6)
        np.testing.assert_allclose(gx, w.sum(0)[2 * i:2 * i + 2], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(red, x.sum(0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gz, w[i, :2], rtol=1e-6)
        np.testing.assert_allclose(gu, w[:, :2].sum(0), rtol=1e-5,
                                   atol=1e-6)


def test_gpipe_equals_sequential_forward(world):
    _, ref, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r["gpipe"], ref["gpipe"], rtol=2e-5,
                                   atol=2e-5)
    assert abs(gpipe_bubble_fraction(4, 6) - 3 / 9) < 1e-9


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
def test_sharded_family_step_equals_single_device(world, fam):
    inp, _, ranks = world
    cfg = ModelConfig(**inp[f"{fam}_cfg"])
    opt = make_optimizer(OptimizerConfig(**R.OPT))
    params = registry.get_family(cfg).init(0, cfg, torch.device("cpu"))
    state = TS.init_train_state(cfg, opt, params=params)
    state, m = TS.make_train_step(cfg, opt)(state, R.batch_t(
        inp[f"{fam}_batch"]))
    losses, got = ranks[0][fam]
    assert abs(losses[0] - float(m["loss"])) < LOSS_TOL
    _close_params(got, R.np_params(state.params))


def test_elastic_restore_of_a_reference_checkpoint(world):
    _, ref, ranks = world
    step, params, opt_state = ranks[0]["elastic"][0]
    assert step == 1
    want_p, want_o = ref["ckpt"]
    assert set(params) == set(want_p)
    for k in want_p:
        np.testing.assert_array_equal(params[k], want_p[k], err_msg=k)
    assert set(opt_state) == set(want_o)
    for k in want_o:
        np.testing.assert_array_equal(opt_state[k], want_o[k], err_msg=k)


def test_elastic_restart_keeps_the_trajectory(world):
    _, ref, ranks = world
    _, losses, saved_mesh = ranks[0]["elastic"]
    assert saved_mesh == {"data": 2, "model": 2}
    assert np.abs(np.array(losses) - np.array(ref["elastic"])).max() \
        < LOSS_TOL


def test_a_world_past_its_timeout_is_stopped():
    with pytest.raises(TimeoutError):
        run_world(R.sleeper, 2, (60.0,), timeout=3.0)


def test_a_failing_rank_fails_the_world():
    with pytest.raises(Exception, match="fails on purpose"):
        run_world(R.failer, 2, timeout=60.0)


def test_launcher_mesh_2x2_equals_1x1():
    from repro_torch.launch.train import main
    argv = ["--reduced", "--device", "cpu", "--steps", "2", "--seq", "32",
            "--log-every", "100"]
    sharded = main(argv + ["--mesh", "2x2", "--timeout", "120"])
    single = main(argv + ["--mesh", "1x1"])
    assert len(sharded) == len(single) == 2
    assert np.abs(np.array(sharded) - np.array(single)).max() < LOSS_TOL
