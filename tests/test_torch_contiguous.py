"""PyTorch port vs the JAX reference: attention over contiguous K/V and
the contiguous serving hooks of every family.

The split-KV decode and flash kernels' plain versions are held against
the reference's Pallas kernels in interpret mode (where those take the
shape) and against its XLA oracles (`layers.decode_attention`,
`dense_attention`, `flash_xla_attention`); the port's `combine_splits`,
`insert_slot`/`clear_slot` and each family's `init_cache`, `prefill`
and `decode_step` against the reference's on the same inputs, made with
numpy.  f32, atol = rtol = 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import TINY
from repro.kernels.decode_attention import kernel as JDK
from repro.kernels.flash_attention import kernel as JFK
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import registry as jax_registry
from repro.serve import kv_cache as JKV
from repro_torch.kernels.decode_attention import ops as dk
from repro_torch.kernels.flash_attention import ops as fk
from repro_torch.models import layers as PL
from repro_torch.models import registry
from repro_torch.serve import kv_cache as PKV
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                np_tree, params_to_numpy, port_cfg,
                                port_params)

F32 = dict(atol=1e-5, rtol=1e-5)
FAMILIES = ("dense", "moe", "hybrid", "ssm")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------ split-KV decode

# (b, hq, hkv, d, S, kv_splits, positions)
DECODE_CASES = {
    "gqa": (3, 4, 2, 16, 64, 8, (0, 37, 63)),
    "mha": (2, 4, 4, 16, 32, 4, (31, 5)),
    "S_not_split_multiple": (3, 4, 2, 16, 61, 8, (0, 60, 30)),
    "positions_at_and_past_S": (3, 4, 2, 16, 64, 8, (63, 64, 200)),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_split_decode_plain_matches_the_tpu_kernel_and_the_oracle(name):
    b, hq, hkv, d, S, splits, pos = DECODE_CASES[name]
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, b, hq, d), _normal(rng, b, S, hkv, d),
               _normal(rng, b, S, hkv, d))
    pos = np.array(pos, np.int32)
    got = dk.decode_attention(_t(q), _t(k), _t(v), _t(pos), kv_splits=splits)
    oracle = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy().reshape(b, hq * d),
                               np.asarray(oracle), **F32)
    if S % splits:
        return                    # the TPU kernel asserts S % kv_splits == 0
    m, l, acc = JDK.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        kv_splits=splits, interpret=True)
    want = JDK.combine_splits(m, l, acc, b, hq, d, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    gm, gl, ga = dk.decode_partials(_t(q), _t(k), _t(v), _t(pos),
                                    kv_splits=splits)
    # a split with no visible row is inert in both (m = -1e30); the port
    # skips its rows (l = 0, acc = 0) where the TPU kernel masks them
    seen = gm.numpy() > -1e29
    np.testing.assert_allclose(gm.numpy(), np.asarray(m), **F32)
    np.testing.assert_allclose(gl.numpy()[seen], np.asarray(l)[seen], **F32)
    np.testing.assert_allclose(ga.numpy()[seen], np.asarray(acc)[seen], **F32)
    assert (gl.numpy()[~seen] == 0).all() and (ga.numpy()[~seen] == 0).all()


def test_combine_splits_matches_the_reference():
    rng = np.random.default_rng(2)
    bh, splits, g, d = 6, 8, 2, 16
    m = _normal(rng, bh, splits, g) * 3
    m[:, 5:] = -1e30                               # empty splits
    l = np.abs(_normal(rng, bh, splits, g)) * 10
    acc = _normal(rng, bh, splits, g, d)
    got = dk.combine_splits(_t(m), _t(l), _t(acc), 3, 4, d, torch.float32)
    want = JDK.combine_splits(jnp.asarray(m), jnp.asarray(l),
                              jnp.asarray(acc), 3, 4, d, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --------------------------------------------------------------- flash

# (b, sq, skv, hq, hkv, d, causal, q_offset)
FLASH_CASES = {
    "causal": (2, 64, 64, 4, 2, 16, True, 0),
    "non_causal": (2, 64, 64, 4, 2, 16, False, 0),
    "q_offset": (1, 32, 96, 4, 2, 16, True, 64),
    "two_blocks": (1, 256, 256, 4, 2, 32, True, 0),
    "ragged_sq_skv_offset": (2, 37, 53, 4, 2, 16, True, 16),
    "ragged_non_causal_mha": (2, 45, 45, 4, 4, 16, False, 0),
    "ragged_prompt_200": (1, 200, 200, 4, 2, 16, True, 0),
    "ragged_prompt_5": (1, 5, 5, 4, 2, 16, True, 0),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_plain_matches_the_tpu_kernel_and_the_oracles(name):
    b, sq, skv, hq, hkv, d, causal, off = FLASH_CASES[name]
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, b, sq, hq, d), _normal(rng, b, skv, hkv, d),
               _normal(rng, b, skv, hkv, d))
    got = fk.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             q_offset=off).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (JL.dense_attention(jq, jk, jv, causal=causal, q_offset=off),
                 JL.flash_xla_attention(jq, jk, jv, causal=causal, chunk=32,
                                        q_offset=off)):
        np.testing.assert_allclose(got, np.asarray(want), **F32)
    if sq % min(128, sq) == 0:    # the TPU kernel's own shape rule
        want = JFK.flash_attention_pallas(jq, jk, jv, causal=causal,
                                          block_kv=32, q_offset=off,
                                          interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("name", ["causal", "ragged_sq_skv_offset",
                                  "ragged_non_causal_mha"])
def test_ported_xla_oracles_match_the_reference(name):
    b, sq, skv, hq, hkv, d, causal, off = FLASH_CASES[name]
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, b, sq, hq, d), _normal(rng, b, skv, hkv, d),
               _normal(rng, b, skv, hkv, d))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        PL.dense_attention(_t(q), _t(k), _t(v), causal=causal,
                           q_offset=off).numpy(),
        np.asarray(JL.dense_attention(jq, jk, jv, causal=causal,
                                      q_offset=off)), **F32)
    np.testing.assert_allclose(
        PL.flash_xla_attention(_t(q), _t(k), _t(v), causal=causal, chunk=16,
                               q_offset=off).numpy(),
        np.asarray(JL.flash_xla_attention(jq, jk, jv, causal=causal,
                                          chunk=16, q_offset=off)), **F32)


@pytest.mark.parametrize("impl", ["dense", "flash_xla", "flash_pallas"])
def test_attention_dispatch_follows_attention_impl_on_the_cpu(impl):
    cfg = TINY["dense"].replace(attention_impl=impl)
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, 2, 32, 4, 16), _normal(rng, 2, 32, 2, 16),
               _normal(rng, 2, 32, 2, 16))
    before = (dk.launches, fk.launches)
    got = PL.run_attention(port_cfg(cfg), _t(q), _t(k), _t(v))
    want = JL.run_attention(cfg, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    kc, vc = _normal(rng, 2, 64, 2, 16), _normal(rng, 2, 64, 2, 16)
    pos = np.array([63, 9], np.int32)
    got = PL.run_decode_attention(port_cfg(cfg), _t(q[:, 0]), _t(kc), _t(vc),
                                  _t(pos))
    want = JL.run_decode_attention(cfg, jnp.asarray(q[:, 0]),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert (dk.launches, fk.launches) == before   # the CPU launches nothing


# ------------------------------------------------------- cache slots

def _random_cache(cache, rng):
    return {k: (rng.integers(1, 50, np.shape(a)).astype(np.int32)
                if k == "pos" else _normal(rng, *np.shape(a)))
            for k, a in cache.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_insert_and_clear_slot_match_the_reference(family):
    cfg = TINY[family]
    fam, pfam = jax_registry.get_family(cfg), registry.get_family(port_cfg(cfg))
    rng = np.random.default_rng(6)
    big = _random_cache(fam.init_cache(cfg, 3, 16), rng)
    one = _random_cache(fam.init_cache(cfg, 1, 16), rng)
    ax = fam.cache_axes()
    assert pfam.cache_axes() == ax
    want = JKV.insert_slot({k: jnp.asarray(a) for k, a in big.items()},
                           {k: jnp.asarray(a) for k, a in one.items()}, 1, ax)
    # the port inserts by writing through `slot_view`: it must address
    # the row the reference's `insert_slot` writes, in every leaf
    got = {k: _t(a.copy()) for k, a in big.items()}
    for k, view in PKV.slot_view(got, 1, ax).items():
        view.copy_(_t(one[k]))
    for k in big:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    want = JKV.clear_slot(want, 2, ax)
    got = PKV.clear_slot(got, 2, ax)
    for k in big:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if family == "hybrid":        # the conv/SSM leaves carry the batch on axis 2
        assert PKV.batch_axis_index(ax["conv"]) == 2
        assert (got["conv"][:, :, 2] == 0).all() and got["conv"][:, :, 0].any()


# --------------------------------------------- prefill and decode steps

@pytest.fixture(scope="module")
def family_params():
    out = {}
    for family in FAMILIES:
        cfg = TINY[family]
        params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
        out[family] = (params, port_params(params, cfg))
    return out


def _caches_close(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), **F32,
                                   err_msg=k)


@pytest.mark.parametrize("family, impl", [(f, "flash_xla") for f in FAMILIES]
                         + [("dense", "flash_pallas"),
                            ("hybrid", "flash_pallas")])
def test_prefill_and_decode_steps_match_the_reference(family_params, family,
                                                      impl):
    """A batch of two 16-token prompts, then three decode steps with row
    1 moved two short of max_seq: its last writes clamp at max_seq - 1
    and it then sees every row.  Logits and every cache leaf agree."""
    cfg = TINY[family].replace(attention_impl=impl)
    pc = port_cfg(cfg)
    jp, pp = family_params[family]
    fam, pfam = jax_registry.get_family(cfg), registry.get_family(pc)
    S, b = 32, 2
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
    jc, jl = fam.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                         fam.init_cache(cfg, b, S))
    tc, tl = pfam.prefill(pp, pc, {"tokens": _t(tokens)},
                          pfam.init_cache(pc, b, S, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _caches_close(tc, jc)
    jc["pos"] = jc["pos"].at[1].set(S - 2)
    tc["pos"][1] = S - 2
    for _ in range(3):
        step = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jc, jl = fam.decode_step(jp, cfg, jc, jnp.asarray(step))
        tc, tl = pfam.decode_step(pp, pc, tc, _t(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        _caches_close(tc, jc)
    assert int(tc["pos"][1]) == S + 1


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_into_a_cleared_row_equals_the_inserted_fresh_cache(
        family_params, family):
    """The engine's admission: zero the row, prefill through a batch=1
    view of it.  The batched cache equals the reference's route (prefill
    on a fresh batch=1 cache, `insert_slot`), although the row held an
    idle row's writes before."""
    cfg = TINY[family]
    pc = port_cfg(cfg)
    jp, pp = family_params[family]
    fam, pfam = jax_registry.get_family(cfg), registry.get_family(pc)
    ax = pfam.cache_axes()
    rng = np.random.default_rng(8)
    garbage = _random_cache(fam.init_cache(cfg, 3, 32), rng)
    tokens = rng.integers(0, cfg.vocab_size, (1, 11)).astype(np.int32)
    one, jl = fam.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                          fam.init_cache(cfg, 1, 32))
    want = JKV.insert_slot({k: jnp.asarray(a) for k, a in garbage.items()},
                           one, 1, ax)
    got = {k: _t(a.copy()) for k, a in garbage.items()}
    PKV.clear_slot(got, 1, ax)
    _, tl = pfam.prefill(pp, pc, {"tokens": _t(tokens)},
                         PKV.slot_view(got, 1, ax))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _caches_close(got, want)


def test_ssm_prompt_shorter_than_the_conv_window(family_params):
    """A 2-token prompt (conv width 4): the port's conv tail is the two
    rows behind one zero row, the zeros the causal conv reads before
    position 0.  (The reference's `_conv_tail` returns the 2 rows alone,
    a (L, 1, 2, ch) leaf its engine cannot insert.)  Logits of the
    prefill, and of the decode step continued from the zero-padded tail,
    agree with the reference."""
    cfg = TINY["ssm"]
    pc = port_cfg(cfg)
    jp, pp = family_params["ssm"]
    pfam = registry.get_family(pc)
    tokens = np.array([[5, 77]], np.int32)
    jc, jl = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                        JM.init_cache(cfg, 1))
    tc, tl = pfam.prefill(pp, pc, {"tokens": _t(tokens)},
                          pfam.init_cache(pc, 1, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert np.asarray(jc["conv"]).shape[2] == 2 == cfg.conv_width - 2
    assert (tc["conv"][:, :, 0] == 0).all()
    np.testing.assert_allclose(tc["conv"][:, :, 1:].numpy(),
                               np.asarray(jc["conv"]), **F32)
    jc["conv"] = jnp.pad(jc["conv"], ((0, 0), (0, 0), (1, 0), (0, 0)))
    step = np.array([9], np.int32)
    jc, jl = JM.decode_step(jp, cfg, jc, jnp.asarray(step))
    tc, tl = pfam.decode_step(pp, pc, tc, _t(step))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _caches_close(tc, jc)


def test_bridge_round_trips_ssm_params_bit_exact(family_params):
    jp, pp = family_params["ssm"]
    back = params_to_numpy(pp, TINY["ssm"])
    flat_w = jax.tree_util.tree_leaves_with_path(np_tree(jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b) and len(pp["layers"]) == 2
    for path, w in flat_w:
        assert flat_b[path].dtype == w.dtype, path
        np.testing.assert_array_equal(flat_b[path], w, err_msg=str(path))


def test_port_ssm_init_matches_reference_names_shapes_and_std():
    cfg = TINY["ssm"].replace(d_model=128)
    jp = np_tree(JM.init(jax.random.key(0), cfg))
    pp = params_to_numpy(registry.get_family(port_cfg(cfg)).init(
        0, port_cfg(cfg), "cpu"), cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert sorted(map(str, flat_p)) == sorted(str(p) for p, _ in flat_j)
    for path, w in flat_j:
        got = flat_p[path]
        assert got.shape == w.shape and got.dtype == w.dtype, path
        # same law, different draws: stds within 5%; constant leaves
        # (norms, A_log, D, biases) equal within float rounding
        np.testing.assert_allclose(got.std(), w.std(), rtol=5e-2, atol=1e-6,
                                   err_msg=str(path))
        np.testing.assert_allclose(got.mean(), w.mean(), atol=4e-3,
                                   err_msg=str(path))
