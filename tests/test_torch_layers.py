"""PyTorch port vs the JAX reference: config, parameter bridge, init and
the dense serving layers (`repro_torch.models.{config,convert,layers}`).

Inputs are made with numpy from a seed and fed to both packages.  f32 on
the CPU is held to atol = rtol = 1e-5 unless a comment says why not."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import TINY
from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import registry as jax_registry
from repro.models.config import ModelConfig as JaxConfig
from repro.models.config import reduced_for_smoke as jax_reduced
from repro_torch.configs import get_arch
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig, reduced_for_smoke
from torch_port_helpers import np_tree, params_to_numpy, port_cfg, port_params

F32 = dict(atol=1e-5, rtol=1e-5)
# bf16 keeps 8 bits of mantissa; the two frameworks round intermediate
# products at different places, so results may differ by ~2 ulp
BF16 = dict(atol=2e-2, rtol=2e-2)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def close(got_torch, want_jax, tol):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), **tol)


# ---------------------------------------------------------------- config

def test_config_has_every_reference_field_and_derivation():
    jf = [f.name for f in dataclasses.fields(JaxConfig)]
    pf = [f.name for f in dataclasses.fields(ModelConfig)]
    assert jf == pf
    for name in ("dense", "moe", "hybrid", "vlm"):
        jc = TINY[name]
        pc = port_cfg(jc)
        for prop in ("q_dim", "kv_dim", "group_size", "kv_quantized"):
            assert getattr(pc, prop) == getattr(jc, prop)
    jc = jax_get_arch("internlm2-1.8b").model
    pc = get_arch("internlm2-1.8b").model
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert (dataclasses.asdict(reduced_for_smoke(pc, max_seq=64))
            == dataclasses.asdict(jax_reduced(jc, max_seq=64)))
    assert pc.compute_dtype == torch.bfloat16
    assert pc.replace(kv_dtype="fp8").kv_store_dtype == torch.float8_e4m3fn
    assert pc.replace(kv_dtype="int8").kv_store_dtype == torch.int8


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_every_leaf_bit_exact(param_dtype):
    cfg = TINY["dense"].replace(param_dtype=param_dtype)
    params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    back = params_to_numpy(port_params(params, cfg), cfg)
    want = np_tree(params)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b)
    for path, w in flat_w:
        b = flat_b[path]
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        assert b.shape == w.shape and b.dtype == w.dtype, path
        np.testing.assert_array_equal(b, w, err_msg=str(path))


def test_port_init_matches_reference_names_shapes_and_std():
    cfg = TINY["dense"].replace(d_model=128, d_ff=256, num_layers=4)
    jp = np_tree(jax_registry.get_family(cfg).init(jax.random.key(0), cfg))
    pp = params_to_numpy(PT.init(0, port_cfg(cfg), "cpu"), cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert sorted(map(str, flat_p)) == sorted(str(p) for p, _ in flat_j)
    for path, w in flat_j:
        got = flat_p[path]
        assert got.shape == w.shape and got.dtype == w.dtype, path
        # same law, different draws: sample stds of >= 16k values agree
        # within 5%; norm scales are exact ones
        np.testing.assert_allclose(got.std(), w.std(), rtol=5e-2,
                                   err_msg=str(path))
        np.testing.assert_allclose(got.mean(), w.mean(), atol=2e-3,
                                   err_msg=str(path))


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)) * 3
    scale = rng.standard_normal(64)
    td, jd = ((torch.float32, jnp.float32) if dtype == "float32"
              else (torch.bfloat16, jnp.bfloat16))
    got = PL.rmsnorm_apply(t(scale, td), t(x, td), 1e-5)
    want = JL.rmsnorm_apply(j(scale, jd), j(x, jd), 1e-5)
    assert got.dtype == td
    close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 32))
    pos = rng.integers(0, 64, (2, 9))
    td, jd = ((torch.float32, jnp.float32) if dtype == "float32"
              else (torch.bfloat16, jnp.bfloat16))
    got = PL.apply_rope(t(x, td), torch.from_numpy(pos.astype(np.int32)),
                        theta)
    want = JL.apply_rope(j(x, jd), jnp.asarray(pos, jnp.int32), theta)
    assert got.dtype == td
    close(got, want, F32 if dtype == "float32"
          else BF16)


@pytest.fixture(scope="module")
def dense():
    cfg = TINY["dense"]
    params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    return cfg, params, port_params(params, cfg)


def test_attention_qkv_matches_reference(dense):
    cfg, jp, pp = dense
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, cfg.d_model))
    pos = np.arange(7)[None, :] + np.array([[0], [20]])
    jattn = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    got = PL.attention_qkv(pp["layers"][1]["attn"], port_cfg(cfg), t(x),
                           torch.from_numpy(pos.astype(np.int32)))
    want = JL.attention_qkv(jattn, cfg, j(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w, F32)


@pytest.mark.parametrize("activation", ["silu_glu", "relu2", "gelu"])
def test_mlp_apply_matches_reference(activation):
    cfg = TINY["dense"].replace(activation=activation)
    jp = JL.mlp_init(jax.random.key(4), cfg)
    pp = {k: t(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model))
    close(PL.mlp_apply(pp, port_cfg(cfg), t(x)),
          JL.mlp_apply(jp, cfg, j(x)), F32)


def test_embed_tokens_matches_reference(dense):
    cfg, jp, pp = dense
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 6))
    got = PL.embed_tokens(pp["embed"], port_cfg(cfg),
                          torch.from_numpy(toks.astype(np.int32)))
    want = JL.embed_tokens(jp["embed"], cfg, jnp.asarray(toks, jnp.int32))
    close(got, want, dict(atol=0, rtol=0))


@pytest.mark.parametrize("tied", [False, True])
def test_logits_from_hidden_tied_and_untied(dense, tied):
    cfg, jp, pp = dense
    w_j = jp["embed"] if tied else jp["head"]
    w_p = pp["embed"] if tied else pp["head"]
    x = np.random.default_rng(6).standard_normal((2, 3, cfg.d_model))
    close(PL.logits_from_hidden(w_p, port_cfg(cfg), t(x)),
          JL.logits_from_hidden(w_j, cfg, j(x)), F32)
