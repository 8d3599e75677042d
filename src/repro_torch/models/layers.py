"""Shared building blocks: norms, rotary, GQA projections, MLPs,
embeddings, and the paged-attention dispatch.

Port of the serving subset of `repro.models.layers`.  Plain functions
on tensors with the reference's names and parameter layouts: weights are
(d_in, d_out), so `x @ w` is the reference's product.  The reference's
sharding constraints and vocab-parallel lookup have no counterpart on
one card and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_prefill.ops import paged_prefill_attention


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, 1) drawn in f32, cast, then scaled — the reference's order."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.to(dtype) * std


# ----------------------------------------------------------------- RMSNorm

def rmsnorm_init(cfg: ModelConfig, device, dim: int | None = None):
    return torch.ones((dim or cfg.d_model,), dtype=cfg.params_dtype,
                      device=device)


def rmsnorm_apply(scale, x, eps: float):
    """f32 math, result cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


# ------------------------------------------------------------------ rotary

def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Half-split rotation; angles in f32, cos/sin cast to x's
    dtype BEFORE the rotation (the reference's rule)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., seq, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)        # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------- attention block

def attention_init(gen, cfg: ModelConfig, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    pd = cfg.params_dtype
    return {
        "wq": _normal(gen, (d, qd), std, pd, device),
        "wk": _normal(gen, (d, kvd), std, pd, device),
        "wv": _normal(gen, (d, kvd), std, pd, device),
        "wo": _normal(gen, (qd, d), out_std, pd, device),
    }


def attention_qkv(p, cfg: ModelConfig, x, positions):
    """x: (b, s, d) -> q (b,s,hq,hd), k/v (b,s,hkv,hd) with rope applied."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _check_single_arena(cfg: ModelConfig):
    if cfg.mem_axis is not None:
        raise NotImplementedError(
            "sharded paged attention (cfg.mem_axis) is not ported yet: "
            "ROADMAP.md queue A item 12")


def run_paged_decode_attention(cfg: ModelConfig, q, k_pages, v_pages,
                               block_table, positions,
                               k_scale=None, v_scale=None):
    """Paged decode attention over ONE layer's arena: the CUDA kernel on
    the card, its plain version on the CPU.  q: (b, hq, d); returns
    (b, hq*d)."""
    _check_single_arena(cfg)
    b, hq, d = q.shape
    o = paged_decode_attention(q, k_pages, v_pages, block_table, positions,
                               k_scale=k_scale, v_scale=v_scale)
    return o.reshape(b, hq * d)


def run_paged_prefill_attention(cfg: ModelConfig, q, k_pages, v_pages,
                                block_table, start, chunk_len,
                                k_scale=None, v_scale=None):
    """Causal ragged chunk-prefill attention over ONE layer's arena (the
    chunk's own K/V already written).  q: (b, c, hq, d); returns
    (b, c, hq*d), rows past chunk_len zero."""
    _check_single_arena(cfg)
    b, c, hq, d = q.shape
    o = paged_prefill_attention(q, k_pages, v_pages, block_table, start,
                                chunk_len, k_scale=k_scale, v_scale=v_scale)
    return o.reshape(b, c, hq * d)


# --------------------------------------------------------------------- MLP

def mlp_init(gen, cfg: ModelConfig, device, d_ff: int | None = None):
    """The reference's leaves and standard deviations; `d_ff` overrides
    the hidden width (MoE shared experts: num_shared * moe_d_ff)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    pd = cfg.params_dtype
    p = {}
    if cfg.activation == "silu_glu":
        p["wg"] = _normal(gen, (d, f), std, pd, device)
    p["wi"] = _normal(gen, (d, f), std, pd, device)
    p["wo"] = _normal(gen, (f, d), out_std, pd, device)
    return p


def mlp_apply(p, cfg: ModelConfig, x):
    if cfg.activation == "silu_glu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.activation == "relu2":
        h = torch.relu(x @ p["wi"]).square()
    elif cfg.activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return h @ p["wo"]


# -------------------------------------------------------------- embeddings

def embedding_init(gen, cfg: ModelConfig, device):
    return _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                   cfg.params_dtype, device)


def embed_tokens(emb, cfg: ModelConfig, tokens):
    """tokens (...) int -> (..., d) in the compute dtype."""
    x = emb.index_select(0, tokens.reshape(-1))
    return x.reshape(*tokens.shape, emb.shape[1]).to(cfg.compute_dtype)


def logits_from_hidden(emb_or_head, cfg: ModelConfig, x):
    """x: (b, s, d) @ head (d, vocab), or the tied embedding (vocab, d):
    tied is detected by `w.shape[0] == vocab_size`, as in the reference."""
    w = emb_or_head
    if w.shape[0] == cfg.vocab_size:          # tied: (vocab, d)
        return x @ w.to(x.dtype).t()
    return x @ w.to(x.dtype)
