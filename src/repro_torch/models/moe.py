"""Mixture-of-Experts transformer (qwen3-moe family): the paged serving
hooks.

Port of the serving half of `repro.models.moe`.  Top-k token-choice
routing with the SERVING dispatch of the reference: dropless
sort-by-expert scatter into per-expert buffers of capacity C = T * k,
so no assignment is ever dropped and every token's output is a pure
per-token function, independent of what else shares the batch (which
is what keeps paged serving exact: inert rows and ragged tails cannot
perturb real tokens, and identical prompts write identical K/V).

`cfg.moe_dispatch` picks the per-expert MLP stack:

  * "grouped" — `experts_apply_grouped`, the grouped-matmul kernel
    (`kernels/grouped_matmul`), told each expert's live row count;
  * "scatter", "ep", "dense" — `experts_apply`, the einsum twin.  The
    reference's "ep" and "dense" are training dataplanes that serve
    through the same dropless scatter off a mesh; so does the port.

Parameters keep the reference's names and layouts (weights (d_in,
d_out), experts (E, d, f) / (E, f, d)); `params["layers"]` is a list of
per-layer dicts.  The capacity-limited training dispatch, the router
losses and `paged_verify` wait for later slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DISPATCHES = ("dense", "scatter", "grouped", "ep")


# ------------------------------------------------------------ expert stack

def experts_init(gen, cfg: ModelConfig, device):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    pd = cfg.params_dtype
    return {
        "wg": L._normal(gen, (e, d, f), std, pd, device),
        "wi": L._normal(gen, (e, d, f), std, pd, device),
        "wo": L._normal(gen, (e, f, d), out_std, pd, device),
    }


def experts_apply(p, buf, rows=None):
    """buf: (E, C, d) -> (E, C, d) through each expert's GLU MLP, as
    einsums in buf's dtype (the reference leaves them to XLA).  `rows`
    is ignored: every row is computed."""
    del rows
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi"])
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def experts_apply_grouped(p, buf, rows=None):
    """`experts_apply` through the grouped-matmul kernel, with the
    reference's rounding: silu(x @ wg) * (x @ wi) in f32, cast to buf's
    dtype, then (h @ wo) in f32 cast to buf's dtype.  `rows` ((E,)
    int32) are the live rows of each expert; the rows past them are
    zeros in the dropless buffer, and the kernel skips them.  The
    reference zero-pads C, d and f to its 128 tiling; the port does not
    (the kernel masks ragged edges, and zero padding changes no output)."""
    h = grouped_matmul(buf, p["wg"], rows)
    F.silu(h, inplace=True)
    h.mul_(grouped_matmul(buf, p["wi"], rows))
    return grouped_matmul(h.to(buf.dtype), p["wo"], rows).to(buf.dtype)


# ----------------------------------------------------------------- routing

def router_init(gen, cfg: ModelConfig, device):
    return L._normal(gen, (cfg.d_model, cfg.num_experts), 0.02,
                     cfg.params_dtype, device)


def _route(router_w, cfg: ModelConfig, xf):
    """xf: (T, d) -> (weights (T, k) f32, experts (T, k) int64): f32
    softmax over the router logits, top-k (ties to the lower expert id,
    as `lax.top_k`), renormalised.  The reference's load-balance and z
    losses are training terms and are not computed."""
    logits = (xf @ router_w).float()                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_w, top_e = top.values[:, :k], top.indices[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e


def _moe_scatter(p, cfg: ModelConfig, xf, experts_fn=experts_apply):
    """Dropless sort-based dispatch (the reference's `_moe_scatter` with
    dropless=True).  xf: (T, d) -> (T, d).  Capacity is T * k, so every
    assignment keeps its place and no row is masked.  The combine
    `einsum("tkd,tk->td")` is taken in f32 over the expert outputs and
    the routing weights rounded to xf's dtype, and rounded once."""
    T_, d = xf.shape
    k = cfg.experts_per_token
    E = cfg.num_experts
    C = T_ * k
    w, e = _route(p["router"], cfg, xf)

    e_flat = e.reshape(-1)                                        # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = order // k
    # per-expert counts: bincount(minlength=E) without the device sync
    # torch.bincount makes to size its output
    counts = torch.zeros(E, dtype=torch.int64, device=xf.device).index_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T_ * k, device=xf.device) - starts[e_sorted]

    buf = torch.zeros((E, C, d), dtype=xf.dtype, device=xf.device)
    buf[e_sorted, pos] = xf[tok_sorted]
    out_buf = experts_fn(p["experts"], buf, counts.to(torch.int32))
    y_flat = torch.empty((T_ * k, d), dtype=xf.dtype, device=xf.device)
    y_flat[order] = out_buf[e_sorted, pos]
    y = torch.einsum("tkd,tk->td", y_flat.reshape(T_, k, d).float(),
                     w.to(xf.dtype).float())
    return y.to(xf.dtype)


def moe_block_init(gen, cfg: ModelConfig, device):
    p = {"router": router_init(gen, cfg, device),
         "experts": experts_init(gen, cfg, device)}
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, device,
                                 d_ff=cfg.num_shared_experts * cfg.moe_d_ff)
    return p


def moe_apply(p, cfg: ModelConfig, x, dropless: bool = False):
    """x: (b, s, d) -> y (b, s, d), the SERVING dispatch (dropless).
    The reference also returns the router loss and has a
    capacity-limited training dispatch; both wait for the training
    slice (ROADMAP.md queue A item 10)."""
    if cfg.moe_dispatch not in DISPATCHES:
        raise ValueError(cfg.moe_dispatch)
    if not dropless:
        raise NotImplementedError(
            "the capacity-limited (training) MoE dispatch is not ported "
            "yet: ROADMAP.md queue A item 10 (training)")
    b, s, d = x.shape
    fn = (experts_apply_grouped if cfg.moe_dispatch == "grouped"
          else experts_apply)
    y = _moe_scatter(p, cfg, x.reshape(b * s, d), experts_fn=fn)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + L.mlp_apply(p["shared"], cfg, x)
    return y


# ------------------------------------------------------------------ model

def layer_init(gen, cfg: ModelConfig, device):
    return {
        "ln1": L.rmsnorm_init(cfg, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg, device),
        "moe": moe_block_init(gen, cfg, device),
    }


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations (drawn from a `torch.Generator` on
    `device`, not the reference's bits)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {
        "embed": L.embedding_init(gen, cfg, device),
        "layers": [layer_init(gen, cfg, device)
                   for _ in range(cfg.num_layers)],
        "ln_f": L.rmsnorm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                   cfg.params_dtype, device)
    return params


# ------------------------------------------------- paged serving (UniMem)
#
# The same page arena as the dense transformer (identical attention
# geometry, the same two paged kernels); the MoE block runs inside the
# paged bodies: every row's token vectors are routed and dispatched
# through the expert stack each step.

init_paged_cache = T.init_paged_cache


def _moe_ffn(p, cfg: ModelConfig, hn, valid):
    """Per-layer FFN of the paged bodies: dropless expert dispatch, a
    pure per-token function, so `valid` needs no masking."""
    del valid
    return moe_apply(p["moe"], cfg, hn, dropless=True)


def paged_prefill(params, cfg: ModelConfig, chunk, arena, block_table,
                  start, chunk_len):
    """Ragged-chunk MoE prefill: `transformer.paged_prefill`'s contract
    with expert dispatch in place of the MLP."""
    x = L.embed_tokens(params["embed"], cfg, chunk["tokens"])
    return T.paged_prefill_embeds(params, cfg, x, arena, block_table,
                                  start, chunk_len, ffn_fn=_moe_ffn)


def paged_decode_step(params, cfg: ModelConfig, arena, block_table,
                      positions, tokens):
    """One decode step over the arena with expert dispatch per token:
    `transformer.paged_decode_step`'s contract."""
    return T.paged_decode_step(params, cfg, arena, block_table, positions,
                               tokens, ffn_fn=_moe_ffn)
