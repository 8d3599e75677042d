"""Mixture-of-Experts transformer (qwen3-moe family): the training
forward and loss, and the serving hooks, contiguous and paged.

Port of `repro.models.moe`.  Top-k token-choice routing.  Two dispatch
modes, as in the reference:

  * training (`moe_apply(..., dropless=False)`): capacity-limited.  Each
    expert takes C = ceil(T k / E * capacity_factor) rows (rounded up to
    8, at least 8); assignments past an expert's capacity are dropped
    (their rows scatter zeros, their outputs are masked).  `_route` also
    returns the router losses (Switch load balance and z-loss), which
    `loss_fn` adds to the LM loss.
  * serving (`dropless=True`): capacity T * k, so no assignment is ever
    dropped and every token's output is a pure per-token function,
    independent of what else shares the batch (which keeps paged serving
    exact: inert rows and ragged tails cannot perturb real tokens, and
    identical prompts write identical K/V).  No router loss is computed.

`cfg.moe_dispatch` picks the dispatch and the per-expert MLP stack:

  * "dense" — the one-hot einsum oracle (`_moe_dense`, training);
  * "scatter" — sort-by-expert scatter into per-expert buffers, experts
    through `experts_apply`, the einsum twin;
  * "ep" — expert parallelism over the mesh's "model" axis (`_moe_ep`,
    the reference's `_moe_ep_local`): each rank routes its own tokens over
    all E experts, builds capacity buffers only for the experts resident
    on it, runs them through `experts_apply_grouped` (the grouped kernel
    and its backward on the card), and the combined outputs are
    all-reduced over "model".  Without a bound mesh, or where E does not
    divide over "model", it is the global "scatter";
  * "grouped" — the scatter dispatch with `experts_apply_grouped`, the
    grouped-matmul kernel (`kernels/grouped_matmul`) told each expert's
    live row count; where a gradient must flow it goes through
    `GroupedMatmulFn` (the backward kernels on the card).
  Serving takes the dropless scatter under every dispatch, as the
  reference does.  All are differentiable and agree.

Parameters keep the reference's names and layouts (weights (d_in,
d_out), experts (E, d, f) / (E, f, d)); `params["layers"]` is a list of
per-layer dicts.  `paged_verify` is the dense walk with expert dispatch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distribution import collectives
from repro_torch.kernels.grouped_matmul.ops import (GroupedMatmulFn,
                                                    grouped_matmul)
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


def experts_axes():
    return {
        "wg": ("expert", "expert_in", "mlp"),
        "wi": ("expert", "expert_in", "mlp"),
        "wo": ("expert", "mlp", "expert_in"),
    }


def experts_apply(p, buf, rows=None):
    """buf: (E, C, d) -> (E, C, d) through each expert's GLU MLP, as
    einsums in buf's dtype (the reference leaves them to XLA).  `rows`
    is ignored: every row is computed."""
    del rows
    h = L.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi"])
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def experts_apply_grouped(p, buf, rows=None):
    """`experts_apply` through the grouped-matmul kernel, with the
    reference's rounding: silu(x @ wg) * (x @ wi) in f32, cast to buf's
    dtype, then (h @ wo) in f32 cast to buf's dtype.  `rows` ((E,)
    int32) are the live rows of each expert; the rows past them are
    zeros in the buffer, and the kernel skips them.  The reference
    zero-pads C, d and f to its 128 tiling; the port does not (the
    kernel masks ragged edges, and zero padding changes no output).
    When grad is enabled and buf or a weight requires grad, the products
    go through `GroupedMatmulFn` (and nothing is updated in place);
    serving computes h in place."""
    if torch.is_grad_enabled() and (
            buf.requires_grad or any(w.requires_grad for w in p.values())):
        mm = GroupedMatmulFn.apply
        h = F.silu(mm(buf, p["wg"], rows)) * mm(buf, p["wi"], rows)
        return mm(h.to(buf.dtype), p["wo"], rows).to(buf.dtype)
    h = grouped_matmul(buf, p["wg"], rows)
    F.silu(h, inplace=True)
    h.mul_(grouped_matmul(buf, p["wi"], rows))
    return grouped_matmul(h.to(buf.dtype), p["wo"], rows).to(buf.dtype)


# ----------------------------------------------------------------- routing

def router_init(gen, cfg: ModelConfig, device):
    return L._normal(gen, (cfg.d_model, cfg.num_experts), 0.02,
                     cfg.params_dtype, device)


def _route(router_w, cfg: ModelConfig, xf, with_aux: bool = False):
    """xf: (T, d) -> (weights (T, k) f32, experts (T, k) int64): f32
    softmax over the router logits, top-k (ties to the lower expert id,
    as `lax.top_k`), renormalised.  `with_aux` (training) appends the
    reference's router loss, an f32 scalar: the Switch load balance E *
    sum(mean prob * assigned share) * router_aux_coef plus the z-loss
    mean(logsumexp(logits)^2) * router_z_coef."""
    logits = L.matmul(xf, router_w).float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_w, top_e = top.values[:, :k], top.indices[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if not with_aux:
        return top_w, top_e
    E = cfg.num_experts
    me = probs.mean(dim=0)                                      # (E,)
    flat = top_e.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=xf.device)) / (xf.shape[0] * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_coef
    return top_w, top_e, aux + z


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """The training dispatch's rows per expert: ceil(T k / E *
    capacity_factor), rounded up to 8, at least 8."""
    c = int(math.ceil(num_tokens * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _combine(y_flat, w, T_: int, k: int, dtype):
    """The weighted combine `einsum("tkd,tk->td")`, taken in f32 over the
    expert outputs and the routing weights rounded to `dtype`, and
    rounded once."""
    y = torch.einsum("tkd,tk->td", y_flat.reshape(T_, k, -1).float(),
                     w.to(dtype).float())
    return y.to(dtype)


def _moe_dense(p, cfg: ModelConfig, xf):
    """The one-hot dispatch oracle (capacity-limited).  xf: (T, d) ->
    (y (T, d), aux)."""
    T_, d = xf.shape
    C = _capacity(cfg, T_)
    E, k = cfg.num_experts, cfg.experts_per_token
    w, e, aux = _route(p["router"], cfg, xf, with_aux=True)
    # position of each (token, choice) within its expert's capacity
    flat = F.one_hot(e, E).reshape(T_ * k, E)                    # (T*k, E)
    pos = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1).reshape(T_, k)
    keep = pos < C
    disp = (F.one_hot(e, E).to(xf.dtype)[..., :, None]
            * F.one_hot(torch.clamp(pos, max=C - 1), C).to(xf.dtype)[
                ..., None, :]
            * keep[..., None, None].to(xf.dtype))               # (T,k,E,C)
    buf = torch.einsum("td,tkec->ecd", xf, disp)                  # (E, C, d)
    out_buf = experts_apply(p["experts"], buf)
    y = torch.einsum("ecd,tkec,tk->td", out_buf, disp, w.to(xf.dtype))
    return y, aux


def _moe_scatter(p, cfg: ModelConfig, xf, experts_fn=experts_apply,
                 dropless: bool = True):
    """Sort-based dispatch (the reference's `_moe_scatter`).  xf: (T, d).
    `dropless` (serving) -> y (T, d): capacity T * k, so every assignment
    keeps its own slot and no row is masked.  Otherwise (training) ->
    (y, aux): capacity `_capacity(T)`; an assignment past its expert's
    capacity adds a row of zeros into the last slot (the reference's
    `pos_c = C - 1`), its output is masked, and the experts are told
    min(count, C) live rows.  The combine is `_combine`'s."""
    T_, d = xf.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    if dropless:
        C = T_ * k
        w, e = _route(p["router"], cfg, xf)
    else:
        C = _capacity(cfg, T_)
        w, e, aux = _route(p["router"], cfg, xf, with_aux=True)
    order, e_sorted, counts, pos = _sorted_positions(e, E)
    if not dropless:
        keep = (pos < C)[:, None].to(xf.dtype)
        pos = torch.clamp(pos, max=C - 1)
        counts = torch.clamp(counts, max=C)
    # in place into a fresh buffer; serving's slots never repeat, so it
    # writes where training sums.  The gathered rows are temporaries, as
    # the expert outputs below: neither stays alive beside the buffers.
    buf = torch.zeros((E, C, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((e_sorted, pos), xf[order // k] if dropless
                   else xf[order // k] * keep, accumulate=not dropless)
    out_buf = experts_fn(p["experts"], buf, counts.to(torch.int32))
    y_flat = torch.empty((T_ * k, d), dtype=xf.dtype, device=xf.device)
    y_flat[order] = (out_buf[e_sorted, pos] if dropless
                     else out_buf[e_sorted, pos] * keep)
    y = _combine(y_flat, w, T_, k, xf.dtype)
    return y if dropless else (y, aux)


def _moe_ep(p, cfg: ModelConfig, xf):
    """Expert-parallel dispatch over the bound mesh's model axis; the
    global scatter when there is no such mesh or E does not divide.  The
    experts are this rank's E / m resident ones when the sharded step
    tagged them (`collectives.mark_tp`); full expert stacks under a bound
    mesh are cut to this rank's here."""
    ex = p["experts"]
    g = collectives.tp_group(ex["wg"])
    if g is None:
        g = L._model_group(cfg, cfg.num_experts)
        if g is None or ex["wg"].shape[0] != cfg.num_experts:
            return _moe_scatter(p, cfg, xf, dropless=False)
        e_loc = cfg.num_experts // g.size
        ex = {k: v[g.index * e_loc:(g.index + 1) * e_loc]
              for k, v in ex.items()}
    return _moe_ep_local(p["router"], ex, cfg, xf, g)


def _moe_ep_local(router_w, ex, cfg: ModelConfig, xf, g):
    """One rank's part of the expert-parallel dispatch.  xf: (T, d) this
    rank's tokens (replicated over the model axis); ex: its (E_loc, ...)
    resident experts.  Routing is over all E experts and the capacity is
    computed on the LOCAL tokens; an assignment to a foreign expert is
    redirected to the out-of-range bin E_loc and dropped (never wrapped
    onto a resident expert).  The rank's partial combine is summed over
    the model axis in f32 and rounded once.  The router loss is this
    rank's tokens' (the sharded step weights the data-parallel ranks'
    losses into their mean, the reference's pmean)."""
    T_, d = xf.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    e_loc = ex["wg"].shape[0]
    cap = _capacity(cfg, T_)
    w, e, aux = _route(router_w, cfg, xf, with_aux=True)
    order, e_sorted, counts, pos = _sorted_positions(e, E)
    keep = pos < cap
    pos = torch.clamp(pos, max=cap - 1)
    e_rel = e_sorted - g.index * e_loc
    mine = (e_rel >= 0) & (e_rel < e_loc)
    e_idx = torch.where(mine, e_rel, torch.full_like(e_rel, e_loc))
    xt = collectives.copy_to_tp(xf, g)
    buf = torch.zeros((e_loc + 1, cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((e_idx, pos),
                   xt[order // k] * keep[:, None].to(xf.dtype),
                   accumulate=True)
    live = torch.clamp(counts[g.index * e_loc:(g.index + 1) * e_loc],
                       max=cap).to(torch.int32)
    out_buf = experts_apply_grouped(ex, buf[:e_loc], live)
    sel = (keep & mine)[:, None].to(xf.dtype)
    y_flat = torch.empty((T_ * k, d), dtype=xf.dtype, device=xf.device)
    y_flat[order] = out_buf[torch.clamp(e_rel, 0, e_loc - 1), pos] * sel
    wt = collectives.copy_to_tp(w, g)
    y = torch.einsum("tkd,tk->td", y_flat.reshape(T_, k, d).float(),
                     wt.to(xf.dtype).float())
    return collectives.reduce_from_tp(y, g).to(xf.dtype), aux


def _sorted_positions(e, E: int):
    """(order, sorted experts, their counts (E,), each sorted assignment's
    position within its expert) of the (T, k) choices `e`."""
    e_flat = e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    # bincount(minlength=E) without the device sync torch.bincount makes
    counts = torch.zeros(E, dtype=torch.int64, device=e.device).index_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(e_flat.numel(), device=e.device) - starts[e_sorted]
    return order, e_sorted, counts, pos


def moe_block_init(gen, cfg: ModelConfig, device):
    p = {"router": router_init(gen, cfg, device),
         "experts": experts_init(gen, cfg, device)}
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, device,
                                 d_ff=cfg.num_shared_experts * cfg.moe_d_ff)
    return p


def moe_block_axes(cfg: ModelConfig):
    ax = {"router": ("embed", "norm"), "experts": experts_axes()}
    if cfg.num_shared_experts:
        ax["shared"] = L.mlp_axes(cfg)
    return ax


def moe_apply(p, cfg: ModelConfig, x, dropless: bool = False):
    """x: (b, s, d).  Training (`dropless` False) -> (y (b, s, d), aux):
    the capacity-limited dispatch `cfg.moe_dispatch` names ("ep" is
    "scatter" off a bound mesh) and the router loss.  Serving (`dropless`) ->
    y: the dropless scatter under every dispatch, the grouped kernel
    under "grouped", no router loss."""
    if cfg.moe_dispatch not in DISPATCHES:
        raise ValueError(cfg.moe_dispatch)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    fn = (experts_apply_grouped if cfg.moe_dispatch == "grouped"
          else experts_apply)
    if dropless:
        y = _moe_scatter(p, cfg, xf, experts_fn=fn)
    elif cfg.moe_dispatch == "dense":
        y, aux = _moe_dense(p, cfg, xf)
    elif cfg.moe_dispatch == "ep":
        y, aux = _moe_ep(p, cfg, xf)
    else:
        y, aux = _moe_scatter(p, cfg, xf, experts_fn=fn, dropless=False)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + L.mlp_apply(p["shared"], cfg, x)
    return y if dropless else (y, aux)


# ------------------------------------------------------------------ model

def layer_init(gen, cfg: ModelConfig, device):
    return {
        "ln1": L.rmsnorm_init(cfg, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg, device),
        "moe": moe_block_init(gen, cfg, device),
    }


def layer_axes(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_axes(),
        "attn": L.attention_axes(),
        "ln2": L.rmsnorm_axes(),
        "moe": moe_block_axes(cfg),
    }


def param_axes(cfg: ModelConfig):
    """The logical axes of `init`'s tree: a list of per-layer axes."""
    axes = {
        "embed": L.embedding_axes(),
        "layers": [layer_axes(cfg) for _ in range(cfg.num_layers)],
        "ln_f": L.rmsnorm_axes(),
    }
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


def layer_apply(p, cfg: ModelConfig, x, positions):
    """One training layer: -> (x (b, s, d), the layer's router loss)."""
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_apply(p["attn"], cfg, h, positions)
    h = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    y, aux = moe_apply(p["moe"], cfg, h)
    return x + y, aux


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations (drawn from a `torch.Generator` on
    `device`, not the reference's bits)."""
    device = torch.device(device)
    gen = L.generator(device)
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


# ---------------------------------------------------------------- serving
#
# The dense transformer's contiguous cache and bodies with expert
# dispatch in place of the MLP.

init_cache = T.init_cache
cache_axes = T.cache_axes


def _moe_ffn(p, cfg: ModelConfig, hn, valid):
    """Per-layer FFN of the serving bodies: dropless expert dispatch, a
    pure per-token function, so `valid` needs no masking."""
    del valid
    return moe_apply(p["moe"], cfg, hn, dropless=True)


def prefill(params, cfg: ModelConfig, batch, cache):
    """`transformer.prefill`'s contract with expert dispatch."""
    return T.prefill(params, cfg, batch, cache, ffn_fn=_moe_ffn)


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """`transformer.decode_step`'s contract with expert dispatch."""
    return T.decode_step(params, cfg, cache, tokens, ffn_fn=_moe_ffn)


# ------------------------------------------------- paged serving (UniMem)
#
# The same page arena as the dense transformer (identical attention
# geometry, the same two paged kernels); the MoE block runs inside the
# paged bodies: every row's token vectors are routed and dispatched
# through the expert stack each step.

init_paged_cache = T.init_paged_cache
paged_cache_axes = T.paged_cache_axes


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


def paged_verify(params, cfg: ModelConfig, chunk, arena, block_table,
                 start, chunk_len):
    """Speculative-verify walk with expert dispatch:
    `transformer.paged_verify`'s contract (all-position logits).  Rows
    with chunk_len 0 stay inert: the dropless dispatch is a pure
    per-token function."""
    return T.paged_verify(params, cfg, chunk, arena, block_table, start,
                          chunk_len, ffn_fn=_moe_ffn)


# ---------------------------------------------------------------- training

def forward_hidden(params, cfg: ModelConfig, x, positions):
    """x: (b, s, d) embedded input -> (final hidden states after the final
    norm, the router losses summed over the layers in f32).  Each layer
    runs under `cfg.remat` (`transformer._maybe_remat`)."""
    body = T._maybe_remat(layer_apply, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        x, a = body(p, cfg, x, positions)
        aux = aux + a
    return L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps), aux


def forward(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (b, s)} -> logits (b, s, vocab) (the training
    dispatch)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(params["embed"], cfg, tokens)
    h, _ = forward_hidden(params, cfg, x, positions)
    return L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens", "labels": (b, s)} -> mean next-token CE plus the
    router losses (f32 scalar; labels < 0 are ignored)."""
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(params["embed"], cfg, tokens)
    h, aux = forward_hidden(params, cfg, x, positions)
    return L.lm_loss(h, T.head_weights(params, cfg), cfg, labels) + aux
