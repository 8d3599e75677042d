"""Mamba-2 (SSD, state-space duality): the pure-SSM family (mamba2-130m)
and the blocks the hybrid family runs.

Port of `repro.models.mamba2`: the chunked SSD scan, the single-token
recurrence, the depthwise causal conv, the block bodies (`block_apply`
for whole sequences: training and prefill, `block_prefill_chunk`,
`block_step`), the ssm family's training forward and loss, and its
serving hooks.  Within a chunk the SSD is its
dual (masked decay-weighted "attention") form; across chunks a short
Python loop over the chunk states carries the recurrence, where the
reference scans.  `ssd_impl="pallas"` takes the intra-chunk part
through the SSD kernel (`kernels/ssd_scan` `SsdIntraChunkFn`, whose
backward is the SSD backward kernel on the card), `"xla"` through the
plain torch form of the reference's XLA branch.  Both are
differentiable; the inter-chunk recurrence and its output stay torch
ops, as the reference keeps them in XLA.

The ssm family's state is O(1) per sequence, so it has nothing to page:
it serves from the contiguous layout (`init_cache`: per-layer conv
tails (L, b, width-1, channels), SSM states (L, b, h, p, n) and a (b,)
pos), and its hooks update that cache in place.  A prompt shorter than
width - 1 gets a conv tail padded with the zeros the causal conv reads
before position 0 (the reference's `_conv_tail` returns a shorter tail,
which its engine cannot insert).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import SsdIntraChunkFn
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

NEG_INF = -1e30


# ----------------------------------------------------------------- SSD core

def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None, impl="xla"):
    """Chunked state-space-duality scan.

    x: (b, s, h, p); dt: (b, s, h) post-softplus step sizes (f32); A:
    (h,) negative decay rates; B, C: (b, s, h, n) (already repeated over
    group heads); impl "xla" or "pallas".  Returns (y (b, s, h, p),
    final_state (b, h, p, n)), in x's dtype."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"ssd_impl {impl!r}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    l = min(chunk, s)
    pad = (-s) % l
    s_orig = s
    if pad:
        # zero-pad to a chunk multiple: dt = 0 rows carry no state update
        # (dA = 0, w * dt = 0), so the recurrence is exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // l
    xc = x.reshape(b, nc, l, h, p)
    dtc = dt.reshape(b, nc, l, h)
    Bc = B.reshape(b, nc, l, h, n)
    Cc = C.reshape(b, nc, l, h, n)

    seg = torch.cumsum(dtc * A, dim=2)                  # (b, nc, l, h)

    if impl == "pallas":
        def to_bh(a):                 # (b, nc, l, h, ...) -> (b*h, nc, l, ...)
            return a.movedim(3, 1).reshape(
                (b * h, nc, l) + tuple(a.shape[4:])).contiguous()
        yk, sk = SsdIntraChunkFn.apply(
            to_bh(xc), dtc.movedim(3, 1).reshape(b * h, nc, l).contiguous(),
            A.float().expand(b, h).reshape(b * h).contiguous(),
            to_bh(Bc), to_bh(Cc))
        y_intra = yk.reshape(b, h, nc, l, p).movedim(1, 3).to(x.dtype)
        # the kernel's (n, p) summaries -> (b, nc, h, p, n)
        s_chunk = sk.reshape(b, h, nc, n, p).transpose(-1, -2)
        s_chunk = s_chunk.movedim(1, 2).to(x.dtype)
    else:
        cb = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc)     # (b,nc,h,l,l)
        dlog = seg[..., :, None, :] - seg[..., None, :, :]  # (b,nc,l,m,h)
        mask = torch.ones((l, l), dtype=torch.bool,
                          device=x.device).tril()[None, None, :, :, None]
        dlog = torch.where(mask, dlog, torch.full((), NEG_INF,
                                                  device=x.device))
        decay = torch.exp(dlog).movedim(-1, 2)              # (b,nc,h,l,m)
        scores = cb * decay
        scores = scores * dtc.transpose(-1, -2)[:, :, :, None, :]
        y_intra = torch.einsum("bchlm,bcmhp->bclhp", scores.to(x.dtype), xc)
        w = torch.exp(seg[:, :, -1:, :] - seg) * dtc        # (b,nc,l,h)
        s_chunk = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc, w.to(x.dtype),
                               xc)

    # inter-chunk recurrence: a short loop over the nc chunk states
    chunk_decay = torch.exp(seg[:, :, -1, :])           # (b, nc, h)
    S = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
         if initial_state is None else initial_state.to(x.dtype))
    prevs = []
    for ci in range(nc):
        prevs.append(S)
        S = S * chunk_decay[:, ci, :, None, None].to(x.dtype) + s_chunk[:, ci]
    S_prevs = torch.stack(prevs, dim=1)                 # (b, nc, h, p, n)

    # inter-chunk contribution: y_i += exp(seg_i) C_i . S_prev
    y_inter = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, S_prevs,
                           torch.exp(seg).to(x.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], S


def ssd_step(state, x, dt, A, B, C):
    """Single-token recurrence.  state: (b, h, p, n); x: (b, h, p); dt:
    (b, h); B, C: (b, h, n).  Returns (new_state, y (b, h, p))."""
    da = torch.exp(dt * A)                              # (b, h)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt.to(x.dtype), B, x)
    state = state * da[:, :, None, None].to(x.dtype) + upd
    y = torch.einsum("bhn,bhpn->bhp", C, state)
    return state, y


# ------------------------------------------------------------ depthwise conv

def _depthwise(window, w, b_, c: int):
    """Depthwise causal conv of width W over `window` (b, W-1+c, ch):
    out[t] = sum_k window[t+k] * w[k] + b_, as W shifted products summed
    in f32 and rounded to the window's dtype once, then the bias added in
    that dtype (the reference's conv, then its bias add).  Written out
    rather than `F.conv1d`, which cuDNN would run in TF32 for f32."""
    width = w.shape[0]
    acc = window[:, 0:c].float() * w[0].float()
    for k in range(1, width):
        acc = acc + window[:, k:k + c].float() * w[k].float()
    return acc.to(window.dtype) + b_


def causal_conv_apply(w, b_, x):
    """Depthwise causal conv over a whole sequence.  w: (width, ch); x:
    (b, s, ch)."""
    window = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return _depthwise(window, w, b_, x.shape[1])


def causal_conv_step(w, b_, conv_cache, x_new):
    """conv_cache: (b, width-1, ch); x_new: (b, ch).  Returns (new cache,
    y (b, ch))."""
    window = torch.cat([conv_cache, x_new[:, None, :]], dim=1)
    return window[:, 1:], _depthwise(window, w, b_, 1)[:, 0]


# ------------------------------------------------------------- mamba2 block

def block_init(gen, cfg: ModelConfig, device):
    d, di = cfg.d_model, cfg.ssm_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    proj_out = 2 * di + 2 * g * n + h
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    pd = cfg.params_dtype
    return {
        "in_proj": L._normal(gen, (d, proj_out), std, pd, device),
        "conv_w": L._normal(gen, (cfg.conv_width, cfg.conv_channels), 0.2,
                            pd, device),
        "conv_b": torch.zeros((cfg.conv_channels,), dtype=pd, device=device),
        "dt_bias": torch.zeros((h,), dtype=pd, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)
                           ).to(pd),
        "D": torch.ones((h,), dtype=pd, device=device),
        "norm": L.rmsnorm_init(cfg, device, di),
        "out_proj": L._normal(gen, (di, d), out_std, pd, device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di = cfg.ssm_inner
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + cfg.conv_channels]
    dt = zxbcdt[..., di + cfg.conv_channels:]
    return z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC):
    di, g, n = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state
    return xBC[..., :di], xBC[..., di:di + g * n], xBC[..., di + g * n:]


def _expand_groups(cfg: ModelConfig, bc):
    """(b, ..., g*n) -> (b, ..., h, n) repeated over the heads of each
    group."""
    lead = bc.shape[:-1]
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return bc.reshape(*lead, g, n).repeat_interleave(h // g, dim=len(lead))


def _dt_and_A(p, dt):
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def block_apply(p, cfg: ModelConfig, u, initial_state=None,
                return_state=False):
    """u: (b, s, d) -> (b, s, d), a whole sequence (prefill).  With
    `return_state` also (final SSM state (b, h, p, n), conv tail (b,
    width-1, channels))."""
    b, s, _ = u.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, L.matmul(u, p["in_proj"]))
    xBC = L.silu(causal_conv_apply(p["conv_w"], p["conv_b"], xBC))
    x, B, C = _split_xbc(cfg, xBC)
    x = x.reshape(b, s, h, pdim)
    B = _expand_groups(cfg, B)
    C = _expand_groups(cfg, C)
    dt, A = _dt_and_A(p, dt)
    y, S = ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk, initial_state,
                       impl=cfg.ssd_impl)
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y.reshape(b, s, cfg.ssm_inner)
    y = L.rmsnorm_apply(p["norm"], y * L.silu(z), cfg.norm_eps)
    out = L.matmul(y, p["out_proj"])
    if return_state:
        return out, (S, _conv_tail(cfg, u, p))
    return out


def _conv_tail(cfg: ModelConfig, u, p):
    """The last (width-1) pre-conv xBC rows — the decode conv cache —
    with zero rows before position 0 when the sequence is shorter."""
    w1 = cfg.conv_width - 1
    _, xBC, _ = _split_proj(cfg, L.matmul(u[:, -w1:], p["in_proj"]))
    return F.pad(xBC, (0, 0, w1 - xBC.shape[1], 0))


def block_prefill_chunk(p, cfg: ModelConfig, u, conv_cache, ssm_state,
                        valid):
    """Stateful RAGGED-chunk prefill: continue each row mid-prompt.

    u: (b, c, d) chunk inputs; conv_cache: (b, width-1, conv_channels)
    pre-activation xBC tail of the previous chunk (zeros at a prompt's
    first chunk); ssm_state: (b, h, p, n); valid: (b, c) bool.  Invalid
    positions carry no state update (their dt is forced to 0), so the
    returned state and conv tail are those after each row's LAST VALID
    token.  Returns (y (b, c, d), new_conv_cache, new_ssm_state)."""
    b, c, _ = u.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.conv_width
    z, xBC, dt = _split_proj(cfg, L.matmul(u, p["in_proj"]))
    window = torch.cat([conv_cache, xBC], dim=1)        # (b, w-1+c, ch)
    xBC = L.silu(_depthwise(window, p["conv_w"], p["conv_b"], c))
    x, B, C = _split_xbc(cfg, xBC)
    x = x.reshape(b, c, h, pdim)
    B = _expand_groups(cfg, B)
    C = _expand_groups(cfg, C)
    dt, A = _dt_and_A(p, dt)
    dt = dt * valid[:, :, None].float()                  # ragged tail: no-op
    y, S = ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk, ssm_state,
                       impl=cfg.ssd_impl)
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y.reshape(b, c, cfg.ssm_inner)
    y = L.rmsnorm_apply(p["norm"], y * L.silu(z), cfg.norm_eps)
    # conv tail = the last (w-1) VALID window rows: window[clen : clen+w-1]
    clen = valid.sum(dim=1)
    idx = clen[:, None] + torch.arange(w - 1, device=u.device)[None, :]
    new_conv = torch.gather(window, 1, idx[:, :, None].expand(
        b, w - 1, window.shape[-1]))
    return L.matmul(y, p["out_proj"]), new_conv, S


def block_step(p, cfg: ModelConfig, u, conv_cache, ssm_state):
    """Single token.  u: (b, d).  Returns (y (b, d), conv_cache,
    ssm_state)."""
    b = u.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, L.matmul(u, p["in_proj"]))
    conv_cache, xBC = causal_conv_step(p["conv_w"], p["conv_b"], conv_cache,
                                       xBC)
    x, B, C = _split_xbc(cfg, L.silu(xBC))
    x = x.reshape(b, h, pdim)
    B = _expand_groups(cfg, B)
    C = _expand_groups(cfg, C)
    dt, A = _dt_and_A(p, dt)
    ssm_state, y = ssd_step(ssm_state, x, dt, A, B, C)
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y.reshape(b, cfg.ssm_inner)
    y = L.rmsnorm_apply(p["norm"], y * L.silu(z), cfg.norm_eps)
    return L.matmul(y, p["out_proj"]), conv_cache, ssm_state


def block_axes():
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("norm", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "dt_bias": ("ssm_heads",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def layer_axes(cfg: ModelConfig):
    return {"ln": L.rmsnorm_axes(), "mixer": block_axes()}


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


def layer_init(gen, cfg: ModelConfig, device):
    return {"ln": L.rmsnorm_init(cfg, device),
            "mixer": block_init(gen, cfg, device)}


# ------------------------------------------------------------------- model

def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters of the ssm family with the reference's
    names, shapes, layouts and standard deviations (drawn from a
    `torch.Generator` on `device`, not the reference's bits)."""
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


# ----------------------------------------------------------------- serving

# SSM state is O(1) per sequence — nothing to page; the engine serves
# this family from the contiguous layout.
init_paged_cache = None
paged_prefill = None
paged_decode_step = None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int = 0, dtype=None,
               *, device):
    """O(1) in sequence length (max_seq unused)."""
    dtype = dtype or cfg.compute_dtype
    n = cfg.num_layers
    return {
        "conv": torch.zeros((n, batch, cfg.conv_width - 1,
                             cfg.conv_channels), dtype=dtype, device=device),
        "ssm": torch.zeros((n, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_axes():
    """The reference's logical axes of each cache leaf."""
    return {
        "conv": (None, "act_batch", None, "ssm_inner"),
        "ssm": (None, "act_batch", "act_ssm_heads", None, None),
        "pos": ("act_batch",),
    }


def prefill(params, cfg: ModelConfig, batch, cache):
    """Whole prompts: each layer's final conv tail and SSM state land in
    the cache, in place.  Returns (cache, logits at the last position
    (b, vocab))."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = L.embed_tokens(params["embed"], cfg, tokens)
    for layer, p in enumerate(params["layers"]):
        hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
        out, (S, tail) = block_apply(p["mixer"], cfg, hn, return_state=True)
        x = x + out
        cache["conv"][layer].copy_(tail)
        cache["ssm"][layer].copy_(S)
    cache["pos"].fill_(s)
    h = L.rmsnorm_apply(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return cache, logits[:, 0]


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One token for every row (idle rows advance too, as in the
    reference).  Returns (cache, logits (b, vocab))."""
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])[:, 0]   # (b, d)
    for layer, p in enumerate(params["layers"]):
        conv, ssm = cache["conv"][layer], cache["ssm"][layer]
        hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
        y, conv_c, ssm_c = block_step(p["mixer"], cfg, hn, conv, ssm)
        x = x + y
        conv.copy_(conv_c)
        ssm.copy_(ssm_c)
    cache["pos"].add_(1)
    h = L.rmsnorm_apply(params["ln_f"], x[:, None], cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return cache, logits[:, 0]


# ---------------------------------------------------------------- training

def _layer_apply(p, cfg: ModelConfig, x):
    return x + block_apply(p["mixer"], cfg,
                           L.rmsnorm_apply(p["ln"], x, cfg.norm_eps))


def forward_hidden(params, cfg: ModelConfig, x):
    """x: (b, s, d) embedded input -> final hidden states (after the final
    norm); each layer runs under `cfg.remat` (`transformer._maybe_remat`)
    and writes no cache."""
    body = T._maybe_remat(_layer_apply, cfg)
    for p in params["layers"]:
        x = body(p, cfg, x)
    return L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (b, s)} -> logits (b, s, vocab)."""
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    h = forward_hidden(params, cfg, x)
    return L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens", "labels": (b, s)} -> mean next-token CE (f32
    scalar; labels < 0 are ignored)."""
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    h = forward_hidden(params, cfg, x)
    return L.lm_loss(h, T.head_weights(params, cfg), cfg, batch["labels"])
