"""Mamba-2 (SSD, state-space duality) blocks: the serving subset the
hybrid family runs.

Port of `repro.models.mamba2`: the chunked SSD scan, the single-token
recurrence, the depthwise causal conv and the stateful block bodies
(`block_prefill_chunk`, `block_step`).  Within a chunk the SSD is its
dual (masked decay-weighted "attention") form; across chunks a short
Python loop over the chunk states carries the recurrence, where the
reference scans.  `ssd_impl="pallas"` takes the intra-chunk part
through the SSD kernel (`kernels/ssd_scan`), `"xla"` through the plain
torch form of the reference's XLA branch.

The pure-SSM family (mamba2-130m) serves from the contiguous layout in
the reference; it waits for the slice that ports that layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L

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
        yk, sk, _ = ssd_intra_chunk(
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
    z, xBC, dt = _split_proj(cfg, u @ p["in_proj"])
    window = torch.cat([conv_cache, xBC], dim=1)        # (b, w-1+c, ch)
    xBC = F.silu(_depthwise(window, p["conv_w"], p["conv_b"], c))
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
    y = L.rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    # conv tail = the last (w-1) VALID window rows: window[clen : clen+w-1]
    clen = valid.sum(dim=1)
    idx = clen[:, None] + torch.arange(w - 1, device=u.device)[None, :]
    new_conv = torch.gather(window, 1, idx[:, :, None].expand(
        b, w - 1, window.shape[-1]))
    return y @ p["out_proj"], new_conv, S


def block_step(p, cfg: ModelConfig, u, conv_cache, ssm_state):
    """Single token.  u: (b, d).  Returns (y (b, d), conv_cache,
    ssm_state)."""
    b = u.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, u @ p["in_proj"])
    conv_cache, xBC = causal_conv_step(p["conv_w"], p["conv_b"], conv_cache,
                                       xBC)
    x, B, C = _split_xbc(cfg, F.silu(xBC))
    x = x.reshape(b, h, pdim)
    B = _expand_groups(cfg, B)
    C = _expand_groups(cfg, C)
    dt, A = _dt_and_A(p, dt)
    ssm_state, y = ssd_step(ssm_state, x, dt, A, B, C)
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y.reshape(b, cfg.ssm_inner)
    y = L.rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], conv_cache, ssm_state


def layer_init(gen, cfg: ModelConfig, device):
    return {"ln": L.rmsnorm_init(cfg, device),
            "mixer": block_init(gen, cfg, device)}
