"""Every cross-rank move of the port: the sharded training step's
collectives, the compressed and bucketed gradient reductions, and the
near-memory attention merge of a sharded page arena.

Port of `repro.distribution.collectives`.  The reference writes its
collectives inside `shard_map` regions and leaves the rest to XLA's SPMD
partitioner; PyTorch has no partitioner, so the port runs one process per
mesh position (`launch/mesh.py` `Mesh.bind`) and makes every move itself,
here, on `torch.distributed` process groups (`AxisGroup`: the group of
one mesh axis through this rank).  Every tensor that crosses ranks goes
through this module, so each collective's bytes are counted (`STATS`).

The transport: on NCCL every primitive takes the card's tensors.  On
gloo (CPU ranks, or several ranks time-sharing one card, where NCCL
refuses) a collective that gloo cannot run on CUDA tensors is staged
through pinned host memory, explicitly, in `_run`, and counted as
staged (`GLOO_CUDA_OK` names the primitives gloo takes on CUDA tensors,
as `benchmarks/gloo_cuda_probe.py` measured them).  Compute never leaves
the card: only the message does.

Autograd sees these collectives, as `torch.autograd.Function`s:
  * `AllGather`: all-gather along dimensions; its backward is the
    reduce-scatter (or, given a `sink`, the whole gradient handed to the
    sink, so the sharded step reduces once after its accumulation);
  * `ReduceFromTP`: the row-parallel all-reduce of a partial activation;
    its backward is the identity;
  * `CopyToTP`: the copy of a replicated activation into a
    tensor-parallel region; its backward is the all-reduce.
`mark_tp` tags a weight that the step keeps as this rank's tensor-parallel
slice (its model-axis group); the layers read the tag (`tp_group`).

The int8 wire format (`quantize_int8`, `ring_allreduce_int8`,
`compressed_tree_psum` with its error-feedback buffers) and the bucketed
psum (`bucket_psum`) follow the reference's arithmetic.

`combine_shard_partials` is the serving-side summary merge (DESIGN.md
§2): each bank of a sharded arena computes attention over its RESIDENT
pages only and hands its online-softmax carry (m, l, acc) to the lead
device: (batch, heads(, head_dim))-sized summaries, never pages.  There
the summaries are stacked as the splits of one split-KV merge and folded
into the exact global softmax by log-sum-exp: the combine kernel of
`kernels/decode_attention` on the card (`combine_splits_kernel`), its
plain version (`combine_splits`) on the CPU.  A bank with no resident
page for a row contributes (m = -1e30, l = 0, acc = 0), which the merge
weights 0.  `hand` is the one way a tensor moves between the lead device
and a bank (on one card, nothing moves).
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass

import torch

from repro_torch.kernels.decode_attention.ops import (combine_splits,
                                                      combine_splits_kernel)


# ------------------------------------------------------------ the groups

@dataclass(frozen=True)
class AxisGroup:
    """The ranks along one mesh axis (or the data-parallel axes, "dp")
    through this rank: `pg` their process group (None for one rank),
    `ranks` their global ranks in axis order, `index` this rank's
    position among them."""
    name: str
    pg: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


# ------------------------------------------------- transport and counting

class Transport:
    """The bytes each collective moved since `reset` (by name: bytes and
    calls), and how many messages were staged through host memory."""

    def __init__(self):
        self.bytes = defaultdict(int)
        self.calls = defaultdict(int)
        self.staged = 0

    def reset(self):
        self.bytes.clear()
        self.calls.clear()
        self.staged = 0

    def count(self, name: str, nbytes: int):
        self.bytes[name] += int(nbytes)
        self.calls[name] += 1

    def report(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "staged_through_host": self.staged,
                "gloo_cuda_ok": sorted(GLOO_CUDA_OK)}


STATS = Transport()
PRIMITIVES = ("all_reduce", "all_gather", "reduce_scatter", "send_recv")
# The primitives gloo runs on CUDA tensors itself; the others are staged
# through pinned host memory.  A primitive gloo cannot run on a CUDA
# tensor may abort the process (its TCP transport writes from the device
# pointer), so this is not probed in a training run: it was measured by
# `benchmarks/gloo_cuda_probe.py`, which tries each primitive in a world
# of its own (torch 2.11.0+cu128 on an NVIDIA H100 80GB HBM3: all-reduce
# and all-gather ok, the send/recv of a ring raises).
GLOO_CUDA_OK = frozenset({"all_reduce", "all_gather", "reduce_scatter"})


def _backend(g: AxisGroup) -> str:
    import torch.distributed as dist
    return dist.get_backend(g.pg)


def _needs_staging(g: AxisGroup, prim: str, x: torch.Tensor) -> bool:
    if not x.is_cuda or _backend(g) != "gloo":
        return False
    return prim not in GLOO_CUDA_OK


def _pinned(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _raw_all_reduce(x, g, op):
    import torch.distributed as dist
    dist.all_reduce(x, op=op, group=g.pg)


def _raw_all_gather(x, g):
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(parts, x, group=g.pg)
    return parts


def _raw_reduce_scatter(x, g):
    """x: (n * m, ...) -> this rank's (m, ...) block of the sum."""
    import torch.distributed as dist
    if _backend(g) == "nccl":
        out = torch.empty((x.shape[0] // g.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=g.pg)
        return out
    buf = x.clone()
    dist.all_reduce(buf, group=g.pg)
    return buf.chunk(g.size)[g.index].clone()


def _raw_shift(x, g, shift):
    """Send x to the rank `shift` places on along the axis ring, receive
    from the rank `shift` places back (both posted at once: a blocking
    send then receive deadlocks)."""
    import torch.distributed as dist
    n = g.size
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, g.ranks[(g.index + shift) % n], g.pg),
           dist.P2POp(dist.irecv, out, g.ranks[(g.index - shift) % n], g.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _sum():
    import torch.distributed as dist
    return dist.ReduceOp.SUM


def _run(prim: str, g: AxisGroup, x: torch.Tensor, fn):
    """fn(x) on the transport: staged through pinned host memory where
    gloo cannot take a CUDA tensor; the result comes back to x's device."""
    if not _needs_staging(g, prim, x):
        return fn(x)
    STATS.staged += 1
    out = fn(_pinned(x))
    if isinstance(out, list):
        return [o.to(x.device, non_blocking=True) for o in out]
    return out.to(x.device, non_blocking=True)


# -------------------------------------------------------------- primitives

def all_reduce(x: torch.Tensor, g: AxisGroup, op: str = "sum",
               name: str = "all_reduce") -> torch.Tensor:
    """The sum (or "max") of x over the group's ranks: a new tensor."""
    if g is None or g.size == 1:
        return x
    import torch.distributed as dist
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    STATS.count(name, _nbytes(x))

    def fn(buf):
        buf = buf.clone() if buf is x else buf
        _raw_all_reduce(buf, g, rop)
        return buf
    return _run("all_reduce", g, x.contiguous(), fn)


def all_gather(x: torch.Tensor, g: AxisGroup, dim: int = 0,
               name: str = "all_gather") -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in axis order."""
    if g is None or g.size == 1:
        return x
    STATS.count(name, _nbytes(x) * g.size)
    parts = _run("all_gather", g, x.contiguous(),
                 lambda buf: _raw_all_gather(buf, g))
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, g: AxisGroup, dim: int = 0,
                   name: str = "reduce_scatter") -> torch.Tensor:
    """This rank's block along `dim` of the sum of x over the group."""
    if g is None or g.size == 1:
        return x
    STATS.count(name, _nbytes(x))
    xm = x.movedim(dim, 0).contiguous()
    out = _run("reduce_scatter", g, xm,
               lambda buf: _raw_reduce_scatter(buf, g))
    return out.movedim(0, dim)


def ring_shift(x: torch.Tensor, g: AxisGroup, shift: int = 1,
               name: str = "ring") -> torch.Tensor:
    """x handed `shift` ranks on along the group's ring; returns what
    the rank `shift` back handed here."""
    if g is None or g.size == 1:
        return x
    STATS.count(name, _nbytes(x))
    return _run("send_recv", g, x.contiguous(),
                lambda buf: _raw_shift(buf, g, shift))


# --------------------------------------------------- autograd collectives

class AllGather(torch.autograd.Function):
    """All-gather along each (group, dim) of `gathers` in turn (none: the
    identity); backward: the reduce-scatters in the reverse order, or,
    given a `sink`, the whole gradient handed to `sink(dy)` and none for
    the input (the sharded step's deferred reduction)."""

    @staticmethod
    def forward(ctx, x, gathers, sink):
        ctx.gathers, ctx.sink = gathers, sink
        y = x
        for g, dim in gathers:
            y = all_gather(y, g, dim, name="fsdp_all_gather")
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, dy):
        if ctx.sink is not None:
            ctx.sink(dy)
            return None, None, None
        for g, dim in reversed(ctx.gathers):
            dy = reduce_scatter(dy, g, dim)
        return dy, None, None


class ReduceFromTP(torch.autograd.Function):
    """The row-parallel all-reduce over the model axis; backward: the
    identity (every rank holds the same gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x, g, name="tp_all_reduce")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class CopyToTP(torch.autograd.Function):
    """A replicated activation entering a tensor-parallel region: the
    identity forward; backward: the all-reduce of the ranks' partial
    gradients."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.g, name="tp_grad_all_reduce"), None


def all_gather_grad(x, gathers, sink=None):
    """`AllGather` of x over [(group, dim), ...]."""
    return AllGather.apply(x, tuple(gathers), sink)


def reduce_from_tp(x, g: AxisGroup):
    if g is None or g.size == 1:
        return x
    return ReduceFromTP.apply(x, g)


def copy_to_tp(x, g: AxisGroup):
    if g is None or g.size == 1:
        return x
    return CopyToTP.apply(x, g)


def mark_tp(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """Tag `t` as this rank's tensor-parallel slice over `g`."""
    t._repro_tp_group = g
    return t


def tp_group(t) -> AxisGroup | None:
    """The model-axis group a weight is this rank's slice over (None: a
    full weight)."""
    return getattr(t, "_repro_tp_group", None)


# ------------------------------------------------------------ quantization

def quantize_int8(x):
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    x = x.float()
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _group(axis) -> AxisGroup:
    """An `AxisGroup`, or a mesh axis name of the current (bound) mesh."""
    if isinstance(axis, AxisGroup):
        return axis
    from repro_torch.distribution.sharding import current_mesh
    mesh = current_mesh()
    if mesh is None or not getattr(mesh, "bound", False):
        raise ValueError(f"axis {axis!r} needs a bound mesh (use_mesh)")
    return mesh.group(axis)


def axis_size(axis) -> int:
    """Size of a mesh axis of the current mesh (or of a group)."""
    if isinstance(axis, AxisGroup):
        return axis.size
    from repro_torch.distribution.sharding import current_mesh
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis!r}: no mesh (use_mesh)")
    return mesh.shape[axis]


def ring_allreduce_int8(x, axis):
    """All-reduce with int8 wire format over `axis` (a group or an axis
    name of the bound mesh).

    Each hop passes the ORIGINAL quantized block one rank along the ring
    and accumulates the dequantized value: n-1 hops, int8 bytes (and one
    f32 scale) on the wire.  Rank i sums its own block, then rank i-1's,
    i-2's, ..., in that order."""
    g = _group(axis)
    q, scale = quantize_int8(x)
    acc = dequantize_int8(q, scale)
    n = g.size
    # one message a hop: the int8 block with its f32 scale's 4 bytes
    msg = torch.cat([q.reshape(-1), scale.reshape(1).view(torch.int8)])
    for _ in range(n - 1):
        msg = ring_shift(msg, g, 1, name="int8_ring")
        acc = acc + dequantize_int8(msg[:-4].view(q.shape),
                                    msg[-4:].view(torch.float32)[0])
    return acc


def compressed_tree_psum(grads, mesh=None, axis: str = "pod",
                         error_feedback=None):
    """int8 ring all-reduce of a gradient tree across `axis`, divided by
    the axis size (a mean).

    grads are this rank's, NOT yet reduced over `axis`.  Each leaf adds
    its error-feedback buffer (f32, zeros at first), is quantized, and the
    quantization error is carried to the next call.  Returns
    (reduced_grads, new_error_feedback)."""
    from repro_torch.utils.tree import tree_map
    if error_feedback is None:
        error_feedback = tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
    grp = mesh.group(axis) if mesh is not None and isinstance(axis, str) \
        else _group(axis)

    def one(g, err):
        x = g.float() + err
        q, scale = quantize_int8(x)
        reduced = ring_allreduce_int8(x, grp) / grp.size
        return reduced.to(g.dtype), x - dequantize_int8(q, scale)

    pairs = tree_map(one, grads, error_feedback)
    red = tree_map(lambda g, p: p[0], grads, pairs)
    err = tree_map(lambda g, p: p[1], grads, pairs)
    return red, err


# ---------------------------------------------------------------- bucketing

def bucket_psum(grads, axis_name, bucket_bytes: int = 4 << 20):
    """Flatten leaves (as f32) into ~bucket_bytes buckets and sum each
    bucket over `axis_name` (an axis of the bound mesh, or a group) in
    one all-reduce: fewer, larger collectives."""
    from repro_torch.utils.tree import tree_leaves, tree_map
    g = _group(axis_name)
    leaves = tree_leaves(grads)
    flat = [l.reshape(-1).float() for l in leaves]
    buckets, cur, cur_bytes = [], [], 0
    for f in flat:
        cur.append(f)
        cur_bytes += f.numel() * 4
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    reduced = []
    for bucket in buckets:
        cat = torch.cat(bucket) if len(bucket) > 1 else bucket[0]
        red = all_reduce(cat, g, name="bucket_all_reduce")
        off = 0
        for f in bucket:
            reduced.append(red[off:off + f.numel()])
            off += f.numel()
    it = iter(zip(reduced, leaves))

    def put(_):
        r, l = next(it)
        return r.reshape(l.shape).to(l.dtype)
    return tree_map(put, grads)


# ------------------------------------------------- near-memory LSE merge

def hand(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`: the same tensor where it already lies there."""
    return x.to(device, non_blocking=True)


def combine_shard_partials(m, l, acc, out_dtype, device=None):
    """Merge per-bank online-softmax partials on the lead device.

    m, l: one (..., hq) f32 tensor per bank; acc: one (..., hq, d) f32
    tensor per bank (the partials-mode output of the paged kernels over
    each bank's resident pages, any leading batch/chunk dims).  They are
    handed to `device` (default: the first bank's), stacked to (B, n,
    hq) and (B, n, hq, d), and merged as n splits.  Returns (..., hq, d)
    in `out_dtype` on `device`."""
    device = torch.device(device) if device is not None else m[0].device
    hq, d = acc[0].shape[-2:]
    lead = tuple(m[0].shape[:-1])
    B = math.prod(lead)
    mg = torch.stack([hand(x, device).reshape(B, hq) for x in m], dim=1)
    lg = torch.stack([hand(x, device).reshape(B, hq) for x in l], dim=1)
    ag = torch.stack([hand(x, device).reshape(B, hq, d) for x in acc], dim=1)
    if device.type == "cpu":
        o = combine_splits(mg, lg, ag, B, hq, d, out_dtype)
    else:
        o = combine_splits_kernel(mg, lg, ag, B, hq, d, out_dtype)
    return o.reshape(*lead, hq, d)
