"""A trace of one call of the port's step: the counterpart of lowered HLO.

The reference lowers a jitted step to an XLA program and reads its HLO
text (`launch/hlo_analysis.py`).  The port's steps run eagerly, so the
port records what one call dispatches instead: `Trace` is a
`TorchDispatchMode` that sees every aten op below autograd (forward,
backward and remat recomputes alike) on "meta", CPU and CUDA tensors.
For each op it keeps:

  * the op's name (`aten.mm.default`);
  * its result type in the reference's HLO type syntax (`f32[2,8,8,4,16]`,
    tuples `(f32[2], s32[2])`), so `serve_step.bulk_attn_shapes` strings
    and `bytes_by_shape` keys carry over unchanged;
  * its result bytes and its operand bytes;
  * whether its result is a fresh buffer (a view writes nothing);
  * its FLOPs, from `torch.utils.flop_counter`'s formulas (mm, bmm,
    addmm, baddbmm, convolutions, SDPA; einsum and matmul reach these).

A dispatch mode does not see what the hand-written kernels do: they are
launched through ctypes (`kernels/build.py`).  So each kernel wrapper in
`kernels/*/ops.py` reports its own launch to the active traces
(`kernel`): its name, FLOPs and bytes (the counts behind PERF.md §6's
bounds), and its outputs' types.  The buffers a wrapper allocates are
aten ops, so they appear as ops too.  Every cross-rank or cross-bank
move of `distribution/collectives.py` reports a `CollectiveRecord`
(`collective`): its HLO kind, its counter name and its result bytes.

`Trace.summary()` gives the fields of the reference's `HloSummary`
(flops, bytes read and written, collective wire bytes and counts by
kind, `bytes_by_shape`).  Traffic is eager traffic: every op that is
not a view reads its operands and writes its result (PyTorch fuses
nothing here, where XLA fuses elementwise chains); a kernel counts the
bytes it reports.  `peak_live_bytes` is the peak of the bytes held at
once by the tensors the call allocated (fresh results, tracked by
weakref until freed), outputs included: the caching allocator's peak
without its rounding.

The active traces are process-wide, not per thread: on CUDA the
autograd engine runs a backward on a thread of its own, and the mode's
state travels there with it.
"""
from __future__ import annotations

import functools
import math
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.uint16: "u16", torch.uint32: "u32", torch.uint64: "u64",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

# ops that allocate without writing (their buffer is written by the op
# or kernel that fills it) or only relabel a tensor
_NO_TRAFFIC = {
    "aten.empty.memory_format", "aten.empty_like.default",
    "aten.empty_strided.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.detach.default",
    "aten.lift_fresh.default", "aten.alias.default",
    "aten._local_scalar_dense.default", "aten.set_.source_Storage",
    "aten.set_.source_Storage_storage_offset",
}

# the ops that copy between devices, and the host's read of one value
_COPIES = {"aten._to_copy.default", "aten.copy_.default",
           "aten.copy.default", "aten._copy_from.default",
           "aten._copy_from_and_resize.default"}
_SCALAR_READ = "aten._local_scalar_dense.default"

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
HAND = "hand"      # a sharded arena's lead <-> bank move


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def type_str(shape, dtype: torch.dtype) -> str:
    """`f32[2,8]`: a shape and dtype in HLO type syntax."""
    return f"{dtype_name(dtype)}[{','.join(map(str, map(int, shape)))}]"


def tensor_type(t: torch.Tensor) -> str:
    return type_str(t.shape, t.dtype)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes crossing the interconnect per rank, the reference's ring
    accounting (`hlo_analysis.Op.wire_bytes`): all-gather result (n-1)/n,
    all-reduce 2 result (n-1)/n, reduce-scatter result (n-1), all-to-all
    result (n-1)/n; a permute or a hand, the result."""
    n = max(n, 1)
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    return float(result_bytes)


# ----------------------------------------------------------------- records

@dataclass
class TracedOp:
    name: str
    result_type: str
    result_bytes: int
    operand_bytes: int
    flops: float
    fresh: bool                  # a new buffer (not a view or in place)
    view: bool                   # a view: no traffic
    operands: tuple = ()         # (type, bytes) of each operand


@dataclass
class KernelRecord:
    """One launch of a hand-written kernel, as its wrapper reports it."""
    name: str
    flops: float
    bytes_read: float
    bytes_written: float
    outputs: tuple = ()          # the outputs' types


@dataclass
class CollectiveRecord:
    """One collective (or hand) call of `distribution/collectives.py`."""
    kind: str                    # an HLO kind of COLLECTIVE_KINDS, or HAND
    name: str                    # its counter name in `collectives.STATS`
    result_type: str
    result_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        return wire_bytes(self.kind, self.result_bytes, self.group_size)


@dataclass
class TraceSummary:
    """The fields of `hlo_analysis.HloSummary`, from a trace."""
    flops: float = 0.0
    bytes_written: float = 0.0
    bytes_read: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_count: dict = field(default_factory=dict)
    flops_by_op: dict = field(default_factory=dict)
    bytes_by_shape: dict = field(default_factory=dict)
    kernel_flops: float = 0.0
    kernel_launches: dict = field(default_factory=dict)

    @property
    def raw_flops(self) -> float:
        return self.flops               # an eager trace has no loop bodies

    @property
    def hbm_bytes(self) -> float:
        return self.bytes_written + self.bytes_read

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


# -------------------------------------------------------------- the trace

_ACTIVE: list = []
_LOCK = threading.Lock()


def reporter(fn):
    """Decorates a kernel wrapper's report of a launch: it runs only while
    a trace records, and outside the traces' dispatch mode, so its own
    reads (a row's position, an expert's live rows) are not taken for
    the step's ops."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not _ACTIVE:
            return None
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def kernel(name: str, *, flops: float, bytes_read: float,
           bytes_written: float, outputs=()) -> None:
    """Report one kernel launch to every active trace."""
    if not _ACTIVE:
        return
    rec = KernelRecord(name, float(flops), float(bytes_read),
                       float(bytes_written),
                       tuple(tensor_type(o) for o in outputs
                             if isinstance(o, torch.Tensor)))
    with _LOCK:
        for tr in _ACTIVE:
            tr.kernels.append(rec)


def collective(kind: str, name: str, shape, dtype, group_size: int) -> None:
    """Report one collective (or hand) call, by its result's shape."""
    if not _ACTIVE:
        return
    rec = CollectiveRecord(kind, name, type_str(shape, dtype),
                           math.prod(shape) * _itemsize(dtype),
                           int(group_size))
    with _LOCK:
        for tr in _ACTIVE:
            tr.collectives.append(rec)


def _itemsize(dtype) -> int:
    return dtype.itemsize


def _tensors(items) -> list:
    """The tensors among `items`, looking one level into lists and
    tuples (an aten op's arguments and results nest no deeper)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _transfers(name: str, rtype: str, ins, outs) -> list:
    """(result type, from device type, to device type) for each device
    an op's operands lie on other than its result's: `x.to(...)`, and
    `dst.copy_(src)`, whose source is an operand beside the destination.
    A 0-dim CPU operand of another op is a scalar argument, not a copy."""
    dst = outs[0].device.type
    copy = name in _COPIES
    return [(rtype, src, dst) for src in sorted(
        {t.device.type for t in ins
         if copy or t.dim() or t.device.type != "cpu"} - {dst})]


def _release(live: list, n: int) -> None:
    live[0] -= n


def _extra_flops(name: str, args, out) -> float:
    """FLOPs of the products `torch.utils.flop_counter` leaves out."""
    if name.startswith("aten.mv.") or name.startswith("aten.dot."):
        return 2.0 * args[0].numel()
    return 0.0


class Trace(TorchDispatchMode):
    """Records every aten op dispatched while it is entered (`with
    Trace() as tr:`), with the kernels and collectives reported to it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.ops: list[TracedOp] = []
        self.kernels: list[KernelRecord] = []
        self.collectives: list[CollectiveRecord] = []
        # the bytes the call's fresh buffers hold now: a box their
        # finalizers share, so that they hold no reference to the trace
        # (whose `output` would then outlive every caller)
        self._live = [0]
        self.peak_live_bytes = 0
        self.output = None           # the traced call's result (trace_call)
        # (result type, from device type, to device type) of each copy
        # between devices (`_transfers`) and each value the host reads
        # off the card (`.item()`: the operand's type, to "cpu")
        self.transfers: list = []
        self._depth = 0
        self._info: dict = {}

    def _op_info(self, func):
        """(name, view, aliased, decomposes) of an op overload, cached."""
        info = self._info.get(func)
        if info is None:
            info = (str(func), bool(getattr(func, "is_view", False)),
                    any(r.alias_info is not None
                        for r in func._schema.returns),
                    func.namespace != "prim"      # `prim::device`
                    and torch._C._dispatch_has_kernel_for_dispatch_key(
                        func.name(),
                        torch._C.DispatchKey.CompositeImplicitAutograd))
            self._info[func] = info
        return info

    def __enter__(self):
        with _LOCK:
            if self._depth == 0:
                _ACTIVE.append(self)
            self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        with _LOCK:
            self._depth -= 1
            if self._depth == 0:
                _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def live_bytes(self) -> int:
        return self._live[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, view, aliased, composite = self._op_info(func)
        packet = func._overloadpacket
        if name == _SCALAR_READ and args[0].device.type != "cpu":
            # `.item()`, `bool(t)`: the card's value read by the host,
            # recorded before the read (a fake or meta tensor has none)
            self.transfers.append((tensor_type(args[0]),
                                   args[0].device.type, "cpu"))
        if composite and packet not in self._flops:
            # an op autograd would have decomposed (inference mode lets
            # matmul, einsum, reshape through whole): trace its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs.values())
        outs = _tensors((out,))
        flops = 0.0
        if packet in self._flops:
            flops = float(self._flops[packet](*args, **kwargs, out_val=out))
        else:
            flops = _extra_flops(name, args, out)
        if len(outs) == 1 and not isinstance(out, (tuple, list)):
            rtype = tensor_type(outs[0])
        else:
            rtype = "(" + ", ".join(tensor_type(t) for t in outs) + ")"
        rbytes = sum(nbytes(t) for t in outs)
        if outs:
            self.transfers += _transfers(name, rtype, ins, outs)
        traffic = not view and name not in _NO_TRAFFIC
        op = TracedOp(name, rtype, rbytes if traffic else 0,
                      sum(nbytes(t) for t in ins) if traffic else 0,
                      flops, fresh=not aliased, view=view,
                      operands=tuple((tensor_type(t), nbytes(t))
                                     for t in ins) if traffic else ())
        with _LOCK:
            self.ops.append(op)
            if not aliased:
                for t in outs:
                    n = nbytes(t)
                    self._live[0] += n
                    weakref.finalize(t, _release, self._live, n)
                self.peak_live_bytes = max(self.peak_live_bytes,
                                           self._live[0])
        return out

    # ---------------------------------------------------------- queries

    def allocated_types(self) -> set[str]:
        """Result types of every fresh buffer the call made."""
        out = set()
        for op in self.ops:
            if op.fresh:
                t = op.result_type
                out.update(t[1:-1].split(", ") if t.startswith("(") else [t])
        return out

    def result_types(self) -> set[str]:
        """Result types of every op, views included."""
        out = set()
        for op in self.ops:
            t = op.result_type
            out.update(t[1:-1].split(", ") if t.startswith("(") else [t])
        return out

    def allocates(self, type_string: str) -> bool:
        return type_string in self.allocated_types()

    def summary(self) -> TraceSummary:
        s = TraceSummary()
        for op in self.ops:
            if op.flops:
                s.flops += op.flops
                s.flops_by_op[op.name] = s.flops_by_op.get(op.name, 0.0) \
                    + op.flops
            if op.view or not (op.result_bytes or op.operand_bytes):
                continue
            s.bytes_written += op.result_bytes
            s.bytes_read += op.operand_bytes
            if not op.result_type.startswith("("):
                s.bytes_by_shape[op.result_type] = \
                    s.bytes_by_shape.get(op.result_type, 0.0) \
                    + op.result_bytes
            for t, n in op.operands:
                s.bytes_by_shape[t] = s.bytes_by_shape.get(t, 0.0) + n
        for k in self.kernels:
            s.flops += k.flops
            s.kernel_flops += k.flops
            s.flops_by_op[k.name] = s.flops_by_op.get(k.name, 0.0) + k.flops
            s.bytes_read += k.bytes_read
            s.bytes_written += k.bytes_written
            s.kernel_launches[k.name] = s.kernel_launches.get(k.name, 0) + 1
        for c in self.collectives:
            s.collective_bytes[c.kind] = s.collective_bytes.get(c.kind, 0.0) \
                + c.wire_bytes
            s.collective_count[c.kind] = s.collective_count.get(c.kind, 0) + 1
        return s


def tensors_bytes(*ts) -> int:
    """Bytes of the tensors given (None skipped): each read or written
    once."""
    return sum(nbytes(t) for t in ts if isinstance(t, torch.Tensor))


def seen_pairs(sq: int, skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs attention computes for one row and head: all
    sq x skv, or under causality the keys at or before each query's
    position q_offset + i."""
    if not causal:
        return sq * skv
    total = 0
    for i in range(sq):
        total += min(skv, max(0, q_offset + i + 1))
    return total


def trace_call(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the Trace of that one call)."""
    with Trace() as tr:
        out = fn(*args, **kwargs)
    tr.output = out
    return out, tr
