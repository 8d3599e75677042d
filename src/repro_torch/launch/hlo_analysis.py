"""Structural analysis of compiled (post-SPMD, scheduled) HLO text.

`compiled.cost_analysis()` counts every while body ONCE (verified
empirically: a 6-layer scanned MLP reports one layer of flops), so the
roofline needs its own walker.  This module parses `compiled.as_text()`
into computations/ops, reads each while op's `known_trip_count` from its
backend_config, propagates multipliers through the call graph
(entry=1; while body += caller * trips; fusion/call/to_apply += caller),
and then sums, with multipliers applied:

  * FLOPs          — dot ops (2*prod(result)*prod(contracted)), convs;
  * HBM traffic    — bytes written (result) + bytes read (operands) of
                     every buffer-producing op: post-fusion scheduled HLO
                     means each op is a real buffer, so this is the
                     fusion-aware traffic proxy;
  * collective bytes — per kind (all-gather / all-reduce / ...), result
                     shape bytes.

All shapes in post-SPMD HLO are PER-DEVICE, so the derived roofline
terms are already per-chip:  compute_s = flops / peak_flops_per_chip.

Port of `repro.launch.hlo_analysis`, copied: it reads HLO text (the
reference's dry-run artefacts, or any compiled program's text), so only
this docstring differs.  The port's own steps have no HLO: their
counterpart is a trace of the aten ops one call dispatches
(`launch/trace.py`), summarised into the same fields.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"([a-z]\w*)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(.+?)\s+([a-z][\w\-]*)\((.*)$")
# computation headers start at column 0: `%name (args) -> type {` — args may
# nest parens (tuple-typed params), so match greedily to the arrow.
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%([\w\.\-]+)\s*\(.*\)\s*->.*\{\s*$")
_CALL_ATTRS = ("body", "condition", "to_apply", "calls",
               "true_computation", "false_computation")
_TRIP_RE = re.compile(r'known_trip_count[^\d]*(\d+)')

# ops that are bookkeeping, not buffer traffic
_FREE_OPS = {"parameter", "constant", "tuple", "get-tuple-element",
             "bitcast", "bitcast-convert", "after-all", "iota",
             "partition-id", "replica-id", "opt-barrier", "domain"}

# Standalone elementwise/layout ops: the CPU backend leaves many of these
# unfused ("wrapped" computations), but the TPU backend fuses every such
# chain into its consumer/producer — counting them would overstate HBM
# traffic ~5-10x.  They contribute NO traffic of their own; real
# materialization points (dot/conv, fusion, reduce, DUS, collectives,
# copy, gather/scatter/sort) charge their operand reads at the operand's
# (same-shaped) buffer instead.
_FUSABLE_ELEMENTWISE = {
    "convert", "multiply", "add", "subtract", "divide", "maximum",
    "minimum", "negate", "abs", "exponential", "log", "tanh", "rsqrt",
    "sqrt", "power", "select", "compare", "and", "or", "not", "xor",
    "broadcast", "reshape", "transpose", "slice", "pad", "clamp",
    "concatenate", "floor", "ceil", "sign", "is-finite", "logistic",
    "exponential-minus-one", "cbrt", "reverse", "rem", "shift-left",
    "shift-right-logical", "shift-right-arithmetic", "reduce-precision",
}


def shape_dims(shape_str: str) -> list[tuple[str, list[int]]]:
    out = []
    for m in _SHAPE_RE.finditer(shape_str):
        if m.group(1) not in _DTYPE_BYTES:
            continue
        dims = [int(d) for d in m.group(2).split(",")] if m.group(2) else []
        out.append((m.group(1), dims))
    return out


def shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in shape_dims(shape_str):
        total += math.prod(dims) * _DTYPE_BYTES[dt]
    return total


_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclass
class Op:
    name: str
    opcode: str
    result_type: str
    args: list[str]
    attrs: str
    computation: str

    @property
    def result_bytes(self) -> int:
        return shape_bytes(self.result_type)

    @property
    def group_size(self) -> int:
        """Participants per replica group (collectives)."""
        m = _GROUPS_RE.search(self.attrs)
        return int(m.group(2)) if m else 1

    @property
    def wire_bytes(self) -> float:
        """Bytes crossing ICI per chip, ring-algorithm accounting:
        all-gather: result*(n-1)/n; all-reduce: 2*result*(n-1)/n
        (reduce-scatter + all-gather phases); reduce-scatter:
        result*(n-1) (operand = n*result); all-to-all: result*(n-1)/n;
        collective-permute: result."""
        n = max(self.group_size, 1)
        r = self.result_bytes
        if self.opcode == "all-gather":
            return r * (n - 1) / n
        if self.opcode == "all-reduce":
            return 2.0 * r * (n - 1) / n
        if self.opcode == "reduce-scatter":
            return r * (n - 1)
        if self.opcode == "all-to-all":
            return r * (n - 1) / n
        return float(r)                       # collective-permute &c.

    @property
    def result_elems(self) -> int:
        total = 0
        for _, dims in shape_dims(self.result_type):
            total += math.prod(dims)
        return total


@dataclass
class HloProgram:
    ops: dict[str, Op] = field(default_factory=dict)          # name -> op
    comps: dict[str, list[str]] = field(default_factory=dict)  # comp -> op names
    entry: str = ""
    multipliers: dict[str, float] = field(default_factory=dict)


def _parse_args(argstr: str) -> list[str]:
    """Operand names from the text following '(' on the op line."""
    names = []
    depth = 0
    for tok in re.finditer(r"[(),]|%[\w\.\-]+", argstr):
        t = tok.group(0)
        if t == "(":
            depth += 1
        elif t == ")":
            if depth == 0:
                break
            depth -= 1
        elif t.startswith("%"):
            names.append(t[1:])
    return names


def parse_hlo(text: str) -> HloProgram:
    prog = HloProgram()
    comp = "entry"
    for raw in text.splitlines():
        cm = _COMP_RE.match(raw)
        if cm:
            comp = cm.group(1)
            if raw.startswith("ENTRY"):
                prog.entry = comp
            prog.comps.setdefault(comp, [])
            continue
        om = _OP_RE.match(raw)
        if not om:
            continue
        name, rtype, opcode, rest = om.groups()
        op = Op(name=name, opcode=opcode, result_type=rtype,
                args=_parse_args(rest), attrs=rest, computation=comp)
        prog.ops[name] = op
        prog.comps.setdefault(comp, []).append(name)
    if not prog.entry:
        # fall back: the computation named like the module entry
        prog.entry = next(iter(prog.comps), "entry")
    _propagate_multipliers(prog)
    return prog


def _callees(op: Op) -> list[tuple[str, float]]:
    """(computation, weight) pairs invoked by this op."""
    out = []
    trips = 1.0
    if op.opcode == "while":
        m = _TRIP_RE.search(op.attrs)
        trips = float(m.group(1)) if m else 1.0
    for attr in _CALL_ATTRS:
        for m in re.finditer(rf"{attr}=%?([\w\.\-]+)", op.attrs):
            w = trips if (op.opcode == "while" and attr == "body") else 1.0
            out.append((m.group(1), w))
    for m in re.finditer(r"branch_computations=\{([^}]*)\}", op.attrs):
        for name in re.findall(r"%?([\w\.\-]+)", m.group(1)):
            out.append((name, 1.0))
    return out


def _propagate_multipliers(prog: HloProgram):
    """Weight of each computation = Σ over call sites of caller-weight x
    per-call trip count.  The call graph is a DAG (HLO computations cannot
    recurse), so repeated full recomputation reaches a fixpoint in at most
    depth(DAG) passes."""
    mult = {c: 0.0 for c in prog.comps}
    mult[prog.entry] = 1.0
    for _ in range(len(prog.comps)):
        nxt = {c: 0.0 for c in prog.comps}
        nxt[prog.entry] = 1.0
        for comp in prog.comps:
            w = mult.get(comp, 0.0)
            if w == 0.0:
                continue
            for n in prog.comps[comp]:
                for callee, cw in _callees(prog.ops[n]):
                    if callee in nxt and callee != comp:
                        nxt[callee] += w * cw
        if nxt == mult:
            break
        mult = nxt
    prog.multipliers = mult


# ------------------------------------------------------------------ flops

def _dot_flops(prog: HloProgram, op: Op) -> float:
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
    if not m or not op.args:
        return 0.0
    lhs = prog.ops.get(op.args[0])
    if lhs is None:
        return 0.0
    lhs_shapes = shape_dims(lhs.result_type)
    if not lhs_shapes:
        return 0.0
    lhs_dims = lhs_shapes[0][1]
    cdims = [int(d) for d in m.group(1).split(",") if d]
    contracted = math.prod(lhs_dims[d] for d in cdims) if cdims else 1
    return 2.0 * op.result_elems * contracted


def _conv_flops(prog: HloProgram, op: Op) -> float:
    # kernel operand is args[1]; flops = 2 * out_elems * prod(kernel spatial
    # + input-feature) / feature_groups — derive from kernel shape.
    if len(op.args) < 2:
        return 0.0
    ker = prog.ops.get(op.args[1])
    if ker is None:
        return 0.0
    kshapes = shape_dims(ker.result_type)
    if not kshapes:
        return 0.0
    kdims = kshapes[0][1]
    gm = re.search(r"feature_group_count=(\d+)", op.attrs)
    groups = int(gm.group(1)) if gm else 1
    # kernel elems = spatial * in_per_group * out; per output elem we do
    # spatial * in_per_group MACs = kernel_elems / out_features.
    # out_features = last dim under default dim_labels (o appears once);
    # safe approximation: kernel_elems / max(dim) is wrong — use dim_labels.
    lm = re.search(r"dim_labels=\w*_(\w+)->", op.attrs)
    out_feat = None
    if lm:
        klabels = lm.group(1)            # e.g. "io01" / "01io"
        if "o" in klabels:
            out_feat = kdims[klabels.index("o")]
    if not out_feat:
        out_feat = kdims[-1]
    macs_per_out = math.prod(kdims) / max(out_feat, 1)
    return 2.0 * op.result_elems * macs_per_out


@dataclass
class HloSummary:
    flops: float = 0.0
    bytes_written: float = 0.0
    bytes_read: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=dict)
    collective_count: dict[str, int] = field(default_factory=dict)
    flops_by_comp: dict[str, float] = field(default_factory=dict)
    bytes_by_shape: dict[str, float] = field(default_factory=dict)
    raw_flops: float = 0.0               # unscaled (cost_analysis-like)

    @property
    def hbm_bytes(self) -> float:
        return self.bytes_written + self.bytes_read

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def summarize(text: str) -> HloSummary:
    prog = parse_hlo(text)
    s = HloSummary()
    for name, op in prog.ops.items():
        mult = prog.multipliers.get(op.computation, 0.0)
        if mult == 0.0:
            continue
        f = 0.0
        if op.opcode == "dot":
            f = _dot_flops(prog, op)
        elif op.opcode == "convolution":
            f = _conv_flops(prog, op)
        if f:
            s.flops += f * mult
            s.raw_flops += f
            s.flops_by_comp[op.computation] = (
                s.flops_by_comp.get(op.computation, 0.0) + f * mult)
        if op.opcode in COLLECTIVE_KINDS:
            b = op.wire_bytes * mult
            s.collective_bytes[op.opcode] = s.collective_bytes.get(op.opcode, 0.0) + b
            s.collective_count[op.opcode] = s.collective_count.get(op.opcode, 0) + 1
        if (op.opcode in _FREE_OPS or op.opcode == "while"
                or op.opcode in _FUSABLE_ELEMENTWISE):
            continue
        # dynamic-update-slice is in-place on TPU (donated buffers): the
        # traffic is the UPDATE slice, not the whole carried buffer.
        def _shape_key(t: str) -> str:
            return t.split("{")[0]

        if op.opcode == "dynamic-update-slice" or (
                op.opcode == "fusion" and "update-slice" in op.name):
            upd = prog.ops.get(op.args[1]) if len(op.args) > 1 else None
            b = (upd.result_bytes if upd is not None else 0) * mult
            s.bytes_written += b
            s.bytes_read += b
            if upd is not None:
                k = _shape_key(upd.result_type)
                s.bytes_by_shape[k] = s.bytes_by_shape.get(k, 0.0) + 2 * b
            continue
        s.bytes_written += op.result_bytes * mult
        k = _shape_key(op.result_type)
        s.bytes_by_shape[k] = s.bytes_by_shape.get(k, 0.0) + op.result_bytes * mult
        # dynamic-slice (and slice-only fusions) read the SLICE, not the
        # whole operand buffer — e.g. the per-layer weight slice of a
        # scanned stack, which is exactly the weight-stationary read.
        if op.opcode == "dynamic-slice" or (
                op.opcode == "fusion" and "slice" in op.name
                and "update" not in op.name):
            s.bytes_read += op.result_bytes * mult
            s.bytes_by_shape[k] += op.result_bytes * mult
            continue
        for a in op.args:
            src = prog.ops.get(a)
            if src is not None and src.opcode != "tuple":
                s.bytes_read += src.result_bytes * mult
                ka = _shape_key(src.result_type)
                s.bytes_by_shape[ka] = (s.bytes_by_shape.get(ka, 0.0)
                                        + src.result_bytes * mult)
    return s
