"""Weight-stationary dataflow policy + the stationarity audit.

The paper's execution invariant (section IV): weights stay resident next
to the unit that uses them; activations move (broadcast in, results out);
intermediates never leave the unit.  On a TPU mesh the translation is:

  * parameters are sharded over ("data", "model") and are NEVER gathered
    whole for compute that can run shard-local (Megatron column->row
    pairs, expert-local MoE matmuls, head-local attention);
  * the collectives that remain are ACTIVATION collectives (all-gather /
    reduce-scatter / all-reduce of activation- or gradient-shaped data)
    plus the explicitly-allowed FSDP parameter all-gathers;
  * `audit_stationarity` inspects compiled HLO and attributes collective
    bytes to parameters vs activations, so CI can assert the invariant.

Port of `repro.core.dataflow`.  `parse_shape_bytes`, `CollectiveOp`,
`parse_collectives`, `StationarityReport` and `audit_stationarity` are
copied: they read HLO text.  The port's own steps issue their
collectives by hand (`distribution/collectives.py`), so
`audit_collective_records` builds the same `StationarityReport` from the
collective records of a trace of the port's step (`launch/trace.py`):
one record per collective call, with its HLO kind and result bytes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def parse_shape_bytes(shape_str: str) -> int:
    """Bytes of an HLO shape string like 'bf16[16,1024,512]' (tuples summed)."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveOp:
    kind: str
    shape_bytes: int
    computation: str          # enclosing HLO computation name
    line: str


def parse_collectives(hlo_text: str) -> list[CollectiveOp]:
    """Extract every collective op with its operand bytes and computation."""
    ops: list[CollectiveOp] = []
    computation = "entry"
    for raw in hlo_text.splitlines():
        line = raw.strip()
        # Track the enclosing computation: HLO prints  `%name (args) -> ... {`
        m = re.match(r"%?([\w\.\-]+)\s*\([^)]*\)\s*->.*{", line)
        if m and not line.startswith("ROOT"):
            computation = m.group(1)
            continue
        for kind in _COLLECTIVES:
            # match op kind at the assignment, e.g.  `x = bf16[..] all-gather(...)`
            if re.search(rf"=\s*[\w\[\],\s()]*{kind}", line) or f" {kind}(" in line:
                # The RESULT shape is what moves (first shape on the line).
                sm = _SHAPE_RE.search(line.split("=", 1)[-1])
                nbytes = parse_shape_bytes(sm.group(0)) if sm else 0
                ops.append(CollectiveOp(kind, nbytes, computation, line[:160]))
                break
    return ops


@dataclass
class StationarityReport:
    param_collective_bytes: int = 0       # weights moving = paper violation
    fsdp_gather_bytes: int = 0            # allowed: FSDP param all-gathers
    activation_collective_bytes: int = 0  # the paper's intended traffic
    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def stationarity_fraction(self) -> float:
        """Fraction of collective bytes that are NOT raw weight movement."""
        total = (self.param_collective_bytes + self.fsdp_gather_bytes
                 + self.activation_collective_bytes)
        if total == 0:
            return 1.0
        return 1.0 - self.param_collective_bytes / total


def audit_stationarity(
    hlo_text: str,
    param_shard_bytes: set[int],
    fsdp_param_bytes: set[int] = frozenset(),
) -> StationarityReport:
    """Attribute collective bytes to parameters vs activations.

    `param_shard_bytes`: byte sizes of per-device parameter shards (and of
    whole parameters) — a collective moving exactly one of these sizes is
    classified as parameter movement.  `fsdp_param_bytes`: sizes that are
    *expected* FSDP all-gathers (param shards gathered along data axis).
    Heuristic, but effective: activation shapes carry batch/seq dims and
    essentially never collide with parameter sizes.
    """
    rep = StationarityReport(ops=parse_collectives(hlo_text))
    for op in rep.ops:
        if op.shape_bytes in fsdp_param_bytes and op.kind == "all-gather":
            rep.fsdp_gather_bytes += op.shape_bytes
        elif op.shape_bytes in param_shard_bytes:
            rep.param_collective_bytes += op.shape_bytes
        else:
            rep.activation_collective_bytes += op.shape_bytes
    return rep


def collective_ops_from_records(records) -> list[CollectiveOp]:
    """`CollectiveOp`s of a trace's collective records (anything with
    `kind`, `result_bytes`, `name` and `result_type`: each collective
    call of the port's step, `launch/trace.py` `CollectiveRecord`); a
    record's `name` (the call's counter name in `collectives.STATS`)
    takes the place of the enclosing computation."""
    return [CollectiveOp(r.kind, int(r.result_bytes), r.name,
                         f"{r.result_type} {r.kind}({r.name})")
            for r in records if r.kind in _COLLECTIVES]


def audit_collective_records(
    records,
    param_shard_bytes: set[int],
    fsdp_param_bytes: set[int] = frozenset(),
) -> StationarityReport:
    """`audit_stationarity` over a trace's collective records in place
    of HLO text: the same attribution by result bytes."""
    rep = StationarityReport(ops=collective_ops_from_records(records))
    for op in rep.ops:
        if op.shape_bytes in fsdp_param_bytes and op.kind == "all-gather":
            rep.fsdp_gather_bytes += op.shape_bytes
        elif op.shape_bytes in param_shard_bytes:
            rep.param_collective_bytes += op.shape_bytes
        else:
            rep.activation_collective_bytes += op.shape_bytes
    return rep
