"""Roofline analysis from dry-run records (§Roofline).

Port of `repro.launch.roofline`.  Per (arch x shape) cell on the
single-pod mesh, against a target's constants (`core/hwmodel.py`):

    compute_s    = flops_per_device    / peak_flops_bf16
    memory_s     = hbm_bytes_per_device / hbm_bw_Bps
    collective_s = collective_bytes_per_device / ici_link_Bps

The target is TPU v5e (`TPU_V5E`: 197 TFLOP/s, 819 GB/s, 50 GB/s a
link) unless a record names another in its "target" field or the
caller passes one: the port's records name the H100 (`H100`: the H100
SXM5 80GB datasheet's 989 TFLOP/s bf16, 67 f32, 3.35 TB/s HBM, NVLink 4
at 450 GB/s each way).  On a reference record the rows equal the
reference's.

A port record may carry a measured step (`launch/dryrun.py` on the
card: "measured": {"step_s": ...}).  Its row then has `mfu`, the model
FLOPs utilisation: model_flops / (measured step_s x chips x the target's
peak for the record's dtype).  `roofline_fraction` stays the analytic
one.

Usage:
    python -m repro_torch.launch.roofline                # full table (md)
    python -m repro_torch.launch.roofline --json         # machine-readable
    python -m repro_torch.launch.roofline --cell yi-9b__train_4k
    python -m repro_torch.launch.roofline --target h100
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

from repro_torch.core.hwmodel import TARGETS, TPU_V5E


def _target(t):
    """A target object from itself or its name."""
    return TARGETS[t] if isinstance(t, str) else t


def peak_flops(target, dtype: str = "bfloat16") -> float:
    """The target's peak for `dtype`: f32 where the target states an f32
    peak, else its bf16 one."""
    t = _target(target)
    if dtype == "float32" and getattr(t, "peak_flops_f32", None):
        return t.peak_flops_f32
    return t.peak_flops_bf16


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    mem_gb_per_dev: float
    ok: bool
    error: str = ""
    target: str = "tpu-v5e"          # a name of `core.hwmodel.TARGETS`
    measured_s: float = 0.0          # a card record's measured step time
    dtype: str = "bfloat16"          # the record's compute dtype

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops_global if self.hlo_flops_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bottleneck:
        (useful flops / step_s) / (chips * peak)."""
        if self.step_s <= 0:
            return 0.0
        peak = self.chips * _target(self.target).peak_flops_bf16
        return (self.model_flops / self.step_s) / peak

    @property
    def bw_fraction(self) -> float:
        """Fraction of the HBM-bandwidth roofline: memory_s / step_s.
        1.0 = the step runs exactly at the memory wall — the right
        roofline for intrinsically BW-bound cells (decode reads the
        whole model + KV per token; its compute fraction is ~0 by
        construction)."""
        return self.memory_s / self.step_s if self.step_s > 0 else 0.0

    @property
    def mfu(self) -> float | None:
        """Model FLOPs over (measured step time x chips x peak); None
        without a measured step."""
        if self.measured_s <= 0:
            return None
        peak = self.chips * peak_flops(self.target, self.dtype)
        return self.model_flops / (self.measured_s * peak)


def row_from_record(rec: dict, target=None) -> RooflineRow:
    """The row of one dry-run record against `target` (a target or its
    name; default: the record's "target" field, else TPU v5e)."""
    t = _target(target if target is not None
                else rec.get("target", TPU_V5E.name))
    tname = next((k for k, v in TARGETS.items() if v == t), t.name)
    chips = 1
    for v in rec.get("mesh_shape", {}).values():
        chips *= v
    if not rec.get("ok"):
        return RooflineRow(rec["arch"], rec["shape"], rec["mesh"], chips,
                           0, 0, 0, 0, 0, 0, False, rec.get("error", ""),
                           target=tname)
    h = rec["hlo"]
    mem = rec.get("memory_analysis", {})
    mem_b = (mem.get("argument_size_in_bytes") or 0) + \
            (mem.get("temp_size_in_bytes") or 0)
    flops_dev = h["flops_per_device"]
    hbm_dev = h["bytes_read_per_device"] + h["bytes_written_per_device"]
    coll_dev = sum(h["collective_bytes_per_device"].values())
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        compute_s=flops_dev / t.peak_flops_bf16,
        memory_s=hbm_dev / t.hbm_bw_Bps,
        collective_s=coll_dev / t.ici_link_Bps,
        model_flops=rec["model_flops"],
        hlo_flops_global=flops_dev * chips,
        mem_gb_per_dev=mem_b / 1e9,
        ok=True,
        target=tname,
        measured_s=float(rec.get("measured", {}).get("step_s") or 0.0),
        dtype=rec.get("meta", {}).get("dtype", "bfloat16"),
    )


def load_rows(dryrun_dir: str, mesh: str = "single",
              target=None) -> list[RooflineRow]:
    rows = []
    for name in sorted(os.listdir(dryrun_dir)):
        if not name.endswith(f"__{mesh}.json"):
            continue
        with open(os.path.join(dryrun_dir, name)) as f:
            rows.append(row_from_record(json.load(f), target))
    return rows


def advice(row: RooflineRow) -> str:
    """One sentence: what would move the dominant term down."""
    if row.dominant == "compute":
        if row.useful_ratio < 0.5:
            return ("compute-bound with low useful ratio: cut remat "
                    "recompute (policy/grad-accum) or logits waste")
        return "compute-bound near peak: raise arithmetic efficiency (fusion, MXU-aligned tiles)"
    if row.dominant == "memory":
        return ("memory-bound: increase reuse per HBM byte — bigger batch "
                "tile per weight read (weight-stationary blocking), bf16 "
                "everywhere, fuse elementwise chains")
    return ("collective-bound: reshard to cut gathered bytes (smaller TP "
            "group / more DP), overlap collectives with compute, compress "
            "or reduce-scatter instead of all-reduce+slice")


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def markdown_table(rows: list[RooflineRow]) -> str:
    """The reference's table; rows with a measured step add the
    measured time and the MFU as two more columns."""
    measured = any(r.measured_s > 0 for r in rows)
    extra_head = " measured | MFU |" if measured else ""
    out = ["| arch | shape | compute | memory | collective | bound | "
           "MODEL/HLO | compute-roofline | BW-roofline | mem GB/dev |"
           + extra_head,
           "|---|---|---|---|---|---|---|---|---|---|"
           + ("---|---|" if measured else "")]
    for r in rows:
        if not r.ok:
            out.append(f"| {r.arch} | {r.shape} | FAIL: {r.error[:40]} | | | | | | | |"
                       + (" | |" if measured else ""))
            continue
        extra = ""
        if measured:
            extra = (f" {fmt_s(r.measured_s)} | {r.mfu:.2%} |"
                     if r.mfu is not None else " | |")
        out.append(
            f"| {r.arch} | {r.shape} | {fmt_s(r.compute_s)} | {fmt_s(r.memory_s)} "
            f"| {fmt_s(r.collective_s)} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.roofline_fraction:.2%} | "
            f"{r.bw_fraction:.0%} | {r.mem_gb_per_dev:.1f} |" + extra)
    return "\n".join(out)


def row_dict(r: RooflineRow) -> dict:
    """A row with its derived terms, as `--json` prints it."""
    return {**r.__dict__, "dominant": r.dominant, "step_s": r.step_s,
            "useful_ratio": r.useful_ratio,
            "roofline_fraction": r.roofline_fraction, "mfu": r.mfu}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--cell", help="arch__shape filter")
    ap.add_argument("--target", choices=sorted(TARGETS), default=None,
                    help="roofline constants (default: each record's own "
                         "'target', else tpu-v5e)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    rows = load_rows(args.dryrun_dir, args.mesh, args.target)
    if args.cell:
        rows = [r for r in rows if f"{r.arch}__{r.shape}" == args.cell]
    if args.json:
        print(json.dumps([row_dict(r) for r in rows], indent=1))
        return 0
    print(markdown_table(rows))
    print()
    for r in rows:
        if r.ok:
            print(f"{r.arch} x {r.shape}: {advice(r)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
