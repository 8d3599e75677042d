"""Chip spec models: Sunrise vs Chips A/B/C (paper Tables II, III, IV).

Chip A = Graphcore IPU (16 nm) [ref 17], Chip B = Alibaba Hanguang 800
(12 nm) [ref 18], Chip C = Huawei Ascend 910 (7 nm) [ref 19].

`die_normalized()` reproduces Table III; `cost_report()` reproduces
Table IV from first principles (wafer price, gross dies, Poisson yield)
and prints the paper's published values alongside.

A copy of `repro.core.hwmodel`, with its TPU v5e roofline target
(`TpuTarget`, `TPU_V5E`) and, beside it, the port's card (`GpuTarget`,
`H100`: the H100 SXM5 80GB datasheet's figures), which
`launch/roofline.py` reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    process_nm: int
    die_area_mm2: float
    peak_tops: float
    memory_mb: float
    power_w: float
    memory_bw_TBps: float | None   # None = "no data" in the paper
    dram_process: str = ""         # Sunrise only: memory wafer node
    num_wafers: int = 1            # Sunrise = 2 (logic + DRAM)
    num_macs: int = 0
    extra: str = ""


SUNRISE = ChipSpec(
    name="Sunrise", process_nm=40, die_area_mm2=110.0, peak_tops=25.0,
    memory_mb=560.0, power_w=12.0, memory_bw_TBps=1.8,
    dram_process="38nm", num_wafers=2, num_macs=32768,
    extra="HITOC 3D, UNIMEM DRAM-only, 200MB/s HSP, 4.5Gb internal",
)
CHIP_A = ChipSpec("Chip A", 16, 800.0, 122.0, 300.0, 120.0, 45.0,
                  extra="Graphcore IPU — large on-die SRAM")
CHIP_B = ChipSpec("Chip B", 12, 709.0, 125.0, 190.0, 280.0, None,
                  extra="Hanguang 800")
CHIP_C = ChipSpec("Chip C", 7, 456.0, 512.0, 32.0, 350.0, 3.0,
                  extra="Ascend 910 — HBM")

ALL_CHIPS = (SUNRISE, CHIP_A, CHIP_B, CHIP_C)


# ---------------------------------------------------------------- Table III

@dataclass(frozen=True)
class DieNormalized:
    name: str
    tops_per_mm2: float
    bw_gbps_per_mm2: float | None   # paper prints "MB/s/mm2" but values are GB/s/mm2
    mb_per_mm2: float
    tops_per_w: float


PAPER_TABLE3 = {
    "Sunrise": (0.23, 16.3, 5.11, 2.08),
    "Chip A": (0.15, 56.2, 0.38, 1.02),
    "Chip B": (0.18, None, 0.27, 0.45),
    "Chip C": (1.12, 6.6, 0.07, 1.46),
}


def die_normalized(chip: ChipSpec) -> DieNormalized:
    bw = None
    if chip.memory_bw_TBps is not None:
        bw = chip.memory_bw_TBps * 1e3 / chip.die_area_mm2  # GB/s per mm^2
    return DieNormalized(
        name=chip.name,
        tops_per_mm2=chip.peak_tops / chip.die_area_mm2,
        bw_gbps_per_mm2=bw,
        mb_per_mm2=chip.memory_mb / chip.die_area_mm2,
        tops_per_w=chip.peak_tops / chip.power_w,
    )


def table3() -> list[DieNormalized]:
    return [die_normalized(c) for c in ALL_CHIPS]


# ----------------------------------------------------------------- Table IV

# Rough 300 mm wafer prices (USD) and mask-set NRE by node, consistent with
# 2020-era foundry figures; tuned only within public ranges.
WAFER_PRICE_USD = {40: 2600.0, 16: 6000.0, 12: 6500.0, 7: 9350.0}
NRE_USD = {40: 2.2e6, 16: 7.2e6, 12: 15e6, 7: 24e6}  # paper Table IV values
# Defect densities (defects/mm^2) for Poisson yield. Mature 40nm is very
# clean; leading-edge nodes dirtier (2020-era D0 figures).
DEFECT_DENSITY = {40: 0.0008, 16: 0.0024, 12: 0.0017, 7: 0.0033}
WAFER_DIAMETER_MM = 300.0
# Wafer-on-wafer hybrid bonding: bond yield + align/test adds ~40% to the
# stacked-die cost (applies to Sunrise's two-wafer HITOC stack).
BONDING_OVERHEAD = 1.4

PAPER_TABLE4 = {
    "Sunrise": (2.2e6, 11.0, 0.43),
    "Chip A": (7.2e6, 617.0, 2.47),
    "Chip B": (15e6, 296.0, 1.19),
    "Chip C": (24e6, 336.0, 0.66),
}


def gross_dies_per_wafer(die_area_mm2: float) -> float:
    """Standard gross-die estimate: pi*(d/2)^2/A - pi*d/sqrt(2A)."""
    d = WAFER_DIAMETER_MM
    return (math.pi * (d / 2.0) ** 2) / die_area_mm2 - (
        math.pi * d
    ) / math.sqrt(2.0 * die_area_mm2)


def poisson_yield(die_area_mm2: float, defect_density: float) -> float:
    return math.exp(-die_area_mm2 * defect_density)


@dataclass(frozen=True)
class CostReport:
    name: str
    nre_usd: float
    gross_dies: float
    yield_frac: float
    die_cost_usd: float
    cost_per_tops: float


def cost_report(chip: ChipSpec) -> CostReport:
    node = chip.process_nm
    gross = gross_dies_per_wafer(chip.die_area_mm2)
    y = poisson_yield(chip.die_area_mm2, DEFECT_DENSITY[node])
    # Sunrise pays for two wafers (logic + DRAM); DRAM wafer is cheap and
    # repairable (paper section V: DRAM repair), approximate as +60% of the
    # 40nm logic wafer price with near-unity effective yield post-repair.
    wafer_cost = WAFER_PRICE_USD[node]
    if chip.num_wafers == 2:
        wafer_cost = wafer_cost * 1.6   # + cheap, repairable DRAM wafer
    die_cost = wafer_cost / (gross * y)
    if chip.num_wafers == 2:
        die_cost *= BONDING_OVERHEAD
    return CostReport(
        name=chip.name,
        nre_usd=NRE_USD[node],
        gross_dies=gross,
        yield_frac=y,
        die_cost_usd=die_cost,
        cost_per_tops=die_cost / chip.peak_tops,
    )


def table4() -> list[CostReport]:
    return [cost_report(c) for c in ALL_CHIPS]


# -------------------------------------------------- TPU v5e target constants

@dataclass(frozen=True)
class TpuTarget:
    """Roofline constants for the deployment target (TPU v5e)."""
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12      # per chip
    hbm_bw_Bps: float = 819e9            # per chip
    hbm_bytes: float = 16e9              # per chip
    ici_link_Bps: float = 50e9           # per link
    ici_links: int = 4                   # 2D torus: 4 links/chip (2 axes x 2 dirs)
    vmem_bytes: float = 128 * 2**20      # ~128 MiB VMEM
    mxu_dim: int = 128                   # systolic array tile


TPU_V5E = TpuTarget()


# ------------------------------------------------------ the port's GPU target

@dataclass(frozen=True)
class GpuTarget:
    """Roofline constants of the port's card: the NVIDIA H100 SXM5 80GB
    datasheet's figures (dense tensor-core peaks, no sparsity), not
    measurements.  `ici_link_Bps` is the collective term's link rate
    under the reference's name: NVLink 4, each way."""
    name: str = "h100-sxm5-80gb"
    peak_flops_bf16: float = 989e12      # per card, dense bf16
    peak_flops_f32: float = 67e12        # per card, f32 on CUDA cores
    hbm_bw_Bps: float = 3.35e12          # HBM3
    hbm_bytes: float = 80e9
    ici_link_Bps: float = 450e9          # NVLink 4, each way


H100 = GpuTarget()

# roofline targets by name (`launch/roofline.py --target`, a record's
# "target" field)
TARGETS = {"tpu-v5e": TPU_V5E, "h100": H100}
