"""Process-node projection (paper Tables V, VI, VII).

The paper normalizes every chip to a 7 nm CMOS + 1y DRAM process using
per-generation scaling factors (Table V for CMOS, Table VI for DRAM).
We model the projection as a chain of node steps; each step multiplies
density, per-unit performance and per-unit power by the published
factors.  Per the paper: "we use performance improvement parameters under
the condition that power consumption is within the common range as seen
in ASIC chips.  Otherwise, we use power reduction parameters."

One calibrated constant: taking the high-performance flavor of a node
costs some of the power win back (`PERF_POWER_COST` = 0.3, i.e. +45%
perf costs +13.5% power).  With it the Sunrise projection lands on the
paper's 7.58 TOPS/mm^2 / 50.1 TOPS/W within ~10%; the benchmark prints
computed-vs-published deltas for every cell (the paper's own Chip B row
is internally inconsistent and is reported as such).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hwmodel import ChipSpec, SUNRISE, CHIP_A, CHIP_B, CHIP_C, die_normalized


@dataclass(frozen=True)
class NodeStep:
    src_nm: int
    dst_nm: int
    density_ratio: float
    perf_improvement: float      # fraction, e.g. 0.45 = +45%
    power_reduction: float       # fraction, e.g. 0.40 = -40%


# Paper Table V.
NODE_STEPS = [
    NodeStep(40, 28, 2.0, 0.45, 0.40),
    NodeStep(28, 16, 2.0, 0.35, 0.55),
    NodeStep(16, 12, 1.2, 0.28, 0.35),
    NodeStep(16, 10, 2.0, 0.15, 0.35),
    NodeStep(10, 7, 1.65, 0.22, 0.54),
]

# Paper Table VI: DRAM density by process family (Gb per mm^2).
DRAM_DENSITY_GB_MM2 = {"3x": 0.04, "1x": 0.189, "1y": 0.237}

# Paper Table VII published values (TOPS/mm2, GB/s/mm2, MB/mm2, TOPS/W).
PAPER_TABLE7 = {
    "Sunrise": (7.58, 216.0, 30.3, 50.10),
    "Chip A": (0.86, 122.0, 1.50, 5.38),
    "Chip B": (0.19, None, 0.90, 0.83),
    "Chip C": (1.12, 6.6, 0.07, 1.46),
}

# Common ASIC power-density comfort range (W/mm^2).
DEFAULT_POWER_BUDGET_W_MM2 = 0.8
PERF_POWER_COST = 0.3


def path_to_7nm(src_nm: int) -> list[NodeStep]:
    """Node-step chain from `src_nm` down to 7 nm (via 10 nm)."""
    chain_nodes = [40, 28, 16, 10, 7]
    if src_nm == 7:
        return []
    if src_nm == 12:
        # 12 nm is a half-node off the 16->10 path; model as 16 nm that has
        # already banked the 16->12 gains, i.e. divide them back out first.
        s = next(x for x in NODE_STEPS if (x.src_nm, x.dst_nm) == (16, 12))
        undo = NodeStep(
            12, 16,
            1.0 / s.density_ratio,
            -s.perf_improvement / (1 + s.perf_improvement),
            -s.power_reduction / (1 - s.power_reduction),
        )
        return [undo] + path_to_7nm(16)
    out, started = [], False
    for a, b in zip(chain_nodes, chain_nodes[1:]):
        if a == src_nm:
            started = True
        if started:
            out.append(next(s for s in NODE_STEPS if (s.src_nm, s.dst_nm) == (a, b)))
    return out


@dataclass(frozen=True)
class Projection:
    name: str
    density_scale: float
    perf_per_unit_scale: float
    power_per_unit_scale: float
    tops_per_mm2: float
    bw_gbps_per_mm2: float | None
    mb_per_mm2: float
    tops_per_w: float
    power_density_w_mm2: float


def project_to_7nm(
    chip: ChipSpec,
    dram_src: str = "3x",
    dram_dst: str = "1y",
    power_budget_w_mm2: float = DEFAULT_POWER_BUDGET_W_MM2,
) -> Projection:
    base = die_normalized(chip)
    base_pd = chip.power_w / chip.die_area_mm2
    density = perf_unit = power_unit = 1.0

    for step in path_to_7nm(chip.process_nm):
        density *= step.density_ratio
        hi = power_unit * (1 - step.power_reduction) * (1 + PERF_POWER_COST * step.perf_improvement)
        if base_pd * density * hi <= power_budget_w_mm2:
            perf_unit *= 1 + step.perf_improvement
            power_unit = hi
        else:
            power_unit *= 1 - step.power_reduction

    tops_mm2 = base.tops_per_mm2 * density * perf_unit
    # Bandwidth scales with connection density (more, finer wires per mm^2).
    bw = None if base.bw_gbps_per_mm2 is None else base.bw_gbps_per_mm2 * density
    # Capacity: Sunrise rides the DRAM node (Table VI); SRAM chips ride CMOS.
    if chip.name == "Sunrise":
        cap = base.mb_per_mm2 * DRAM_DENSITY_GB_MM2[dram_dst] / DRAM_DENSITY_GB_MM2[dram_src]
    else:
        cap = base.mb_per_mm2 * density
    eff = base.tops_per_w * perf_unit / power_unit
    return Projection(
        name=chip.name,
        density_scale=density,
        perf_per_unit_scale=perf_unit,
        power_per_unit_scale=power_unit,
        tops_per_mm2=tops_mm2,
        bw_gbps_per_mm2=bw,
        mb_per_mm2=cap,
        tops_per_w=eff,
        power_density_w_mm2=base_pd * density * power_unit,
    )


def table7() -> list[Projection]:
    return [project_to_7nm(c) for c in (SUNRISE, CHIP_A, CHIP_B, CHIP_C)]


def sunrise_big_die_capacity_gb(die_area_mm2: float = 800.0) -> float:
    """Paper section VII: 'On an 800 mm^2 die, our architecture could reach
    a storage capacity as high as 24 GB' at 1y DRAM density.

    Calibrate array efficiency from the actual silicon: 4.5 Gb on a
    110 mm^2 memory die at the 38 nm (3x-class) node."""
    sunrise_array_eff = 4.5 / (DRAM_DENSITY_GB_MM2["3x"] * 110.0)
    return DRAM_DENSITY_GB_MM2["1y"] * die_area_mm2 * sunrise_array_eff / 8.0
