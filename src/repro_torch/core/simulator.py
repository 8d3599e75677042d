"""Analytical weight-stationary near-memory scheduler for the Sunrise chip.

Models the paper's section IV/V execution model:

* Weights are STATIONARY in each VPU's bonded DRAM arrays; a layer's
  weights are DMA'd once and reused for the whole batch (weight
  amortization).
* Feature data is BROADCAST from the DSU pool to all VPUs over the
  13 TB/s on-chip fabric; each VPU computes its output channels
  independently; results return to the DSU pool.
* Intermediates are localized — they never cross VPUs, so the only fabric
  traffic is the broadcast input stream and the returned outputs.
* The UCE reconfigures the datapath between layers (fixed overhead).

Per layer the time is the max of four resources (they overlap — the chip
pipelines DMA under compute; UniMem array pooling hides DRAM latency):

    t_layer = max(t_compute, t_weight_dma / batch, t_broadcast, t_return)
              + t_reconfig

Compute utilization is geometric: output channels map onto the VPU/lane
grid and spatial positions onto the vector width, each with ceil-rounding
losses — exactly the paper's "vectors as basic computational data unit".

Validation target: 1500 img/s on ResNet-50 at batch 1 (paper section VI);
`benchmarks/resnet50_throughput.py` asserts within 10%.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.models.resnet import LayerSpec


@dataclass(frozen=True)
class SunriseChip:
    """Parameters from the paper (section VI) + microarchitecture choices
    consistent with them (num_vpus x lanes x vector_width = 32768 MACs)."""
    num_macs: int = 32768
    peak_tops: float = 25.0            # 2 ops / MAC / cycle at clock
    num_vpus: int = 64
    lanes_per_vpu: int = 8             # channel parallelism = 64*8 = 512
    vector_width: int = 64             # spatial vectorization per lane
    dram_bw_Bps: float = 1.8e12        # total HITOC vertical bandwidth
    vpu_dram_frac: float = 0.5         # share of arrays under the VPU pool
    bcast_bw_Bps: float = 13e12        # DSU pool -> VPU pool broadcast
    reconfig_s: float = 3.5e-6         # UCE per-layer reconfiguration
    weight_bytes_per_param: float = 1.0  # int8 inference
    act_bytes: float = 1.0

    @property
    def clock_hz(self) -> float:
        return self.peak_tops * 1e12 / (2.0 * self.num_macs)

    @property
    def channel_parallelism(self) -> int:
        return self.num_vpus * self.lanes_per_vpu

    @property
    def macs_per_s(self) -> float:
        return self.num_macs * self.clock_hz


@dataclass
class LayerTime:
    name: str
    t_compute: float
    t_weight: float
    t_broadcast: float
    t_return: float
    t_total: float
    util: float

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.t_compute, "weight": self.t_weight,
            "broadcast": self.t_broadcast, "return": self.t_return,
        }
        return max(terms, key=terms.get)


@dataclass
class ScheduleReport:
    layers: list[LayerTime] = field(default_factory=list)
    batch: int = 1

    @property
    def total_s(self) -> float:
        return sum(l.t_total for l in self.layers)

    @property
    def throughput_per_s(self) -> float:
        return self.batch / self.total_s if self.total_s else 0.0

    @property
    def mac_utilization(self) -> float:
        busy = sum(l.t_compute * l.util for l in self.layers)
        return busy / self.total_s if self.total_s else 0.0

    def bound_histogram(self) -> dict[str, int]:
        hist: dict[str, int] = {}
        for l in self.layers:
            hist[l.bound] = hist.get(l.bound, 0) + 1
        return hist


def compute_cycles(chip: SunriseChip, layer: LayerSpec, batch: int = 1) -> tuple[float, float]:
    """(cycles, utilization) for one layer under the paper's mapping.

    Output elements (c_out x spatial x batch) are distributed over the
    32,768 MAC slots; each slot reduces over K = c_in*kh*kw sequentially.
    Each tile group pays a systolic fill/drain skew of ~vector_width
    cycles — the 'vectors as basic unit' granularity of the paper.
    """
    work = layer.c_out * layer.spatial * batch
    k_depth = layer.c_in * layer.kh * layer.kw
    groups = math.ceil(work / chip.num_macs)
    cycles = groups * (k_depth + chip.vector_width)
    ideal = work * k_depth / chip.num_macs
    return cycles, ideal / cycles


def schedule_layer(chip: SunriseChip, layer: LayerSpec, batch: int = 1) -> LayerTime:
    cycles, util = compute_cycles(chip, layer, batch)
    t_compute = cycles / chip.clock_hz
    # Weights STREAM from the bonded local DRAM arrays every reuse pass
    # (UniMem: DRAM is the only memory).  Systolic spatial reuse divides the
    # stream by min(vector_width, spatial) — this is the memory wall the
    # 1.8 TB/s HITOC bandwidth exists to absorb.
    reuse = max(1, min(chip.vector_width, layer.spatial))
    w_stream = batch * layer.macs * chip.weight_bytes_per_param / reuse
    t_weight = w_stream / (chip.dram_bw_Bps * chip.vpu_dram_frac)
    t_bcast = batch * layer.in_elems * chip.act_bytes / chip.bcast_bw_Bps
    t_return = batch * layer.out_elems * chip.act_bytes / chip.bcast_bw_Bps
    t_total = max(t_compute, t_weight, t_bcast, t_return) + chip.reconfig_s
    return LayerTime(layer.name, t_compute, t_weight, t_bcast, t_return, t_total, util)


def schedule(chip: SunriseChip, layers: list[LayerSpec], batch: int = 1) -> ScheduleReport:
    rep = ScheduleReport(batch=batch)
    for layer in layers:
        rep.layers.append(schedule_layer(chip, layer, batch))
    return rep


def resnet50_throughput(chip: SunriseChip | None = None, batch: int = 1) -> ScheduleReport:
    from repro_torch.models.resnet import resnet50_layer_specs
    chip = chip or SunriseChip()
    return schedule(chip, resnet50_layer_specs(), batch=batch)


# ----------------------------------------------------------- what-if study

def no_weight_stationarity(chip: SunriseChip, layers: list[LayerSpec], batch: int = 1) -> ScheduleReport:
    """Ablation: no systolic weight reuse — every MAC re-fetches its weight
    from DRAM each cycle (output-stationary worst case).  Shows why the
    paper's weight-stationary dataflow matters even WITH HITOC bandwidth."""
    rep = ScheduleReport(batch=batch)
    for layer in layers:
        lt = schedule_layer(chip, layer, batch)
        w_stream = batch * layer.macs * chip.weight_bytes_per_param  # reuse = 1
        t_weight = w_stream / (chip.dram_bw_Bps * chip.vpu_dram_frac)
        t_total = max(lt.t_compute, t_weight, lt.t_broadcast, lt.t_return) + chip.reconfig_s
        rep.layers.append(LayerTime(layer.name, lt.t_compute, t_weight,
                                    lt.t_broadcast, lt.t_return, t_total, lt.util))
    return rep


def sram_cache_chip() -> SunriseChip:
    """Ablation: a conventional SRAM-cache chip of the same die — less
    bandwidth (256 GB/s off-chip class) and weights streamed from DRAM."""
    return SunriseChip(dram_bw_Bps=256e9, vpu_dram_frac=0.5, bcast_bw_Bps=1e12)
