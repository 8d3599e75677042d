"""The paper's own silicon, as a config (consumed by core/simulator and
benchmarks — not a neural architecture).

Port of `repro.configs.sunrise_chip`.  `TARGET` is the reference's
deployment target, TPU v5e (the roofline's default target); the port's
own card is `core.hwmodel.H100`.
Section VI numbers: 40nm logic + 38nm DRAM, 110 mm^2, 32,768 MACs,
25 TOPS, 1.8 TB/s HITOC bandwidth, 13 TB/s DSU->VPU broadcast fabric,
4.5 Gb (560 MB) UniMem, 12 W, 1500 img/s ResNet-50.
"""
from repro_torch.core.simulator import SunriseChip
from repro_torch.core.hwmodel import SUNRISE, TPU_V5E

CHIP = SunriseChip()            # microarchitecture for the WS scheduler
SPEC = SUNRISE                  # benchmark-table spec (Tables II-IV)
TARGET = TPU_V5E                # the deployment target for the framework

PAPER_CLAIMS = {
    "resnet50_img_per_s": 1500.0,
    "peak_tops": 25.0,
    "memory_bw_TBps": 1.8,
    "broadcast_bw_TBps": 13.0,
    "memory_mb": 560.0,
    "power_w": 12.0,
    "table7_tops_mm2": 7.58,
    "table7_tops_w": 50.10,
    "big_die_capacity_gb": 24.0,
}
