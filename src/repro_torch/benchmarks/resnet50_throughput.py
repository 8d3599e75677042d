"""Paper section VI: 1500 img/s ResNet-50 on Sunrise — the analytical
weight-stationary scheduler over the real layer shapes, plus the two
ablations that show WHY the architecture works (no-WS, SRAM-class BW)."""
from __future__ import annotations

from repro_torch.core.simulator import (
    SunriseChip, schedule, no_weight_stationarity, sram_cache_chip)
from repro_torch.models.resnet import resnet50_layer_specs


def run() -> dict:
    chip = SunriseChip()
    specs = resnet50_layer_specs()
    base = schedule(chip, specs, batch=1)
    ok = abs(base.throughput_per_s / 1500.0 - 1) < 0.10

    rows = [dict(config="sunrise ws (paper)", batch=1,
                 img_per_s=base.throughput_per_s,
                 mac_util=base.mac_utilization,
                 bounds=base.bound_histogram())]
    b8 = schedule(chip, specs, batch=8)
    rows.append(dict(config="sunrise ws", batch=8,
                     img_per_s=b8.throughput_per_s,
                     mac_util=b8.mac_utilization,
                     bounds=b8.bound_histogram()))
    nws = no_weight_stationarity(chip, specs, batch=1)
    rows.append(dict(config="ablation: no weight reuse", batch=1,
                     img_per_s=nws.throughput_per_s,
                     mac_util=nws.mac_utilization,
                     bounds=nws.bound_histogram()))
    sram = schedule(sram_cache_chip(), specs, batch=1)
    rows.append(dict(config="ablation: 256GB/s memory", batch=1,
                     img_per_s=sram.throughput_per_s,
                     mac_util=sram.mac_utilization,
                     bounds=sram.bound_histogram()))
    ok &= nws.throughput_per_s < base.throughput_per_s / 1.5
    return {"name": "resnet50_throughput", "ok": ok, "rows": rows,
            "paper_img_per_s": 1500.0}


def pretty(result: dict):
    print("== ResNet-50 on Sunrise (paper claim: 1500 img/s) ==")
    print(f"{'config':<28}{'batch':>6}{'img/s':>9}{'MAC util':>10}  bounds")
    for r in result["rows"]:
        print(f"{r['config']:<28}{r['batch']:>6}{r['img_per_s']:>9.0f}"
              f"{r['mac_util']:>10.2f}  {r['bounds']}")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} (within 10% of 1500; "
          "weight stationarity is load-bearing)\n")


if __name__ == "__main__":
    pretty(run())
