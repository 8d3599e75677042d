"""Paper Tables V-VII: process normalization to 7nm CMOS + 1y DRAM."""
from __future__ import annotations

from repro_torch.core import hwmodel as HW
from repro_torch.core import projection as PJ


def run() -> dict:
    rows, ok = [], True
    for proj in PJ.table7():
        want = PJ.PAPER_TABLE7[proj.name]
        checks = []
        if proj.name == "Sunrise":      # the paper's headline projection
            checks = [abs(proj.tops_per_mm2 / want[0] - 1) < 0.10,
                      abs(proj.mb_per_mm2 / want[2] - 1) < 0.10,
                      abs(proj.tops_per_w / want[3] - 1) < 0.10]
        ok &= all(checks)
        rows.append(dict(
            chip=proj.name,
            tops_mm2=proj.tops_per_mm2, tops_mm2_paper=want[0],
            bw_mm2=proj.bw_gbps_per_mm2, bw_mm2_paper=want[1],
            mb_mm2=proj.mb_per_mm2, mb_mm2_paper=want[2],
            tops_w=proj.tops_per_w, tops_w_paper=want[3],
            density_scale=proj.density_scale,
            power_density=proj.power_density_w_mm2,
        ))
    sun = rows[0]
    for other in rows[1:]:
        ok &= sun["tops_mm2"] > other["tops_mm2"]
        ok &= sun["tops_w"] > other["tops_w"]
        ok &= sun["mb_mm2"] > other["mb_mm2"]
    cap = PJ.sunrise_big_die_capacity_gb(800.0)
    ok &= abs(cap / 24.0 - 1) < 0.10
    return {"name": "table57_projection", "ok": ok, "rows": rows,
            "big_die_capacity_gb": cap}


def pretty(result: dict):
    print("== Tables V-VII: normalized to 7nm CMOS + 1y DRAM "
          "(computed | paper) ==")
    print(f"{'chip':<10}{'TOPS/mm2':>17}{'GB/s/mm2':>17}{'MB/mm2':>16}"
          f"{'TOPS/W':>16}")
    for r in result["rows"]:
        bw = ("  no data" if r["bw_mm2"] is None
              else f"{r['bw_mm2']:>8.0f}|{r['bw_mm2_paper'] or 0:<6.0f}")
        print(f"{r['chip']:<10}{r['tops_mm2']:>9.2f}|{r['tops_mm2_paper']:<7.2f}"
              f"{bw:>17}"
              f"{r['mb_mm2']:>9.1f}|{r['mb_mm2_paper']:<6.1f}"
              f"{r['tops_w']:>9.1f}|{r['tops_w_paper']:<6.2f}")
    print(f"800mm2-die UniMem capacity: {result['big_die_capacity_gb']:.1f} GB "
          "(paper: 24 GB)")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} (Sunrise within 10% of "
          "its projections and dominant on every metric)\n")


if __name__ == "__main__":
    pretty(run())
