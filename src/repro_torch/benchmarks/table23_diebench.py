"""Paper Tables II/III: raw specs + die-normalized benchmark comparison."""
from __future__ import annotations

from repro_torch.core import hwmodel as HW


def run() -> dict:
    rows, ok = [], True
    for chip in HW.ALL_CHIPS:
        got = HW.die_normalized(chip)
        want = HW.PAPER_TABLE3[chip.name]
        checks = [abs(got.tops_per_mm2 / want[0] - 1) < 0.05,
                  abs(got.mb_per_mm2 / want[2] - 1) < 0.05,
                  abs(got.tops_per_w / want[3] - 1) < 0.05]
        if want[1] is not None and got.bw_gbps_per_mm2 is not None:
            checks.append(abs(got.bw_gbps_per_mm2 / want[1] - 1) < 0.05)
        ok &= all(checks)
        rows.append(dict(
            chip=chip.name, process_nm=chip.process_nm,
            die_mm2=chip.die_area_mm2, tops=chip.peak_tops,
            mem_mb=chip.memory_mb, power_w=chip.power_w,
            tops_mm2=got.tops_per_mm2, tops_mm2_paper=want[0],
            bw_mm2=got.bw_gbps_per_mm2, bw_mm2_paper=want[1],
            mb_mm2=got.mb_per_mm2, mb_mm2_paper=want[2],
            tops_w=got.tops_per_w, tops_w_paper=want[3],
        ))
    sun = rows[0]
    ok &= sun["mb_mm2"] == max(r["mb_mm2"] for r in rows)
    ok &= sun["tops_w"] == max(r["tops_w"] for r in rows)
    return {"name": "table23_diebench", "ok": ok, "rows": rows}


def pretty(result: dict):
    print("== Tables II/III: die-normalized benchmarks (computed | paper) ==")
    print(f"{'chip':<10}{'nm':>4}{'TOPS/mm2':>17}{'GB/s/mm2':>17}"
          f"{'MB/mm2':>15}{'TOPS/W':>15}")
    for r in result["rows"]:
        bw = ("  no data" if r["bw_mm2"] is None
              else f"{r['bw_mm2']:>7.1f}|{r['bw_mm2_paper'] or 0:<7.1f}")
        print(f"{r['chip']:<10}{r['process_nm']:>4}"
              f"{r['tops_mm2']:>9.2f}|{r['tops_mm2_paper']:<7.2f}"
              f"{bw:>17}"
              f"{r['mb_mm2']:>8.2f}|{r['mb_mm2_paper']:<6.2f}"
              f"{r['tops_w']:>8.2f}|{r['tops_w_paper']:<6.2f}")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} "
          "(within 5%; Sunrise leads capacity + efficiency)\n")


if __name__ == "__main__":
    pretty(run())
