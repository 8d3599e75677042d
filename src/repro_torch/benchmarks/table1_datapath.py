"""Paper Table I: Interposer vs TSV vs HITOC data-path comparison."""
from __future__ import annotations

from repro_torch.core import datapath as DP


def run() -> dict:
    rows, ok = [], True
    for tech in (DP.INTERPOSER, DP.TSV, DP.HITOC):
        rep = DP.report(tech)
        want = DP.PAPER_TABLE1[tech.name]
        d_density = rep.wire_density / want["density"] - 1
        d_bw = rep.bandwidth_TBps / want["bandwidth_TBps"] - 1
        ok &= abs(d_density) < 0.05 and abs(d_bw) < 0.05
        rows.append(dict(
            tech=tech.name, pitch_um=tech.pitch_um,
            density=rep.wire_density, density_paper=want["density"],
            bw_TBps=rep.bandwidth_TBps, bw_paper=want["bandwidth_TBps"],
            pJ_per_bit=rep.energy_pj_per_bit,
            watts_at_full_bw=rep.power_w_at_bw,
        ))
    return {"name": "table1_datapath", "ok": ok, "rows": rows}


def pretty(result: dict):
    print("== Table I: data-path comparison (computed vs paper) ==")
    hdr = f"{'tech':<11}{'pitch um':>9}{'wires/mm^2':>13}{'paper':>11}" \
          f"{'TB/s':>9}{'paper':>7}{'pJ/b':>7}{'W@BW':>8}"
    print(hdr)
    for r in result["rows"]:
        print(f"{r['tech']:<11}{r['pitch_um']:>9.1f}{r['density']:>13.3g}"
              f"{r['density_paper']:>11.3g}{r['bw_TBps']:>9.3g}"
              f"{r['bw_paper']:>7.3g}{r['pJ_per_bit']:>7.2f}"
              f"{r['watts_at_full_bw']:>8.2f}")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} (within 5% of paper)\n")


if __name__ == "__main__":
    pretty(run())
