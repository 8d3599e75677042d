"""Paper Table IV: NRE / die cost / cost-per-TOPS from first principles."""
from __future__ import annotations

from repro_torch.core import hwmodel as HW


def run() -> dict:
    rows, ok = [], True
    for rep in HW.table4():
        nre, die, cpt = HW.PAPER_TABLE4[rep.name]
        ratio = rep.die_cost_usd / die
        ok &= rep.nre_usd == nre and 0.4 < ratio < 2.5
        rows.append(dict(
            chip=rep.name, nre_usd=rep.nre_usd, nre_paper=nre,
            gross_dies=rep.gross_dies, yield_frac=rep.yield_frac,
            die_cost=rep.die_cost_usd, die_cost_paper=die,
            cost_per_tops=rep.cost_per_tops, cpt_paper=cpt,
        ))
    best = min(rows, key=lambda r: r["cost_per_tops"])
    ok &= best["chip"] == "Sunrise"   # the paper's headline cost claim
    return {"name": "table4_cost", "ok": ok, "rows": rows}


def pretty(result: dict):
    print("== Table IV: cost comparison (computed | paper) ==")
    print(f"{'chip':<10}{'NRE $M':>8}{'gross':>7}{'yield':>7}"
          f"{'die $':>16}{'$/TOPS':>16}")
    for r in result["rows"]:
        print(f"{r['chip']:<10}{r['nre_usd'] / 1e6:>8.1f}"
              f"{r['gross_dies']:>7.0f}{r['yield_frac']:>7.2f}"
              f"{r['die_cost']:>8.0f}|{r['die_cost_paper']:<7.0f}"
              f"{r['cost_per_tops']:>8.2f}|{r['cpt_paper']:<7.2f}")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} "
          "(NRE exact, die cost within publication tolerance, "
          "Sunrise best $/TOPS)\n")


if __name__ == "__main__":
    pretty(run())
