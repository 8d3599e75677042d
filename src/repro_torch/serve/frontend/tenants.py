"""Per-tenant budget shares: weighted max-min over active tenants.

The engine's token-budget tick (DESIGN.md §6) splits each tick between
prefill and decode; multi-tenant serving needs the SAME split again one
level up — between tenants sharing the engine.  This module is the pure
scheduling math: given an integer token budget and per-tenant demands,
`TenantScheduler.allocate` returns integer grants that are

  * **work-conserving** — sum(grants) == min(budget, sum(demands)):
    a tenant never holds tokens another tenant could use;
  * **weighted max-min fair** — continuous water-filling: tenants whose
    demand sits below their weighted proportional level are saturated
    (granted their full demand) and the freed budget re-divides among
    the rest, so heavy tenants can never squeeze a light tenant below
    its weighted share;
  * **starvation-free at integer granularity** — fractional shares are
    rounded by largest-remainder, and the rounding error CARRIES as
    per-tenant credit to the next tick: a tenant whose fair share is
    0.1 tokens/tick accumulates credit and wins a whole token every
    ~10 ticks instead of never.

The scheduler is deliberately free of any engine/asyncio dependency:
`serve/engine.py` imports it to enforce the shares INSIDE the existing
tick (prefill chunk caps, decode row caps, admission order), and
`serve/frontend/server.py` merely names tenants on requests — there is
no queue bolted on top of the scheduler.
"""
from __future__ import annotations


class TenantScheduler:
    """Weighted max-min allocator with cross-tick rounding credit.

    `weights` maps tenant name -> positive weight; tenants not named
    weigh `default_weight`.  One scheduler instance serves several
    budget kinds (prefill tokens, decode rows) — `kind` namespaces the
    carried credit so the two streams don't cross-subsidize."""

    def __init__(self, weights: dict[str, float] | None = None,
                 default_weight: float = 1.0):
        if default_weight <= 0:
            raise ValueError(f"default_weight must be > 0, got "
                             f"{default_weight}")
        self.weights: dict[str, float] = {}
        for t, w in (weights or {}).items():
            if float(w) <= 0:
                raise ValueError(f"tenant {t!r}: weight must be > 0, "
                                 f"got {w}")
            self.weights[str(t)] = float(w)
        self.default_weight = float(default_weight)
        self._credit: dict[tuple[str, str], float] = {}
        # cumulative tokens granted per (kind, tenant) — observability
        self.granted: dict[str, dict[str, int]] = {}

    def weight_of(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    # ------------------------------------------------------- fair shares

    def fair_shares(self, budget: float,
                    demands: dict[str, float]) -> dict[str, float]:
        """Continuous weighted max-min water-filling.  Returns per-tenant
        real shares with sum == min(budget, sum(demands)); a tenant's
        share never exceeds its demand."""
        shares = {t: 0.0 for t in demands}
        live = {t: float(d) for t, d in demands.items() if d > 0}
        remaining = float(budget)
        while live and remaining > 1e-9:
            total_w = sum(self.weight_of(t) for t in live)
            level = {t: remaining * self.weight_of(t) / total_w
                     for t in live}
            sat = [t for t in live if live[t] <= level[t] + 1e-12]
            if not sat:
                # nobody saturates: split the rest proportionally
                for t in live:
                    shares[t] = level[t]
                return shares
            for t in sat:
                shares[t] = live.pop(t)
                remaining -= shares[t]
        return shares

    # ------------------------------------------------- integer allocation

    def allocate(self, budget: int, demands: dict[str, int],
                 kind: str = "") -> dict[str, int]:
        """Integer grants: floor the continuous fair shares, then hand
        the leftover out largest-(remainder+credit)-first (name-ordered
        ties — deterministic).  The unpaid fraction carries as credit so
        repeated small shares eventually buy whole tokens."""
        grants = {t: 0 for t in demands}
        budget = int(budget)
        total_demand = sum(max(int(d), 0) for d in demands.values())
        if budget <= 0 or total_demand <= 0:
            return grants
        ideal = self.fair_shares(budget, demands)
        frac: dict[str, float] = {}
        for t, share in ideal.items():
            g = min(int(share + 1e-9), int(demands[t]))
            grants[t] = g
            frac[t] = max(share - g, 0.0)
        leftover = min(budget, total_demand) - sum(grants.values())
        order = sorted(
            demands,
            key=lambda t: (-(frac[t] + self._credit.get((kind, t), 0.0)), t))
        boosted: set[str] = set()
        for t in order:
            if leftover <= 0:
                break
            if grants[t] < demands[t]:
                grants[t] += 1
                leftover -= 1
                boosted.add(t)
        book = self.granted.setdefault(kind, {})
        for t in demands:
            credit = self._credit.get((kind, t), 0.0) + frac[t]
            if t in boosted:
                credit -= 1.0
            # clip: an idle or demand-less tick must not bank unbounded
            # priority, and a boosted tenant owes at most one token
            self._credit[(kind, t)] = min(max(credit, -1.0), 1.0)
            if grants[t]:
                book[t] = book.get(t, 0) + grants[t]
        return grants

    def stats(self) -> dict:
        return {"weights": dict(self.weights),
                "default_weight": self.default_weight,
                "granted": {k: dict(v) for k, v in self.granted.items()}}
