"""``StaleOptAlpha``: OPT-α solved on the first epoch, that A projected onto
each epoch's graph (every weight the graph cannot carry zeroed)."""
from __future__ import annotations

from portbench.reference import opt_alpha
from portbench.reference.policies import no_churn, per_epoch


def matrices(spec: dict, states) -> list:
    first = []

    def solve(state):
        no_churn(state)
        adj, p, _ = state
        if not first:
            first.append(opt_alpha.optimize(p, adj, sweeps=spec["sweeps"]))
        return opt_alpha.project_to_support(first[0], adj)

    return per_epoch(states, solve)
