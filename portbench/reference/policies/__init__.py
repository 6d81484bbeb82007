"""The reference's side of each relay policy kind:
``reference/policies/<kind>.py`` holds ``matrices(spec, states)`` → each
round's relay matrix A (f64 (n, n), ``A[j, i] = α_ji``) for the channel
states of ``reference/channels``.  A policy is asked once a channel epoch
(a run of rounds whose state is the same), as the port's prefetcher asks
it; each follows ``src/repro/channels/scheduler.py`` (the JAX package's,
numpy, copied at commit c3a27a4, not imported)."""
from __future__ import annotations


def per_epoch(states, solve) -> list:
    """``solve(state)`` once for each new epoch, its A for every round."""
    out, prev, A = [], None, None
    for state in states:
        adj, p, active = state
        key = (adj.tobytes(), p.tobytes(), None if active is None else active.tobytes())
        if key != prev:
            prev, A = key, solve(state)
        out.append(A)
    return out


def no_churn(state) -> None:
    if state[2] is not None:
        raise NotImplementedError("a churn mask needs OPT-alpha's masked solve, which this "
                                  "policy's reference does not hold")
