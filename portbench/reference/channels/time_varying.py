"""``src/repro/channels/schedule.py::TimeVaryingChannel``'s rounds: round 0
is the processes' first state; every later round steps the drift, and the
links every ``adj_every`` rounds."""
from __future__ import annotations

import numpy as np

from portbench.reference.channels.processes import MarkovLinks, PiecewiseConstant


def rounds(spec: dict, adj: np.ndarray, seeds: dict, k: int) -> list:
    link, drift = spec["link"], spec["drift"]
    links = MarkovLinks(adj, link["p_up_to_down"], link["p_down_to_up"], link["seed"])
    p_proc = PiecewiseConstant(np.asarray(spec["p0"], dtype=np.float32), drift["hold"],
                               drift["low"], drift["high"], drift["seed"])
    now = links.adjacency()
    out = []
    for r in range(k):
        if r > 0:
            if r % spec["adj_every"] == 0:
                now = links.step()
            p_proc.step()
        out.append((now, p_proc.p.astype(np.float32), None))
    return out
