"""The comparison that decides ``correct``.

Set-up drives the port's engine through its first K rounds (the mix's
``check_calls``), and the reference (:mod:`portbench.reference.fl`)
follows the same K rounds from the same weights, batches, channel and τ.
Four numbers, each with a limit of its own (``checks/<workload>.json``):

* ``first_loss_gap``: |loss − reference loss| / |reference loss| of the
  first round, the clients' mean loss at the benchmark's initial weights:
  the forward pass alone, steady from seed to seed;
* ``loss_gap``: the worst round's |loss − reference loss| / |reference
  loss|, over the K rounds (each round's loss is the clients' mean loss at
  their first local step, so rounds 2..K read the whole update chain);
* ``first_update_gap``: the server's first update x1 − x0 (the increment
  the server optimizer applies), by the worst leaf:
  | ‖program leaf‖ − ‖reference leaf‖ | over the larger of the reference
  leaf's norm and the median leaf's;
* ``change_gap``: the same for the change after the K rounds, xK − x0.

Leaves whose reference first update is under a thousandth of the median
leaf's are left out of both (round-off alone moves them).  A cell compares
the numbers its limits file lists; a number left out there is one whose
sound runs reach its control's readings, with the readings beside it.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

NUMBERS = ("first_loss_gap", "loss_gap", "first_update_gap", "change_gap")
LEAF_FLOOR = 1e-3


def load_limits(root: Path, workload: str) -> dict[str, float]:
    """The cell's limits, one a number it compares, in the order of
    :data:`NUMBERS`."""
    limits = json.loads((root / "portbench" / "checks" / f"{workload}.json").read_text())
    unknown = set(limits["limits"]) - set(NUMBERS)
    if unknown or not limits["limits"]:
        raise ValueError(f"{workload}: limits {sorted(limits['limits'])} (known: {NUMBERS})")
    return {name: float(limits["limits"][name]) for name in NUMBERS if name in limits["limits"]}


def norms(x: dict, x0: dict) -> dict[str, float]:
    """Each leaf's ‖x − x0‖, in double: what the two gaps of the weights
    read, so a run holds the norms rather than a copy of x."""
    return {k: float(torch.linalg.vector_norm(x[k].double() - x0[k].double()))
            for k in x0}


def _worst(values) -> float:
    """The largest value; infinite if any is not finite (a NaN compares
    false and would hide in ``max``)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _worst_leaf_gap(prog: dict, ref: dict, kept: list[str]) -> float:
    median = sorted(ref[k] for k in kept)[len(kept) // 2]
    return _worst(abs(prog[k] - ref[k]) / max(ref[k], median) for k in kept)


def compare(prog_losses, prog_first: dict, prog_change: dict,
            ref_losses, ref_first: dict, ref_change: dict) -> dict[str, float]:
    """The four numbers of a program (or control) run against the
    reference, from each side's losses and its :func:`norms` of x1 − x0 and
    xK − x0 (leaf name → float)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses, strict=True)]
    median = sorted(ref_first.values())[len(ref_first) // 2]
    kept = [k for k, v in ref_first.items() if v >= LEAF_FLOOR * median]
    first = _worst_leaf_gap(prog_first, ref_first, kept)
    change = _worst_leaf_gap(prog_change, ref_change, kept)
    return {"first_loss_gap": _worst(gaps[:1]), "loss_gap": _worst(gaps),
            "first_update_gap": first, "change_gap": change}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
