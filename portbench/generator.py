"""The one generator of traffic: a mix's parameters (``traffic/<name>.json``)
→ the port's channel schedule, relay policy and engine, and the reference's
channel states and relay matrices.

Every mechanism a mix names is a module of its own, found by its ``kind``,
so a new mechanism is a new file and a mix that uses it:

* ``channel.topology`` → ``topologies/<kind>.py`` (the base graph, an input
  both sides take);
* ``channel`` → ``channels/<kind>.py`` (the port's schedule) and
  ``reference/channels/<kind>.py`` (each round's graph, p and membership);
* ``policy`` → ``policies/<kind>.py`` (the port's relay policy) and
  ``reference/policies/<kind>.py`` (each round's A);
* ``engine`` → ``engines/<kind>.py`` (the port's engine over the
  simulator; ``chunk`` rounds a captured chunk).

The mix's ``check_calls`` are the rounds of the set-up calls the check
follows, and ``block_rounds`` the rounds of each call in the measured
window.
"""
from __future__ import annotations

import importlib

import numpy as np


def _kind(package: str, spec: dict):
    return importlib.import_module(f"portbench.{package}.{spec['kind']}")


def base_graph(traffic: dict, n: int) -> np.ndarray:
    """The mix's base graph over ``n`` clients, checked against its p0."""
    ch = traffic["channel"]
    if len(ch["p0"]) != n:
        raise ValueError(f"p0 has {len(ch['p0'])} entries for {n} clients")
    return _kind("topologies", ch["topology"]).adjacency(ch["topology"], n)


def program_channel(traffic: dict, n: int, seeds: dict):
    """(schedule, policy) of the port's ``channels`` package."""
    ch, pol = traffic["channel"], traffic["policy"]
    schedule = _kind("channels", ch).schedule(ch, base_graph(traffic, n), seeds)
    return schedule, _kind("policies", pol).policy(pol)


def program_engine(traffic: dict, sim):
    """The port's engine over ``sim``, as the mix's ``engine`` block names it."""
    return _kind("engines", traffic["engine"]).engine(traffic["engine"], sim)


def reference_channel(traffic: dict, n: int, seeds: dict, rounds: int):
    """The first ``rounds`` rounds' channel states ``(adj, p, active)`` and
    relay matrices, worked out again without the port."""
    ch, pol = traffic["channel"], traffic["policy"]
    states = importlib.import_module(f"portbench.reference.channels.{ch['kind']}").rounds(
        ch, base_graph(traffic, n), seeds, rounds)
    matrices = importlib.import_module(
        f"portbench.reference.policies.{pol['kind']}").matrices(pol, states)
    return states, matrices
