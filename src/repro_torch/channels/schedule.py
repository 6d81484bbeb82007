"""ChannelSchedule: the per-round channel state stream.

A schedule yields one :class:`ChannelState` per federated round — the realized
D2D adjacency, the uplink probability vector, and an ``epoch_id`` that
increments exactly when ``(adj, p)`` changes value.  Epochs are what the
adaptive OPT-α scheduler keys on: within an epoch the cached relay matrix is
exact, across epochs it re-optimizes (warm-started).

The simulator consumes only *values* from the state (A, p, τ and the churn
mask are per-round inputs of ``FLSimulator.run_round``), so channel dynamics
are a host-side concern, exactly like the data loader.  The PyTorch
counterpart of the JAX package's ``channels/schedule.py``, kept line for
line: the same seeds emit the same stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import topology
from repro_torch.channels.drift import StaticP
from repro_torch.obs import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class ChannelState:
    """One round's channel: realized D2D graph + uplink marginals.

    ``active`` is the client-churn membership mask over the padded client
    dimension (``None`` ⇒ full membership, the pre-churn states).  It is part
    of the value identity: a membership change opens a new epoch, and the
    adaptive scheduler's cache keys on it — the optimal relay weights over a
    different active set are a different matrix.
    """

    round: int
    epoch_id: int
    adj: np.ndarray  # (n_max, n_max) bool, symmetric, zero diagonal
    p: np.ndarray  # (n_max,) float32 in [0, 1]
    active: np.ndarray | None = None  # (n_max,) bool, None ⇒ all live

    def key(self) -> tuple[bytes, bytes, bytes]:
        """Value-identity key (the adaptive scheduler's cache key).

        Memoized on the instance: ``adj.tobytes()`` on a 10⁴-node graph is a
        ~100 MB serialization, and the key is read at least twice per round
        (epoch bookkeeping in ``_emit`` plus every scheduler-policy lookup).
        ``_emit`` pre-installs the key built from its own cached component
        bytes, so steady-state rounds never re-serialize an unchanged
        adjacency at all.
        """
        cached = self.__dict__.get("_key_cache")
        if cached is None:
            cached = (
                self.adj.tobytes(),
                self.p.tobytes(),
                b"" if self.active is None else self.active.tobytes(),
            )
            object.__setattr__(self, "_key_cache", cached)
        return cached

    @property
    def n_active(self) -> int:
        return int(self.active.sum()) if self.active is not None else self.p.shape[0]


@dataclasses.dataclass(frozen=True)
class ChannelSegment:
    """A maximal run of consecutive rounds sharing one channel value.

    ``epoch_id`` increments exactly when ``(adj, p, active)`` changes, so
    grouping consecutive states by it yields segments within which the relay
    matrix, the uplink marginals and the membership mask are all constant —
    the unit of work of the epoch engines
    (:class:`repro_torch.fl.engine.EpochScanEngine`): one relay matrix and
    one device conversion of (A, p, active) per segment.
    """

    epoch_id: int
    start_round: int
    states: tuple[ChannelState, ...]

    @property
    def n_rounds(self) -> int:
        return len(self.states)

    @property
    def state(self) -> ChannelState:
        """The shared channel value (any round's state; they are equal up to
        the round counter) — what a scheduler policy solves on."""
        return self.states[0]

    @property
    def adj(self) -> np.ndarray:
        return self.states[0].adj

    @property
    def p(self) -> np.ndarray:
        return self.states[0].p

    @property
    def active(self) -> np.ndarray | None:
        return self.states[0].active


class ChannelSchedule:
    """Base class: subclasses implement ``next_round``; ``_emit`` canonicalizes
    dtypes and maintains the round counter and epoch bookkeeping."""

    def __init__(self):
        self._round = 0
        self._epoch = -1
        self._last_key = None
        # (source ref, read-only snapshot, serialized bytes) of the last
        # emitted adjacency — reused when the producer declares it unchanged,
        # so a static 10⁴-node graph costs one 100 MB copy + serialization
        # per run instead of one per round.
        self._adj_cache: tuple | None = None
        # Telemetry sink: segments() marks every epoch boundary with an
        # instant event.  Plain attribute (not a ctor param) so the bench
        # harness can attach a tracer to an already-built schedule.
        self.tracer = NULL_TRACER

    def _emit(
        self,
        adj: np.ndarray,
        p: np.ndarray,
        active: np.ndarray | None = None,
        *,
        adj_unchanged: bool = False,
    ) -> ChannelState:
        # Snapshot (copy) every array: ``segments()`` holds emitted states one
        # epoch past their round (it must see the *next* state to know a run
        # ended), and a jointly-sampled process that updates its buffers in
        # place would otherwise mutate the yielded segment's (adj, p, active)
        # under the consumer — ascontiguousarray alone aliases when dtype and
        # layout already match.
        #
        # ``adj_unchanged`` is the producer's promise that its adjacency
        # process did not step since the last emit; combined with an identity
        # check on the source array, the previous round's (read-only)
        # snapshot and bytes are reused — identity alone would be unsafe, the
        # shadowing processes mutate their buffers in place when they *do*
        # step.
        if (
            adj_unchanged
            and self._adj_cache is not None
            and adj is self._adj_cache[0]
        ):
            _, adj_snap, adj_bytes = self._adj_cache
        else:
            adj_snap = np.array(adj, dtype=bool, order="C", copy=True)
            adj_snap.setflags(write=False)
            adj_bytes = adj_snap.tobytes()
            self._adj_cache = (adj, adj_snap, adj_bytes)
        p = np.array(p, dtype=np.float32, order="C", copy=True)
        if adj_snap.shape[0] != p.shape[0]:
            raise ValueError(
                f"channel size mismatch: adj is {adj_snap.shape[0]}-node, "
                f"p has {p.shape[0]} entries"
            )
        if np.any(p < 0) or np.any(p > 1):
            raise ValueError("p left [0, 1]")
        if active is not None:
            active = np.array(active, dtype=bool, order="C", copy=True)
            if active.shape != p.shape:
                raise ValueError(
                    f"active mask has shape {active.shape}, expected {p.shape}"
                )
        key = (
            adj_bytes,
            p.tobytes(),
            b"" if active is None else active.tobytes(),
        )
        if key != self._last_key:
            self._epoch += 1
            self._last_key = key
        state = ChannelState(self._round, self._epoch, adj_snap, p, active)
        object.__setattr__(state, "_key_cache", key)
        self._round += 1
        return state

    def next_round(self) -> ChannelState:
        raise NotImplementedError

    def rounds(self, n_rounds: int):
        """Iterator over the next ``n_rounds`` channel states."""
        for _ in range(n_rounds):
            yield self.next_round()

    def segments(self, n_rounds: int):
        """Iterator over the next ``n_rounds`` rounds grouped into maximal
        constant-channel :class:`ChannelSegment` runs (consecutive states
        with the same ``epoch_id``).  Concatenating ``seg.states`` over the
        yielded segments reproduces ``rounds(n_rounds)`` exactly."""
        buf: list[ChannelState] = []
        for state in self.rounds(n_rounds):
            if buf and state.epoch_id != buf[0].epoch_id:
                if self.tracer.enabled:
                    self.tracer.instant(
                        "segment",
                        cat="schedule",
                        epoch=buf[0].epoch_id,
                        start_round=buf[0].round,
                        n_rounds=len(buf),
                    )
                yield ChannelSegment(buf[0].epoch_id, buf[0].round, tuple(buf))
                buf = []
            buf.append(state)
        if buf:
            if self.tracer.enabled:
                self.tracer.instant(
                    "segment",
                    cat="schedule",
                    epoch=buf[0].epoch_id,
                    start_round=buf[0].round,
                    n_rounds=len(buf),
                )
            yield ChannelSegment(buf[0].epoch_id, buf[0].round, tuple(buf))


class StaticChannel(ChannelSchedule):
    """The seed setting: one fixed (adj, p) — a single epoch forever."""

    def __init__(self, adj: np.ndarray, p: np.ndarray):
        super().__init__()
        self._adj = topology._validate(np.asarray(adj, dtype=bool).copy())
        self._p = np.asarray(p, dtype=np.float32)

    def next_round(self) -> ChannelState:
        return self._emit(self._adj, self._p, adj_unchanged=self._round > 0)


class TimeVaryingChannel(ChannelSchedule):
    """Composes a link-state process (Markov / mobility / shadowing) with a
    p-drift process.  Either side may be static: pass ``adj=...`` instead of
    ``link_process`` and/or a plain vector ``p=...`` instead of ``p_process``.

    ``adj_every`` / ``p_every`` throttle how often each process advances
    (e.g. topology churning every round while p re-estimates every 10).
    Round 0 uses the processes' initial states.
    """

    def __init__(
        self,
        *,
        link_process=None,
        adj: np.ndarray | None = None,
        p_process=None,
        p: np.ndarray | None = None,
        adj_every: int = 1,
        p_every: int = 1,
    ):
        super().__init__()
        if (link_process is None) == (adj is None):
            raise ValueError("pass exactly one of link_process / adj")
        if (p_process is None) == (p is None):
            raise ValueError("pass exactly one of p_process / p")
        if adj_every < 1 or p_every < 1:
            raise ValueError("adj_every / p_every must be >= 1")
        self._link = link_process
        self._pproc = StaticP(p) if p_process is None else p_process
        self._adj = (
            topology._validate(np.asarray(adj, dtype=bool).copy())
            if link_process is None
            else link_process.adjacency()
        )
        self._adj_every = int(adj_every)
        self._p_every = int(p_every)

    def _membership(self) -> np.ndarray | None:
        """Churn hook: the current active mask (None ⇒ fixed membership).
        Overridden by :class:`repro_torch.channels.churn.ChurnSchedule`."""
        return None

    def next_round(self) -> ChannelState:
        r = self._round
        adj_stepped = False
        if r > 0:
            if self._link is not None and r % self._adj_every == 0:
                self._adj = self._link.step()
                adj_stepped = True
            if r % self._p_every == 0:
                self._pproc.step()
        return self._emit(
            self._adj,
            self._pproc.value(),
            self._membership(),
            adj_unchanged=r > 0 and not adj_stepped,
        )
