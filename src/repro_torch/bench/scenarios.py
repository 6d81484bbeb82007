"""Declarative benchmark scenarios: topology × fading × drift × churn.

The PyTorch counterpart of the JAX package's ``bench/scenarios.py``.  A
:class:`ScenarioSpec` is pure data — every field is a plain value, so a
scenario can live in a registry, be printed by ``--list``, and be serialized
into its ``BENCH_*.json`` report.  ``build()`` turns a spec into the factory
bundle the harness consumes; each engine run gets *fresh* schedule / policy /
loader instances so cold and warm runs see identical streams.

The fields, their names and defaults are the JAX package's, so
``dataclasses.asdict`` gives the same ``spec`` block.  Backend values are
renamed by :data:`BACKEND_FROM_JAX` (``pallas`` → ``hopper``, ``pallas_fused``
→ ``hopper_fused``).

The registered scenarios:

  bench_smoke     tiny CI gate scenario (seconds on one CPU core)
  fig5_500        the acceptance scenario: 500 rounds, n=10, ring(10, 2) with
                  bursty Markov fading + piecewise-constant p-drift at a
                  25-round coherence time
  fig5_chunk5 / fig5_chunk125
                  chunk-size-vs-coherence-time sweep around fig5_500's
                  matched chunk=25 (the descriptions are the JAX package's:
                  the port runs a remainder chunk at its real length, so
                  chunk=125 pads nothing here)
  fig6_500        fig5_500 plus rotating-cohort churn (the Fig. 6 setting)
  static_500      single-epoch control: the seed paper's static channel
  corr_shadow_500 correlated shadowing: one GP blockage field drives the D2D
                  graph, p static
  corr_uplink_500 corr_shadow_500 with the uplink coupled to the same fade
  mesh_corr_500   the mesh round step (``build_round_step`` vs
                  ``build_scan_round_step`` vs ``build_fused_scan_round_step``)
                  under the coupled correlated channel — ``spec.step =
                  "mesh"`` swaps the execution path
  resnet20_cifar  the paper's §V model (ResNet-20/GN) on CIFAR-shaped
                  synthetic batches through all three engines, with the
                  ``hopper`` mix-kernel check on the side
  relay_sweep_1e4 / _1e5 / _1e6 / _1e7 / _smoke
                  the relay/aggregate hot spot swept over model size
                  D = 10⁴ … 10⁷; reference engines + the mandatory
                  ``hopper_fused`` kernel check
  sample_sweep_n1e3 / _n1e4 / _smoke
                  the n ≫ 10³ client-scale regime: sparse geometric graph,
                  per-round fixed-k cohorts (CohortSampler), the
                  neighborhood-blocked sparse OPT-α (SparseOptAlpha) and the
                  ``segment`` backend; n1e3 and smoke carry the einsum check
  mesh8_smoke     the multi-rank gate: client-sharded fused scan over 8 ranks
                  (gather exchange, hopper_fused parity check on the side);
                  ``python -m repro_torch.bench.run`` starts the ranks
  mesh8_ring_churn
                  block-ring exchange under rotating-cohort churn +
                  correlated shadowing, 8 ranks
  mesh2_dshard    D-axis mode: the (n, D) relay contraction split over a
                  2-rank "model" axis
  async_ttac_500  time-to-accuracy under Poisson arrival delays: the
                  staleness-weighted async engine vs the loop and pipelined
                  engines on the fig5 channel, with the mandatory delay-0
                  parity gate (async == loop bitwise)
  async_smoke     CI-sized async point: geometric delays, buffer_k
                  selection and the delay-0 parity gate in seconds
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import channels
from repro_torch.configs.resnet20_cifar import CONFIG as _RESNET20_CONFIG
from repro_torch.core import connectivity, topology
from repro_torch.core.aggregation import ServerOpt
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import iid_partition
from repro_torch.data.synthetic import cifar_like, gaussian_classification
from repro_torch.fl.async_engine import SUPPORTED_STRATEGIES as _ASYNC_STRATEGIES
from repro_torch.fl.simulator import FLSimulator
from repro_torch.kernels.ops import RELAY_BACKENDS, validate_sharded_backend
from repro_torch.models.resnet import init_resnet20, resnet20_loss
from repro_torch.optim.sgd import ClientOpt
from repro_torch.utils import resolve_device

# the JAX package's relay-backend names → the port's
BACKEND_FROM_JAX = {"einsum": "einsum", "pallas": "hopper", "pallas_fused": "hopper_fused"}

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One benchmark setting.  All fields are plain data (JSON-serializable
    via ``dataclasses.asdict``).

    ``block_d`` is kept as data (the JAX package's Pallas Δ tile); the CUDA
    kernels size their own launch (``kernels.relay_mix.fused_aggregate_plan``),
    so the port ignores it."""

    name: str
    description: str = ""
    # federated setting
    n_clients: int = 10
    rounds: int = 100
    local_steps: int = 2
    local_batch: int = 8
    strategy: str = "colrel_fused"
    policy: str = "adaptive"  # adaptive | sparse | stale | none
    opt_method: str = "exact"  # OPT-α column solver (exact | bisect)
    opt_sweeps: int = 40
    warm_sweeps: int = 12
    lr: float = 0.1
    seed: int = 0
    # model / data: "mlp" = spec-sized MLP over flat gaussian features
    # (dim/width apply); "resnet20" = the paper's §V ResNet-20 over
    # CIFAR-shaped synthetic images (dim/width ignored)
    model: str = "mlp"
    dim: int = 64
    width: int = 32
    n_classes: int = 10
    n_train: int = 1024
    # relay backend for the (n, D) aggregation hot spot (repro_torch.kernels):
    # einsum = plain torch, hopper / hopper_fused = the CUDA kernels,
    # segment = the sparse EdgeRelay path (policy="sparse").
    # check_backend != "none" makes the harness run one extra scan pass on
    # that backend and assert allclose against the reference engines' finals
    # (the mandatory kernel parity check; recorded as report.kernel_check).
    relay_backend: str = "einsum"
    block_d: int | None = None
    check_backend: str = "none"
    # channel composition
    topology: str = "ring"  # ring | full | geometric
    ring_k: int = 2
    # geometric: expected node degree of the random geometric graph on the
    # unit square (sets the radius: r = sqrt(deg / (π n)))
    geo_degree: float = 8.0
    fading: str = "markov"  # markov | corr_shadow | corr_uplink | static
    p_up_to_down: float = 0.3
    p_down_to_up: float = 0.5
    adj_every: int = 1
    drift: str = "piecewise"  # piecewise | static
    drift_hold: int = 1
    p_every: int = 1
    churn: str = "none"  # none | rotating
    n_cohorts: int = 5
    churn_hold: int = 4
    # per-round cohort sampling (the n ≫ 10³ regime): the active mask becomes
    # membership ∧ sampled, with the sampler wrapping the churn process as
    # its eligibility base.  fixed_k / expander use sample_k, uniform uses
    # sample_rate; sample_every throttles the redraw cadence.
    sampling: str = "none"  # none | uniform | fixed_k | expander
    sample_k: int = 0
    sample_rate: float = 0.5
    sample_every: int = 1
    # correlated shadowing (fading = corr_shadow | corr_uplink; the field
    # refreshes every adj_every rounds — the coherence time)
    corr_length: float = 0.4
    shadow_rho: float = 0.9
    shadow_sigma: float = 1.0
    blockage_threshold: float = 1.0
    uplink_gain: float = 2.0
    # execution path: FLSimulator and its engines ("sim") vs the mesh round
    # steps (build_round_step / build_scan_round_step /
    # build_fused_scan_round_step, "mesh") vs the multi-rank sharded step
    # (build_sharded_scan_round_step, "shard").  The mesh and shard steps
    # run one whole segment a call, so `chunk` applies to the sim path only.
    step: str = "sim"  # sim | mesh | shard
    # sharded execution (step = "shard"): the scan/pipelined engines run the
    # sharded round step over `devices` torch.distributed ranks (the bench
    # CLI starts them; the spec itself touches no process group).  `shard`
    # picks the split axis (clients | d), `exchange` the relay collective in
    # clients mode (gather = the dense order, bitwise; ring = O(1)-buffer
    # block ring at f32 tolerance).
    devices: int = 1
    shard: str = "clients"  # clients | d
    exchange: str = "gather"  # gather | ring
    # round engines: rounds staged (and traced) at a time
    chunk: int = 32
    # which engines the scenario benches by default (run.py --engines
    # overrides).  "async" adds the staleness-weighted AsyncRoundEngine.
    engines: tuple = ("loop", "scan", "pipelined")
    # async arrival model (engines includes "async"): per-client upload
    # delays drawn by repro_torch.channels.delay; the PS aggregates the
    # freshest buffer_k arrivals (0 = all) with staleness discount decay**s.
    # With delay="none" the async engine is bitwise-identical to the loop —
    # the harness enforces exactly that as the async parity gate whenever
    # the recorded run itself uses a nonzero delay.
    delay: str = "none"  # none | poisson | geometric
    delay_rate: float = 1.0
    delay_max: int = 8
    staleness_decay: float = 0.8
    buffer_k: int = 0
    # time-to-accuracy: when > 0, the report records the first round (and
    # wall-clock second) at which each engine's training loss reaches the
    # target
    ttac_target_loss: float = 0.0

    def __post_init__(self):
        # fail at construction, not mid-benchmark after batches are generated
        if self.step not in ("sim", "mesh", "shard"):
            raise ValueError(f"unknown step: {self.step!r}")
        if self.step == "mesh" and self.churn != "none":
            raise ValueError("mesh scenarios do not drive churn masks")
        if self.step == "mesh" and self.policy == "none":
            raise ValueError("the mesh round step needs a relay policy")
        if self.step == "mesh" and self.strategy != "colrel_fused":
            # _MeshStep benches build_round_step(relay_mode="fused") — the
            # mesh analogue of colrel_fused; any other strategy would be
            # recorded in the report but not what was measured
            raise ValueError("mesh scenarios bench the fused relay only")
        if self.step == "shard":
            if self.policy == "none":
                raise ValueError("the sharded round step needs a relay policy")
            if self.strategy != "colrel_fused":
                raise ValueError("shard scenarios bench the fused relay only")
            if self.devices < 2:
                raise ValueError("shard scenarios need devices >= 2")
            if self.shard not in ("clients", "d"):
                raise ValueError(f"unknown shard mode: {self.shard!r}")
            if self.exchange not in ("gather", "ring"):
                raise ValueError(f"unknown exchange: {self.exchange!r}")
            if self.shard == "clients" and self.n_clients % self.devices:
                raise ValueError(
                    f"n_clients={self.n_clients} must divide evenly over "
                    f"the {self.devices}-rank client axis"
                )
            # backend dispatch under sharding: ring/d refuse kernel backends
            validate_sharded_backend(
                self.relay_backend, shard=self.shard, exchange=self.exchange
            )
            if self.check_backend != "none":
                validate_sharded_backend(
                    self.check_backend, shard=self.shard, exchange=self.exchange
                )
        if self.fading == "corr_uplink" and self.drift != "static":
            raise ValueError("corr_uplink couples p to the fade; set drift='static'")
        if self.topology == "geometric" and self.geo_degree <= 0:
            raise ValueError("geometric topology needs geo_degree > 0")
        if self.sampling not in ("none", "uniform", "fixed_k", "expander"):
            raise ValueError(f"unknown sampling: {self.sampling!r}")
        if self.sampling in ("fixed_k", "expander") and self.sample_k < 1:
            raise ValueError(f"sampling={self.sampling!r} needs sample_k >= 1")
        if self.sampling == "uniform" and not (0.0 < self.sample_rate <= 1.0):
            raise ValueError("uniform sampling needs sample_rate in (0, 1]")
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if self.sampling != "none" and self.step != "sim":
            raise ValueError("cohort sampling drives churn masks: sim path only")
        # the segment backend consumes EdgeRelay operands — single-host sim
        # path only (the mesh/shard steps are dense), and the colrel
        # strategies need a policy that actually emits EdgeRelays
        for be, what in (
            (self.relay_backend, "relay_backend"),
            (self.check_backend, "check_backend"),
        ):
            if be == "segment" and self.step != "sim":
                raise ValueError(
                    f"{what}='segment' runs on the single-host sim path only"
                )
        if (
            self.relay_backend == "segment"
            and self.strategy in ("colrel", "colrel_fused")
            and self.policy != "sparse"
        ):
            raise ValueError(
                "relay_backend='segment' needs policy='sparse' (the other "
                "policies emit dense relay matrices, not EdgeRelays)"
            )
        unknown_engines = set(self.engines) - {"loop", "scan", "pipelined", "async"}
        if unknown_engines:
            raise ValueError(f"unknown engines: {sorted(unknown_engines)}")
        if self.delay not in ("none", "poisson", "geometric"):
            raise ValueError(f"unknown delay: {self.delay!r}")
        if self.delay != "none" and "async" not in self.engines:
            raise ValueError("a delay process only drives the async engine")
        if "async" in self.engines and self.strategy not in _ASYNC_STRATEGIES:
            raise ValueError(
                f"the async engine supports {_ASYNC_STRATEGIES}, "
                f"not {self.strategy!r}"
            )
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError("staleness_decay must be in (0, 1]")
        if self.buffer_k < 0 or self.delay_max < 0:
            raise ValueError("buffer_k and delay_max must be >= 0")
        if self.ttac_target_loss < 0:
            raise ValueError("ttac_target_loss must be >= 0 (0 = off)")
        if self.model not in ("mlp", "resnet20"):
            raise ValueError(f"unknown model: {self.model!r}")
        if self.relay_backend not in RELAY_BACKENDS:
            raise ValueError(
                f"unknown relay_backend: {self.relay_backend!r} "
                f"(known: {RELAY_BACKENDS})"
            )
        if self.check_backend not in ("none",) + RELAY_BACKENDS:
            raise ValueError(f"unknown check_backend: {self.check_backend!r}")
        if self.check_backend == self.relay_backend:
            raise ValueError(
                "check_backend must differ from relay_backend (the parity "
                "check compares the two)"
            )


def _make_mlp(dim: int, width: int, n_classes: int, device: torch.device):
    """Spec-sized MLP over flat features (leaves keyed ``inputs``/``labels``):
    ``relu(x@w1+b1)@w2+b2`` under the mean of logsumexp minus the gold logit.
    ``init(seed)`` draws on the CPU and moves the tensors to ``device``, so a
    seed gives the same parameters on the card and on the CPU."""

    def init(seed: int):
        gen = torch.Generator().manual_seed(seed)
        params = {
            "w1": torch.randn((dim, width), generator=gen) * dim**-0.5,
            "b1": torch.zeros((width,)),
            "w2": torch.randn((width, n_classes), generator=gen) * width**-0.5,
            "b2": torch.zeros((n_classes,)),
        }
        return {k: v.to(device) for k, v in params.items()}

    def loss(params, batch):
        x = batch["inputs"]
        h = torch.relu(x @ params["w1"] + params["b1"])
        lg = (h @ params["w2"] + params["b2"]).float()
        logz = torch.logsumexp(lg, dim=-1)
        # labels arrive as int32 numpy batches; gather wants int64
        gold = torch.gather(lg, 1, batch["labels"].long()[:, None])[:, 0]
        return torch.mean(logz - gold)

    return init, loss


def _make_resnet20(n_classes: int, device: torch.device):
    """The paper's §V model (``repro_torch.models.resnet``, GN variant) bound
    to its config; batches carry ``images``/``labels`` leaves (CIFAR-shaped,
    see ``data.synthetic.cifar_like``)."""

    def init(seed: int):
        return init_resnet20(seed, _RESNET20_CONFIG, num_classes=n_classes, device=device)

    def loss(params, batch):
        return resnet20_loss(params, _RESNET20_CONFIG, batch)

    return init, loss


@dataclasses.dataclass
class ScenarioBundle:
    """Factories the harness calls per engine run, all on ``device``."""

    spec: ScenarioSpec
    init_fn: object
    loss_fn: object
    device: torch.device
    # memoized base graph: every engine run builds a fresh schedule from the
    # same spec, and a 10⁴-node geometric graph is too expensive to resample
    # per run (the schedules copy it on construction, so sharing is safe)
    _adj: object = dataclasses.field(default=None, repr=False)

    def base_adjacency(self):
        if self._adj is None:
            spec = self.spec
            if spec.topology == "ring":
                self._adj = topology.ring(spec.n_clients, spec.ring_k)
            elif spec.topology == "full":
                self._adj = topology.fully_connected(spec.n_clients)
            elif spec.topology == "geometric":
                n = spec.n_clients
                radius = float(np.sqrt(spec.geo_degree / (np.pi * n)))
                self._adj = topology.random_geometric(n, radius, seed=spec.seed)
            else:
                raise ValueError(f"unknown topology: {spec.topology!r}")
        return self._adj

    def base_p(self):
        return connectivity.heterogeneous_profile(self.spec.n_clients).p

    def make_schedule(self) -> channels.ChannelSchedule:
        spec = self.spec
        adj = self.base_adjacency()
        p0 = self.base_p()
        seed = spec.seed + 7
        link = None
        p_process = None
        if spec.fading == "markov":
            link = channels.MarkovLinkProcess(
                adj,
                p_up_to_down=spec.p_up_to_down,
                p_down_to_up=spec.p_down_to_up,
                seed=seed,
            )
        elif spec.fading in ("corr_shadow", "corr_uplink"):
            # one latent field; the link process owns it, the coupled uplink
            # reads it — (adj, p) are jointly sampled per coherence interval
            field = channels.ShadowingField(
                channels.circle_positions(spec.n_clients),
                corr_length=spec.corr_length,
                rho=spec.shadow_rho,
                sigma=spec.shadow_sigma,
                seed=seed,
            )
            link = channels.ShadowedLinkProcess(
                adj, field, threshold=spec.blockage_threshold
            )
            if spec.fading == "corr_uplink":
                # drift='static' is enforced at spec construction
                p_process = channels.CoupledUplinkDrift(
                    p0, field, gain=spec.uplink_gain
                )
        elif spec.fading != "static":
            raise ValueError(f"unknown fading: {spec.fading!r}")
        if spec.drift == "piecewise":
            p_process = channels.PiecewiseConstantDrift(
                p0,
                hold=spec.drift_hold,
                low=0.1,
                high=0.9,
                seed=seed + 1,
            )
        elif spec.drift != "static":
            raise ValueError(f"unknown drift: {spec.drift!r}")
        kw = dict(adj_every=spec.adj_every, p_every=spec.p_every)
        if link is None:
            kw["adj"] = adj
        else:
            kw["link_process"] = link
        if p_process is None:
            kw["p"] = p0
        else:
            kw["p_process"] = p_process
        member = None
        if spec.churn == "rotating":
            member = channels.RotatingCohorts(
                spec.n_clients, n_cohorts=spec.n_cohorts, hold=spec.churn_hold
            )
        elif spec.churn != "none":
            raise ValueError(f"unknown churn: {spec.churn!r}")
        if spec.sampling != "none":
            # cohort sampling composes on top of churn: the sampler's base
            # is the membership process (active = membership ∧ sampled)
            member = channels.CohortSampler(
                spec.n_clients,
                strategy=spec.sampling,
                k=spec.sample_k if spec.sampling != "uniform" else None,
                rate=spec.sample_rate if spec.sampling == "uniform" else None,
                base=member,
                resample_every=spec.sample_every,
                seed=seed + 2,
            )
        if member is not None:
            return channels.ChurnSchedule(membership=member, **kw)
        if link is None and p_process is None:
            return channels.StaticChannel(adj, p0)
        return channels.TimeVaryingChannel(**kw)

    def make_policy(self, tracer=None):
        spec = self.spec
        if spec.policy == "adaptive":
            return channels.AdaptiveOptAlpha(
                sweeps=spec.opt_sweeps,
                warm_sweeps=spec.warm_sweeps,
                method=spec.opt_method,
                tracer=tracer,
            )
        if spec.policy == "sparse":
            return channels.SparseOptAlpha(
                sweeps=spec.opt_sweeps,
                warm_sweeps=spec.warm_sweeps,
                method=spec.opt_method,
                tracer=tracer,
            )
        if spec.policy == "stale":
            return channels.StaleOptAlpha(
                sweeps=spec.opt_sweeps, method=spec.opt_method
            )
        if spec.policy == "none":
            return None
        raise ValueError(f"unknown policy: {spec.policy!r}")

    def make_sim(self) -> FLSimulator:
        spec = self.spec
        return FLSimulator(
            self.loss_fn,
            n_clients=spec.n_clients,
            strategy=spec.strategy,
            p=self.base_p(),
            local_steps=spec.local_steps,
            client_opt=ClientOpt(kind="sgd", weight_decay=1e-4),
            server_opt=ServerOpt(),
            relay_backend=spec.relay_backend,
            device=self.device,
        )

    def make_delays(self):
        """Fresh delay process for one async-engine run (deterministic:
        every run replays the same arrival stream)."""
        spec = self.spec
        return channels.make_delays(
            spec.delay,
            spec.n_clients,
            rate=spec.delay_rate,
            max_delay=spec.delay_max,
            seed=spec.seed + 11,
        )

    def make_loader(self) -> FederatedLoader:
        spec = self.spec
        if spec.model == "resnet20":
            ds = cifar_like(
                spec.n_train,
                n_classes=spec.n_classes,
                snr=0.5,
                seed=spec.seed,
            )
        else:
            ds = gaussian_classification(
                spec.n_train,
                dim=spec.dim,
                n_classes=spec.n_classes,
                snr=0.5,
                seed=spec.seed,
            )
        parts = iid_partition(ds, spec.n_clients, seed=spec.seed)
        return FederatedLoader(ds, parts, seed=spec.seed)


def build(spec: ScenarioSpec, *, device=None) -> ScenarioBundle:
    """The spec's factory bundle on ``device`` (the GPU unless the caller
    passes ``device="cpu"``)."""
    device = resolve_device(device)
    if spec.model == "resnet20":
        init_fn, loss_fn = _make_resnet20(spec.n_classes, device)
    else:
        init_fn, loss_fn = _make_mlp(spec.dim, spec.width, spec.n_classes, device)
    return ScenarioBundle(spec, init_fn, loss_fn, device)


# ---------------------------------------------------------------- registry

_REGISTRY: dict[str, ScenarioSpec] = {}

# the JAX package's scenarios whose path the port does not have yet
NOT_YET_PORTED: dict[str, str] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"scenario already registered: {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r} (known: {known})") from None


def list_scenarios() -> list[ScenarioSpec]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


register(
    ScenarioSpec(
        name="bench_smoke",
        description="tiny CI gate: 64 rounds, n=6, 8-round channel coherence",
        n_clients=6,
        rounds=64,
        local_steps=2,
        local_batch=8,
        dim=32,
        width=16,
        n_train=256,
        adj_every=8,
        p_every=8,
        drift_hold=1,
        chunk=8,
    )
)

_FIG5_500 = register(
    ScenarioSpec(
        name="fig5_500",
        description=(
            "acceptance scenario: Fig. 5 channel (ring(10,2), Markov "
            "fading + p-drift) at a 500-round horizon, 25-round "
            "coherence time"
        ),
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        adj_every=25,
        p_every=25,
        drift_hold=1,
        chunk=25,
    )
)

# chunk-size vs coherence-time sweep around fig5_500's matched chunk=25.  The
# descriptions are the JAX package's, whose compiled scan pads a 25-round
# epoch to 125 rounds; the port runs each chunk at its real length.
for _chunk in (5, 125):
    register(
        dataclasses.replace(
            _FIG5_500,
            name=f"fig5_chunk{_chunk}",
            description=(
                f"chunk sweep: the fig5_500 channel (25-round coherence) "
                f"run at chunk={_chunk} "
                f"({'dispatch-bound' if _chunk < 25 else 'padding-bound'})"
            ),
            chunk=_chunk,
        )
    )

register(
    ScenarioSpec(
        name="fig6_500",
        description="fig5_500 plus rotating-cohort churn (Fig. 6 setting)",
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        adj_every=25,
        p_every=25,
        drift_hold=1,
        chunk=25,
        churn="rotating",
        n_cohorts=5,
        churn_hold=25,
    )
)

register(
    ScenarioSpec(
        name="static_500",
        description="single-epoch control: static channel, maximal fusion",
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        fading="static",
        drift="static",
        chunk=50,
    )
)

register(
    ScenarioSpec(
        name="corr_shadow_500",
        description=(
            "correlated shadowing: GP blockage field over ring positions "
            "(edges sharing a blocked node fail together), static p, "
            "25-round coherence"
        ),
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        fading="corr_shadow",
        drift="static",
        adj_every=25,
        p_every=25,
        chunk=25,
    )
)

register(
    ScenarioSpec(
        name="corr_uplink_500",
        description=(
            "coupled uplink/D2D fading: (adj, p) jointly sampled from one "
            "shadowing field, 25-round coherence"
        ),
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        fading="corr_uplink",
        drift="static",
        adj_every=25,
        p_every=25,
        chunk=25,
    )
)

# ---------------------------------------------------------------- real model

register(
    ScenarioSpec(
        name="resnet20_cifar",
        description=(
            "the paper's §V model: ResNet-20 (GN) on CIFAR-shaped synthetic "
            "batches, paper-faithful relay, pallas mix-kernel parity check"
        ),
        n_clients=4,
        rounds=24,
        local_steps=1,
        local_batch=2,
        strategy="colrel",
        model="resnet20",
        n_train=256,
        adj_every=8,
        p_every=8,
        drift_hold=1,
        chunk=8,
        lr=0.05,
        check_backend="hopper",
    )
)

# ------------------------------------------------------------- relay D-sweep
# The relay/aggregate hot spot over model size: identical channel/engine
# setting, D swept 10⁴ → 10⁷ (the MLP is sized so total params ≈ the target
# D).  Engines run the einsum reference (bitwise gate); the mandatory kernel
# check re-runs the scan engine on hopper_fused and asserts allclose.

_RELAY_SWEEP = {
    # name suffix -> (dim, width, rounds, block_d); D = dim·w + w + 10·w + 10
    "1e4": (96, 96, 64, None),  # D ≈ 1.03e4
    "1e5": (256, 384, 32, 16384),  # D ≈ 1.03e5
    "1e6": (1024, 960, 16, 131072),  # D ≈ 9.9e5
    "1e7": (3072, 3248, 8, 1048576),  # D ≈ 1.00e7
}

for _suffix, (_dim, _width, _rounds, _block) in _RELAY_SWEEP.items():
    register(
        ScenarioSpec(
            name=f"relay_sweep_{_suffix}",
            description=(
                f"relay hot-spot sweep @ D≈{_suffix}: fused aggregation "
                "over the raveled buffer, static channel, pallas_fused "
                "parity check"
            ),
            n_clients=8,
            rounds=_rounds,
            local_steps=1,
            local_batch=4,
            dim=_dim,
            width=_width,
            n_train=512,
            fading="static",
            drift="static",
            chunk=_rounds,
            block_d=_block,
            check_backend="hopper_fused",
        )
    )

register(
    ScenarioSpec(
        name="relay_sweep_smoke",
        description=(
            "CI-sized D-sweep point (D≈1e4, 8 rounds): exercises the "
            "pallas_fused kernel check end-to-end in seconds"
        ),
        n_clients=8,
        rounds=8,
        local_steps=1,
        local_batch=4,
        dim=96,
        width=96,
        n_train=512,
        fading="static",
        drift="static",
        chunk=8,
        check_backend="hopper_fused",
    )
)

# ------------------------------------------------------------ client n-sweep
# The cohort-sampling scale regime: the padded client dimension grows
# 10³ → 10⁴ while the per-round cohort stays fixed at k=128, the graph stays
# sparse (geometric, expected degree 8) and the relay operand stays O(edges)
# (EdgeRelay + segment backend, policy="sparse").  Every round redraws the
# cohort, so each round is its own channel epoch — the measured regime is
# warm-started sparse re-solves plus segment-sum aggregation.  The n1e3
# point carries the mandatory einsum parity check (the dense reference
# densifies the same EdgeRelays); at n1e4 the dense check matrix would be
# 10⁸ entries, so that point relies on the loop/scan/pipelined bitwise gate.
# The segment backend's dense (n,) reduce runs the fused-aggregate kernel
# (kernels/ops.py).

_SAMPLE_SWEEP = {
    # name suffix -> (n_clients, n_train, rounds, check_backend)
    "n1e3": (1_000, 4_000, 16, "einsum"),
    "n1e4": (10_000, 20_000, 16, "none"),
}

for _suffix, (_n, _train, _rounds, _check) in _SAMPLE_SWEEP.items():
    register(
        ScenarioSpec(
            name=f"sample_sweep_{_suffix}",
            description=(
                f"client n-sweep @ n={_n}: fixed-k cohorts (k=128) on a "
                "sparse geometric graph, sparse OPT-α + segment aggregation"
            ),
            n_clients=_n,
            rounds=_rounds,
            local_steps=1,
            local_batch=2,
            dim=32,
            width=16,
            n_train=_train,
            policy="sparse",
            opt_method="bisect",
            relay_backend="segment",
            check_backend=_check,
            topology="geometric",
            geo_degree=8.0,
            fading="static",
            drift="static",
            sampling="fixed_k",
            sample_k=128,
            chunk=1,
        )
    )

register(
    ScenarioSpec(
        name="sample_sweep_smoke",
        description=(
            "CI-sized cohort-sampling point (n=256, k=32): sparse OPT-α, "
            "segment aggregation and the einsum parity check in seconds"
        ),
        n_clients=256,
        rounds=10,
        local_steps=1,
        local_batch=2,
        dim=32,
        width=16,
        n_train=512,
        policy="sparse",
        opt_method="bisect",
        relay_backend="segment",
        check_backend="einsum",
        topology="geometric",
        geo_degree=8.0,
        fading="static",
        drift="static",
        sampling="fixed_k",
        sample_k=32,
        chunk=1,
    )
)

# ------------------------------------------------------------ multi-rank mesh
# The mesh8_* / mesh2_* scenarios run over `devices` torch.distributed ranks:
# `python -m repro_torch.bench.run` starts them (gloo with --device cpu,
# NCCL on GPUs, one card a rank).  Registration is pure data — the rank
# count is checked when the mesh is made, never at import.  The shard gate
# replaces the bitwise gate: the sharded engines must agree bitwise *among
# themselves* and match the one-rank loop within the kernel-check tolerance
# (report.shard_check).

register(
    ScenarioSpec(
        name="mesh8_smoke",
        description=(
            "8-device CI gate: client-sharded fused scan over a host mesh, "
            "gather exchange, pallas_fused parity check"
        ),
        n_clients=8,
        rounds=32,
        local_steps=2,
        local_batch=4,
        dim=32,
        width=16,
        n_train=256,
        adj_every=8,
        p_every=8,
        drift_hold=1,
        step="shard",
        devices=8,
        check_backend="hopper_fused",
    )
)

register(
    ScenarioSpec(
        name="mesh8_ring_churn",
        description=(
            "sharded acceptance: block-ring ppermute exchange under "
            "rotating-cohort churn + correlated shadowing, 8 devices"
        ),
        n_clients=8,
        rounds=64,
        local_steps=2,
        local_batch=4,
        dim=32,
        width=16,
        n_train=256,
        fading="corr_shadow",
        drift="static",
        adj_every=8,
        p_every=8,
        churn="rotating",
        n_cohorts=4,
        churn_hold=8,
        step="shard",
        devices=8,
        exchange="ring",
    )
)

register(
    ScenarioSpec(
        name="mesh2_dshard",
        description=(
            "D-axis GSPMD mode: the (n, D) relay contraction partitioned "
            "over a 2-device model axis, static channel"
        ),
        n_clients=8,
        rounds=32,
        local_steps=2,
        local_batch=4,
        dim=32,
        width=16,
        n_train=256,
        fading="static",
        drift="static",
        step="shard",
        devices=2,
        shard="d",
    )
)

register(
    ScenarioSpec(
        name="mesh_corr_500",
        description=(
            "production mesh round step (fused relay) under the coupled "
            "correlated channel: per-round build_round_step vs one "
            "build_scan_round_step dispatch per epoch"
        ),
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        fading="corr_uplink",
        drift="static",
        adj_every=25,
        p_every=25,
        chunk=25,
        step="mesh",
    )
)

# ------------------------------------------------------------ async arrivals
# The staleness-weighted asynchronous engine (repro_torch.fl.async_engine) under
# sampled per-client upload delays.  The recorded quantity is
# time-to-accuracy: rounds and wall-clock seconds to the target training
# loss, async vs the synchronous engines.  Because a delayed run is *meant*
# to diverge from the loop, the loop/scan/pipelined bitwise gate cannot
# cover the async engine; instead the harness re-runs it with the delay
# stripped (delay="none") and asserts bitwise equality with the loop — the
# OPT-α-unbiasedness regression gate for the staleness-weighting math
# (report.async_check; both gates are mandatory and raise on mismatch).

register(
    ScenarioSpec(
        name="async_ttac_500",
        description=(
            "time-to-accuracy under Poisson(1.0) arrival delays: the "
            "staleness-weighted async engine vs the synchronous loop / "
            "pipelined engines on the fig5 channel, delay-0 parity gate on"
        ),
        n_clients=10,
        rounds=500,
        local_steps=2,
        local_batch=8,
        dim=64,
        width=32,
        n_train=1024,
        adj_every=25,
        p_every=25,
        drift_hold=1,
        chunk=25,
        engines=("loop", "pipelined", "async"),
        delay="poisson",
        delay_rate=1.0,
        delay_max=8,
        staleness_decay=0.8,
        ttac_target_loss=0.05,
    )
)

register(
    ScenarioSpec(
        name="async_smoke",
        description=(
            "CI-sized async point: geometric delays, freshest-4 buffer, "
            "staleness weighting and the delay-0 parity gate in seconds"
        ),
        n_clients=6,
        rounds=24,
        local_steps=2,
        local_batch=8,
        dim=32,
        width=16,
        n_train=256,
        adj_every=8,
        p_every=8,
        drift_hold=1,
        chunk=8,
        engines=("loop", "async"),
        delay="geometric",
        delay_rate=1.0,
        delay_max=4,
        staleness_decay=0.8,
        buffer_k=4,
        ttac_target_loss=1.8,
    )
)
