"""One run of one cell: set-up, the measured window, the traced windows,
the check against the reference, and the result's line.

The entry the window drives is the port's
``PipelinedScanEngine.run_schedule`` over an ``FLSimulator``
(``colrel_fused`` on the ``hopper_fused`` backend), fed by
``FederatedLoader.round_batch`` and one continuing channel schedule and
relay policy, called in blocks of ``block_rounds`` rounds (whole channel
epochs where the channel varies), each ending in a synchronize, until the
window's seconds have passed.  Nothing is evaluated in the window.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import check, generator, inputs, timing
from portbench.reference import fl as ref_fl

BLOCKED_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration, its traffic mix), each
    found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r} (known: {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def repeatable_f32() -> None:
    """The configuration's precision, as the port's figure entry sets it:
    full f32 (TF32 off for matmuls and cuDNN) and deterministic cuDNN."""
    b = torch.backends
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False


@dataclasses.dataclass
class Cell:
    """The port's objects of one run and the inputs both sides share."""

    cfg: dict
    traffic: dict
    seeds: dict
    device: torch.device
    ds: inputs.Dataset
    parts: list
    x0: dict  # the benchmark's initial weights, flat (leaf name → tensor)
    sim: object
    engine: object
    schedule: object
    policy: object
    loader: object
    generator: torch.Generator
    lm: bool = False  # the data kind's rows are token sequences
    params: object = None
    server_state: object = None

    def next_batch(self):
        return self.loader.round_batch(self.cfg["local_steps"], self.cfg["local_batch"],
                                       lm=self.lm)

    def run(self, rounds: int, *, next_batch=None, policy=None):
        """One call of the engine over the next ``rounds`` rounds, ended by a
        synchronize; returns the rounds' losses (a device tensor)."""
        self.params, self.server_state, metrics, self.generator = self.engine.run_schedule(
            self.generator, self.params, self.server_state, schedule=self.schedule,
            rounds=rounds, next_batch=next_batch or self.next_batch, lr=self.cfg["lr"],
            policy=policy or self.policy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return metrics["loss"]


def model_module(cfg: dict):
    return importlib.import_module(f"portbench.models.{cfg['model']}")


def build(cfg: dict, traffic: dict, seed: int, device) -> Cell:
    """Inputs from the seed, handed to the port's simulator, loader, channel
    and engine."""
    from repro_torch.core.aggregation import ServerOpt
    from repro_torch.data.loader import FederatedLoader
    from repro_torch.fl.simulator import FLSimulator
    from repro_torch.optim.sgd import ClientOpt

    device = torch.device(device)
    seeds = inputs.sub_seeds(seed)
    n = cfg["n_clients"]
    ds, parts = inputs.make_data(cfg["data"], n, seeds)
    model = model_module(cfg)
    x0 = model.init_params(cfg, seeds["params"], device)
    n_params = sum(v.numel() for v in x0.values())
    if n_params != cfg["num_params"]:
        raise ValueError(f"{cfg['model']}: {n_params} parameters, the configuration "
                         f"states {cfg['num_params']}")
    sim = FLSimulator(
        model.program_loss(cfg), n_clients=n, strategy=cfg["strategy"], p=None,
        local_steps=cfg["local_steps"],
        client_opt=ClientOpt(kind="sgd", weight_decay=cfg["weight_decay"]),
        server_opt=ServerOpt(lr=cfg["server_lr"]), relay_backend=cfg["relay_backend"],
        device=device)
    schedule, policy = generator.program_channel(traffic, n, seeds)
    cell = Cell(cfg=cfg, traffic=traffic, seeds=seeds, device=device, ds=ds, parts=parts,
                x0=x0, sim=sim, engine=generator.program_engine(traffic, sim),
                schedule=schedule, policy=policy,
                loader=FederatedLoader(ds, parts, seed=seeds["loader"]),
                generator=torch.Generator(device=device).manual_seed(seeds["tau"]),
                lm=inputs.data_kind(cfg["data"]).LM)
    cell.params = ref_fl.unflatten({k: v.clone() for k, v in x0.items()})
    cell.server_state = sim.init_server_state(cell.params)
    return cell


def update_norms(cell: Cell) -> dict[str, float]:
    """Each leaf's ‖x − x0‖ of the port's weights as they stand."""
    return check.norms(ref_fl.flatten(cell.params), cell.x0)


@dataclasses.dataclass
class CheckRecord:
    """What the port's first K rounds produced: each round's loss, and each
    leaf's norm of x1 − x0 (the first update) and of xK − x0 (the change),
    taken as soon as the weights are made, so no copy of them is held."""

    losses: list
    first: dict
    change: dict


def check_rounds(cell: Cell) -> CheckRecord:
    """Set-up's calls of the window's own entry, on the window's feed; the
    reference follows them.  They also load the kernels, warm the chunk
    shapes up and capture the full chunk."""
    losses, first = [], None
    for rounds in cell.traffic["check_calls"]:
        losses.extend(float(v) for v in cell.run(rounds))
        if first is None:
            first = update_norms(cell)
    return CheckRecord(losses, first, update_norms(cell))


@dataclasses.dataclass
class Window:
    rounds: int = 0
    seconds: float = 0.0
    losses: list = dataclasses.field(default_factory=list)
    prep_s: float = 0.0
    wait_s: float = 0.0


def window(cell: Cell, seconds: float, *, next_batch=None, policy=None,
           annotate: bool = False) -> Window:
    """Blocks of ``block_rounds`` rounds until ``seconds`` have passed, from
    the first call to the last block's synchronize."""
    block = cell.traffic["block_rounds"]
    w = Window()
    t0 = time.perf_counter()
    while True:
        if annotate:
            with torch.profiler.record_function("portbench.block"):
                w.losses.append(cell.run(block, next_batch=next_batch, policy=policy))
        else:
            w.losses.append(cell.run(block, next_batch=next_batch, policy=policy))
        stats = cell.engine.prefetch_stats
        w.prep_s += stats.prep_s
        w.wait_s += stats.wait_s
        w.rounds += block
        w.seconds = time.perf_counter() - t0
        if w.seconds >= seconds:
            return w


def nonfinite_rounds(w: Window) -> int:
    return int((~torch.isfinite(torch.cat(w.losses))).sum()) if w.losses else 0


class _AnnotatedPolicy:
    """The cell's policy with each ``relay_matrix`` call marked in the
    profile (the same object underneath, so its cache and warm starts)."""

    def __init__(self, policy):
        self.policy = policy

    def relay_matrix(self, state):
        with torch.profiler.record_function("portbench.relay_matrix"):
            return self.policy.relay_matrix(state)


@dataclasses.dataclass
class TraceContext:
    """Everything a per-layer reader (``metrics/<name>.py``) may read: the
    cell's configuration and traffic, the three windows of a traced run,
    the port's spans and counters (span window), and the device's busy
    seconds and its operations (profiled window)."""

    cfg: dict
    traffic: dict
    flops_per_round: float
    span_window: Window
    spans: list  # the port's tracer spans in the span window
    counters: dict  # the port's tracer counters in the span window
    untraced_window: Window | None = None
    profile_window: Window | None = None
    busy_s: float | None = None
    # the profiled window's device operations: name → [seconds, launches]
    device_ops: dict = dataclasses.field(default_factory=dict)

    def span_seconds(self, name: str) -> float:
        return sum(s.dur_ns for s in self.spans if s.name == name) / 1e9

    def has_span(self, name: str) -> bool:
        return any(s.name == name for s in self.spans)


def flops_per_round(cfg: dict) -> float:
    """Model FLOPs of one round: forward × 3 for training, every client's
    T·b samples; the aggregation is not counted."""
    samples = cfg["n_clients"] * cfg["local_steps"] * cfg["local_batch"]
    return 3.0 * model_module(cfg).forward_flops_per_sample(cfg) * samples


def span_window(cell: Cell, seconds: float):
    """Blocks under the port's tracer (device spans from CUDA events; a
    traced pipelined engine keeps at most two chunks queued, so it is read
    only here): the window, and the spans and counters it recorded."""
    from repro_torch.obs import NULL_TRACER, Tracer

    tracer = Tracer()
    holders = [x for x in (cell.engine, cell.policy, cell.schedule) if hasattr(x, "tracer")]
    for x in holders:
        x.tracer = tracer
    try:
        w = window(cell, seconds)
    finally:
        for x in holders:
            x.tracer = NULL_TRACER
    return w, tracer.spans, dict(tracer.counters)


def profile_window(cell: Cell, seconds: float):
    """Untraced blocks under ``torch.profiler``: the window, the device's
    busy seconds in it, its operations (name → [seconds, launches]), and the
    breakdown."""
    from torch.profiler import ProfilerActivity, profile

    def next_batch():
        with torch.profiler.record_function("portbench.next_batch"):
            return cell.next_batch()

    activities = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        w = window(cell, seconds, next_batch=next_batch,
                   policy=_AnnotatedPolicy(cell.policy), annotate=True)
    events = prof.events()
    blocks = [e for e in events if e.name == "portbench.block"
              and e.device_type == torch.autograd.DeviceType.CPU]
    lo, hi = min(b.time_range.start for b in blocks), max(b.time_range.end for b in blocks)
    # the device's own activities: kernels, copies, sets (a range marked by
    # record_function also appears on the device's timeline; it is no work)
    work = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("portbench.")]
    dev = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in work
                 if e.time_range.end > lo and e.time_range.start < hi)
    busy_s = timing.device_busy_s(dev)
    by_name: dict = {}
    for e in work:
        op = by_name.setdefault(e.name, [0.0, 0])
        op[0] += (e.time_range.end - e.time_range.start) / 1e6
        op[1] += 1
    breakdown = None
    if dev:
        main = blocks[0].thread
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.thread == main and e.name != "portbench.block"]
        top = sorted(by_name.items(), key=lambda x: -x[1][0])[:10]
        breakdown = {"device_ops": [[name[:120], op[0]] for name, op in top],
                     "idle_gaps": _idle_gaps(dev, lo, hi, host)}
    return w, busy_s, by_name, breakdown


def _idle_gaps(dev, lo: float, hi: float, host) -> list:
    """The ten longest stretches of the window in which no device activity
    ran, each named by what the thread that drives the engine was doing:
    the shortest of its profiled operations that covers at least half of
    the gap, else ``engine.python`` (the engine's own Python, waiting on
    the staging queue among it)."""
    gaps, end = [], lo
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        best, best_dur = "engine.python", None
        for e in host:
            a, b = e.time_range.start, e.time_range.end
            if min(b, g1) - max(a, g0) >= 0.5 * (g1 - g0) and (best_dur is None
                                                              or b - a < best_dur):
                best, best_dur = e.name, b - a
        out.append([best[:120], (g1 - g0) / 1e6])
    return out


def reference_rounds(cell_cfg: dict, traffic: dict, seeds: dict, ds, parts, x0: dict,
                     device, *, mode: str = "f32", fault: str | None = None):
    """The reference's K rounds: (losses, the norms of x1 − x0, the norms of
    xK − x0), each leaf's (:func:`check.norms`)."""
    k = sum(traffic["check_calls"])
    n, T, b = cell_cfg["n_clients"], cell_cfg["local_steps"], cell_cfg["local_batch"]
    states, matrices = generator.reference_channel(traffic, n, seeds, k)
    lm = inputs.data_kind(cell_cfg["data"]).LM
    with ref_fl.precision(mode):
        return ref_fl.run_rounds(
            cell_cfg["model"], x0,
            ref_fl.batch_stream(ds, parts, seeds["loader"], k, T, b, lm=lm),
            ref_fl.taus(seeds["tau"], [p for _, p, _ in states], device), matrices,
            [active for _, _, active in states], lr=cell_cfg["lr"],
            wd=cell_cfg["weight_decay"], device=device, fault=fault,
            keep=lambda x: check.norms(x, x0))


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": _power_limit()}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def blocked_modules(modules) -> list[str]:
    return sorted(m for m in modules if m.split(".")[0] in BLOCKED_MODULES)


def run_cell(cell_spec: dict, cfg: dict, traffic: dict, limits: dict, *, seed: int,
             seconds: float, trace: bool, device, t_start: float, bench: dict) -> dict:
    """One run: the result's line as a dict (``check`` last)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        repeatable_f32()
    t_build = time.perf_counter()
    cell = build(cfg, traffic, seed, device)
    t_check = time.perf_counter()
    record = check_rounds(cell)
    t_end = time.perf_counter()
    print(f"setup: to build {t_build - t_start:.3f} s, inputs and objects "
          f"{t_check - t_build:.3f} s, check rounds {t_end - t_check:.3f} s",
          file=sys.stderr, flush=True)
    result: dict = {}
    if not trace:
        setup_s = time.perf_counter() - t_start
        w = window(cell, seconds)
        metrics = {"rounds_per_s": {"value": w.rounds / w.seconds, "unit": "rounds/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        if cuda and _reports(bench, "peak_mem_gib", cell_spec["name"]):
            metrics["peak_mem_gib"] = {
                "value": torch.cuda.max_memory_allocated(device) / 2**30, "unit": "GiB"}
        attempted, failed = w.rounds, nonfinite_rounds(w)
        dev = device_info(device)
    else:
        # a third of the seconds each: under the port's tracer, untraced,
        # profiled
        sw, spans, counters = span_window(cell, seconds / 3)
        uw = window(cell, seconds / 3)
        pw, busy_s, device_ops, breakdown = profile_window(cell, seconds / 3)
        attempted = sw.rounds + uw.rounds + pw.rounds
        failed = nonfinite_rounds(sw) + nonfinite_rounds(uw) + nonfinite_rounds(pw)
        dev = device_info(device)
        ctx = TraceContext(cfg=cfg, traffic=traffic, flops_per_round=flops_per_round(cfg),
                           span_window=sw, spans=spans, counters=counters,
                           untraced_window=uw, profile_window=pw,
                           busy_s=busy_s if cuda else None, device_ops=device_ops)
        metrics = per_layer(bench, cell_spec["name"], ctx)
        dev.update(busy_s=busy_s, window_s=pw.seconds)
        if breakdown is not None:
            result["breakdown"] = breakdown
    shared = dict(seeds=cell.seeds, ds=cell.ds, parts=cell.parts, x0=cell.x0)
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_rounds(cfg, traffic, shared["seeds"], shared["ds"], shared["parts"],
                           shared["x0"], device)
    numbers = check.compare(record.losses, record.first, record.change, *ref)
    correct = check.verdict(numbers, limits) and failed == 0
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev, **result}
    # a number that is not finite is written as the largest float (JSON has
    # no infinity)
    out["check"] = {name: {"value": min(numbers[name], sys.float_info.max),
                           "limit": limits[name]} for name in limits}
    out["check"]["nonfinite_rounds"] = {"value": failed, "limit": 0}
    return out


def _reports(bench: dict, metric: str, workload: str) -> bool:
    """Whether the cell reports an end-to-end metric (one without a
    ``workloads`` list is reported everywhere)."""
    m = {m["name"]: m for m in bench["end_to_end"]}.get(metric)
    return m is not None and workload in m.get("workloads", [workload])


def per_layer(bench: dict, workload: str, ctx: TraceContext) -> dict:
    """The cell's per-layer metrics, each from its reader
    (``metrics/<name>.py``); a reader that finds nothing returns None and
    its metric is left out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
