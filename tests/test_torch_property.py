"""Hypothesis property tests for the ColRel invariants, on the port: the
counterpart of ``tests/test_property.py``, one test for each of its 14.

Each test draws the reference's settings and checks the reference's
invariants on the port.  Where the port's code is host numpy (topology,
OPT-α, the staleness discounts) it also asserts equality with the JAX
package on the same draw; where it is torch, agreement within f32 rounding
(and bit equality of the raveled buffers).  The zero-mass test runs
``einsum`` and ``segment`` on the CPU, and the CUDA kernels' backends
(``hopper``, ``hopper_fused``) under the ``cuda`` marker on the card.

The JAX package is imported inside the tests that compare with it, so the
file also runs where JAX is missing (the card), where those tests skip and
the card's cases run: ``python -m pytest tests/test_torch_property.py -m cuda``.
"""
import types

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import aggregation, opt_alpha, relay, topology  # noqa: E402
from repro_torch.fl import async_engine  # noqa: E402
from repro_torch.utils import (  # noqa: E402
    stacked_ravel,
    tree_dot,
    tree_flatten,
    tree_map,
    tree_norm,
    tree_ravel,
    tree_unravel,
)

MAX_N = 12


def _reference():
    """The JAX package's modules, or a skip where JAX is missing."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import utils
    from repro.core import aggregation as agg, opt_alpha as oa, relay as rl, topology as top
    from repro.fl import async_engine as ae

    return types.SimpleNamespace(jax=jax, jnp=jnp, utils=utils, aggregation=agg,
                                 opt_alpha=oa, relay=rl, topology=top, async_engine=ae)


def _draw_topology(draw, n):
    """A graph as the reference's settings draw it, and its recipe (the
    topology function's name and arguments) so the reference can make it
    too."""
    kind = draw(st.sampled_from(["ring", "fct", "er", "clusters"]))
    if kind == "ring":
        recipe = ("ring", (n, draw(st.integers(1, max(1, n // 2 - 1)))), {})
    elif kind == "fct":
        recipe = ("fully_connected", (n,), {})
    elif kind == "er":
        recipe = ("erdos_renyi", (n, draw(st.floats(0.1, 0.9))),
                  {"seed": draw(st.integers(0, 100))})
    else:
        recipe = ("clusters", (n, draw(st.integers(1, 3))), {})
    name, args, kw = recipe
    return getattr(topology, name)(*args, **kw), recipe


@st.composite
def fl_setting(draw):
    n = draw(st.integers(3, MAX_N))
    p = np.asarray(draw(st.lists(st.floats(0.05, 1.0), min_size=n, max_size=n)))
    adj, recipe = _draw_topology(draw, n)
    return p, adj, recipe


@st.composite
def masked_setting(draw):
    """Random (p, adj, active) draw: a channel plus a churn mask with at
    least one live client."""
    n = draw(st.integers(3, MAX_N))
    p = np.asarray(draw(st.lists(st.floats(0.05, 0.95), min_size=n, max_size=n)))
    adj, _ = _draw_topology(draw, n)
    active = np.asarray(draw(st.lists(st.booleans(), min_size=n, max_size=n)))
    if not active.any():
        active[draw(st.integers(0, n - 1))] = True
    return p, adj, active


@given(fl_setting())
@settings(max_examples=30, deadline=None)
def test_opt_alpha_invariants(setting):
    p, adj, (name, args, kw) = setting
    ref = _reference()
    assert np.array_equal(adj, getattr(ref.topology, name)(*args, **kw))
    res = opt_alpha.optimize(p, adj, sweeps=25)
    want = ref.opt_alpha.optimize(p, adj, sweeps=25)
    assert np.array_equal(res.A, want.A) and np.array_equal(res.S_history, want.S_history)
    assert np.array_equal(res.feasible_columns, want.feasible_columns)
    # unbiasedness on feasible columns (Lemma 1)
    resid = opt_alpha.unbiasedness_residual(p, res.A)
    assert np.abs(resid[res.feasible_columns]).max() < 1e-7
    # nonnegativity and support
    assert (res.A >= -1e-10).all()
    assert relay.neighbor_support(res.A, adj)
    # Gauss-Seidel never increases the objective
    assert np.all(np.diff(res.S_history) <= 1e-7 * max(1.0, res.S_history[0]))


@given(fl_setting())
@settings(max_examples=20, deadline=None)
def test_optimized_no_worse_than_init(setting):
    p, adj, _ = setting
    ref = _reference()
    A0 = opt_alpha.initial_weights(p, adj)
    assert np.array_equal(A0, ref.opt_alpha.initial_weights(p, adj))
    res = opt_alpha.optimize(p, adj, sweeps=25)
    s0 = opt_alpha.variance_proxy(p, A0)
    assert s0 == ref.opt_alpha.variance_proxy(p, A0)
    assert opt_alpha.variance_proxy(p, res.A) <= s0 + 1e-7 * max(1.0, s0)


@given(fl_setting())
@settings(max_examples=15, deadline=None)
def test_S_convexity_along_segments(setting):
    """S(p, ·) is convex (paper §IV): check along random feasible segments."""
    p, adj, _ = setting
    ref = _reference()
    A0 = opt_alpha.initial_weights(p, adj)
    A1 = opt_alpha.optimize(p, adj, sweeps=5).A
    for lam in (0.25, 0.5, 0.75):
        mid = lam * A0 + (1 - lam) * A1
        s_mid = opt_alpha.variance_proxy(p, mid)
        assert s_mid == ref.opt_alpha.variance_proxy(p, mid)
        bound = (lam * opt_alpha.variance_proxy(p, A0)
                 + (1 - lam) * opt_alpha.variance_proxy(p, A1))
        assert s_mid <= bound + 1e-8 * max(1.0, bound)


@given(masked_setting())
@settings(max_examples=25, deadline=None)
def test_exact_solver_agrees_with_bisection_on_masked_draws(setting):
    """The closed-form piecewise-linear λ solve vs the paper's bisection on
    random (p, adj, active) draws: identical column solutions on identical
    input, and the same reached optimum S, to 1e-8; each equal to the
    reference's."""
    p, adj, active = setting
    ref = _reference()
    adj_m = adj & active[:, None] & active[None, :]
    p_eff = np.where(active, p, 0.0)
    m = topology.closed_mask(adj_m) & active[:, None] & active[None, :]
    A0 = opt_alpha.initial_weights(p_eff, adj_m)
    for i in np.nonzero(active)[0]:
        beta = A0.sum(axis=1) - A0[:, i]
        col_b, ok_b, _ = opt_alpha.solve_column(p_eff, m[:, i], beta, method="bisect")
        col_x, ok_x, _ = opt_alpha.solve_column(p_eff, m[:, i], beta, method="exact")
        assert ok_b == ok_x
        assert np.max(np.abs(col_b - col_x)) < 1e-8
        want_x, want_ok, _ = ref.opt_alpha.solve_column(p_eff, m[:, i], beta, method="exact")
        assert ok_x == want_ok and np.array_equal(col_x, want_x)
    rb = opt_alpha.optimize_masked(p, adj, active, sweeps=25, method="bisect")
    rx = opt_alpha.optimize_masked(p, adj, active, sweeps=25, method="exact")
    assert np.array_equal(
        rx.A, ref.opt_alpha.optimize_masked(p, adj, active, sweeps=25, method="exact").A)
    S_b = opt_alpha.variance_proxy(p_eff, rb.A)
    S_x = opt_alpha.variance_proxy(p_eff, rx.A)
    assert abs(S_b - S_x) <= 1e-8 * max(1.0, S_b)


@given(masked_setting())
@settings(max_examples=25, deadline=None)
def test_masked_relay_weights_unbiased_and_on_support(setting):
    """Under a random churn mask the masked OPT-α weights keep every ColRel
    invariant: nonnegative, exactly zero on departed rows/columns, supported
    on the live closed neighbourhoods, and unbiased in expectation over the
    live set (Lemma 1); equal to the reference's."""
    p, adj, active = setting
    res = opt_alpha.optimize_masked(p, adj, active, sweeps=25)
    A = res.A
    assert np.array_equal(A, _reference().opt_alpha.optimize_masked(p, adj, active,
                                                                      sweeps=25).A)
    assert (A >= -1e-10).all()
    assert np.all(A[~active, :] == 0.0)
    assert np.all(A[:, ~active] == 0.0)
    adj_m = adj & active[:, None] & active[None, :]
    assert relay.neighbor_support(A, adj_m)
    p_eff = np.where(active, p, 0.0)
    cols = active & res.feasible_columns
    if cols.any():
        np.testing.assert_allclose((p_eff @ A)[cols], 1.0, atol=1e-7)


@given(st.integers(3, 10), st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_relay_preserves_total_mass_expectation(n, seed):
    """p @ A = 1 ⇒ Σ_o E[coeff_o] = n·w = 1 for w = 1/n; the port's fused
    coefficients at τ = p carry that mass."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.1, 1.0, n)
    adj = topology.ring(n, 1)
    res = opt_alpha.optimize(p, adj, sweeps=15)
    assert np.array_equal(res.A, _reference().opt_alpha.optimize(p, adj, sweeps=15).A)
    if not res.feasible_columns.all():
        return
    np.testing.assert_allclose(p @ res.A, 1.0, atol=1e-7)  # E[τ] @ A
    np.testing.assert_allclose(relay.fused_coefficients(res.A, p).numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------------------------
# Raveled-view layer: random pytrees through tree_ravel/unravel
# ------------------------------------------------------------------------

_LEAF_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@st.composite
def random_pytree(draw):
    """A random nested pytree: 1-6 leaves of rank ≤ 3 (scalars included),
    f32/bf16 dtypes, folded into a random mix of dict/list/tuple containers."""
    n_leaves = draw(st.integers(1, 6))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    nodes = []
    for _ in range(n_leaves):
        shape = tuple(draw(st.lists(st.integers(1, 4), min_size=0, max_size=3)))
        dtype = _LEAF_DTYPES[draw(st.sampled_from(sorted(_LEAF_DTYPES)))]
        nodes.append(torch.from_numpy(rng.standard_normal(shape)).to(dtype))
    while len(nodes) > 1:
        kind = draw(st.sampled_from(["dict", "list", "tuple"]))
        a, b = nodes[0], nodes[1]
        merged = {"a": a, "b": b} if kind == "dict" else (
            [a, b] if kind == "list" else (a, b))
        nodes = [merged] + nodes[2:]
    return nodes[0]


def _to_jax(ref, tree):
    """The same tree for the JAX package, bit for bit (bf16 through its
    bits)."""
    def conv(x):
        if x.dtype == torch.bfloat16:
            bits = ref.jnp.asarray(x.view(torch.int16).numpy())
            return ref.jax.lax.bitcast_convert_type(bits, ref.jnp.bfloat16)
        return ref.jnp.asarray(x.numpy())

    return tree_map(conv, tree)


def _leaves_bit_equal(a, b) -> bool:
    (la, ta), (lb, tb) = tree_flatten(a), tree_flatten(b)
    return ta == tb and len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        # the f32 view of an f32/bf16 leaf is exact, so f32 equality on
        # finite draws is bit equality
        and torch.equal(x.float(), y.float())
        for x, y in zip(la, lb)
    )


@given(random_pytree())
@settings(max_examples=50, deadline=None)
def test_tree_ravel_round_trip_bit_exact(tree):
    """tree_unravel ∘ tree_ravel = id, bit for bit, for any nesting, any mix
    of f32/bf16 leaves, any leaf rank; the buffer equals the reference's."""
    ref = _reference()
    flat, spec = tree_ravel(tree)
    assert flat.dtype == torch.float32
    assert tuple(flat.shape) == (spec.total,)
    want, _ = ref.utils.tree_ravel(_to_jax(ref, tree))
    assert np.array_equal(flat.numpy(), np.asarray(want))
    back = tree_unravel(spec, flat)
    assert _leaves_bit_equal(tree, back)


@given(random_pytree(), st.integers(1, 5))
@settings(max_examples=30, deadline=None)
def test_stacked_ravel_rows_are_per_client_ravels(tree, n):
    """stacked_ravel of a stacked tree is row-for-row tree_ravel of each
    client's slice, under one shared spec; the buffer equals the
    reference's."""
    ref = _reference()
    stacked = tree_map(
        lambda x: torch.stack([x * torch.tensor(i + 1.0, dtype=x.dtype) for i in range(n)]),
        tree)
    buf, spec = stacked_ravel(stacked)
    assert tuple(buf.shape) == (n, spec.total)
    want, _ = ref.utils.stacked_ravel(_to_jax(ref, stacked))
    assert np.array_equal(buf.numpy(), np.asarray(want))
    for i in range(n):
        client = tree_map(lambda x: x[i], stacked)
        row, client_spec = tree_ravel(client)
        assert client_spec == spec
        assert torch.equal(buf[i], row)
        assert _leaves_bit_equal(client, tree_unravel(spec, buf[i]))


# ------------------------------------------------------------------------
# Async staleness weighting: the pure weight math of fl.async_engine, over
# random channels, churn masks and delays
# ------------------------------------------------------------------------


@st.composite
def staleness_setting(draw):
    """A masked channel draw plus per-slot staleness, a decay and a seed."""
    p, adj, active = draw(masked_setting())
    n = p.shape[0]
    staleness = np.asarray(draw(st.lists(st.integers(0, 12), min_size=n, max_size=n)))
    decay = draw(st.floats(0.05, 1.0))
    seed = draw(st.integers(0, 2**31 - 1))
    return p, adj, active, staleness, decay, seed


@given(staleness_setting())
@settings(max_examples=30, deadline=None)
def test_staleness_discounts_bounded_monotone_and_exact_at_zero(setting):
    """decay**s stays in (0, 1], never increases with staleness, and a fresh
    slot (s=0) gets *exactly* the 1.0 identity weight; equal to the
    reference's."""
    _, _, _, staleness, decay, _ = setting
    d = async_engine.staleness_discounts(staleness, decay=decay)
    want = _reference().async_engine.staleness_discounts(staleness, decay=decay)
    assert np.array_equal(d, np.asarray(want))
    assert d.dtype == np.float32
    assert (d > 0.0).all() and (d <= 1.0).all()
    assert np.all(d[staleness == 0] == np.float32(1.0))
    order = np.argsort(staleness, kind="stable")
    assert np.all(np.diff(d[order]) <= 1e-7)


@given(staleness_setting())
@settings(max_examples=30, deadline=None)
def test_staleness_weights_form_a_simplex_over_selected_slots(setting):
    """The renormalized weights are nonnegative, exactly zero wherever the
    discount-mask vector is zero, and sum to one whenever any slot is
    selected (the all-zero vector maps to all-zero weights)."""
    _, _, active, staleness, decay, seed = setting
    rng = np.random.default_rng(seed)
    selected = rng.random(active.shape[0]) < 0.7
    m = async_engine.staleness_discounts(staleness, decay=decay)
    m = m * (selected & active)
    w = async_engine.staleness_weights(m).numpy()
    want = np.asarray(_reference().async_engine.staleness_weights(m))
    np.testing.assert_allclose(w, want, rtol=1e-6, atol=0)
    assert (w >= 0.0).all()
    assert np.all(w[m == 0.0] == 0.0)
    if m.sum() > 0:
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    else:
        assert np.all(w == 0.0)


@given(masked_setting())
@settings(max_examples=25, deadline=None)
def test_staleness_weights_reduce_to_active_weight_at_delay0(setting):
    """At delay 0 every live slot carries discount exactly 1.0, so the
    renormalized weights are bit-equal to the synchronous blind weight
    1/n_active of ``aggregation.active_weight`` on the live slots, and to
    the reference's, and exactly zero on departed ones."""
    _, _, active = setting
    m = active.astype(np.float32)
    w = async_engine.staleness_weights(m).numpy()
    w_sync = np.float32(aggregation.active_weight(torch.as_tensor(active), n=len(active)))
    assert np.all(w[active] == w_sync)
    assert np.all(w[~active] == 0.0)
    assert np.array_equal(w, np.asarray(_reference().async_engine.staleness_weights(m)))


def _edge_relay(A):
    rows, cols = np.nonzero(A)
    return relay.EdgeRelay(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                           vals=A[rows, cols].astype(np.float32))


@given(masked_setting(), st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_async_coefficients_match_sync_fused_at_delay0(setting, seed):
    """With every slot fresh (m == active) the async coefficient vector is
    bitwise the synchronous fused path's w·(τᵀA) under the same churn
    masking, on the dense and the sparse edge-list operand alike, and within
    f32 rounding of the reference's."""
    p, adj, active = setting
    ref = _reference()
    n = len(p)
    rng = np.random.default_rng(seed)
    tau = (rng.random(n) < p).astype(np.float32) * active
    A = opt_alpha.optimize_masked(p, adj, active, sweeps=15).A
    operands = {"einsum": torch.as_tensor(A, dtype=torch.float32),
                "segment": _edge_relay(A)}
    m = active.astype(np.float32)
    a = torch.as_tensor(active, dtype=torch.float32)
    want_ref = ref.async_engine.async_coefficients(
        ref.jnp.asarray(A, ref.jnp.float32), tau, m, n=n,
        active=ref.jnp.asarray(active, ref.jnp.float32), backend="einsum")
    for backend, op in operands.items():
        got = async_engine.async_coefficients(op, tau, m, n=n, active=a, backend=backend)
        op_dev = relay.as_relay_operand(op, n=n, backend=backend, device="cpu")
        base = relay.fused_coefficients(relay.mask_relay_matrix(op_dev, a),
                                        torch.as_tensor(tau) * a)
        want = aggregation.active_weight(a, n=n) * base
        assert torch.equal(got, want), backend
        np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("backend", [
    "einsum", "segment",
    pytest.param("hopper", marks=pytest.mark.cuda),
    pytest.param("hopper_fused", marks=pytest.mark.cuda),
])
@given(setting=staleness_setting())
@settings(max_examples=10, deadline=None)
def test_zero_mass_slots_contribute_exactly_zero_on_all_backends(backend, setting):
    """A departed or never-arrived slot (m == 0) must contribute *exactly*
    zero to the aggregate: its buffer row is poisoned with huge finite
    values, and the increment is bit-identical to the one computed with the
    row zeroed.  ``einsum`` and ``segment`` on the CPU; the CUDA kernels'
    backends on the card."""
    device = "cpu"
    if backend.startswith("hopper"):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
        device = "cuda"
    p, adj, active, staleness, decay, seed = setting
    n = len(p)
    rng = np.random.default_rng(seed)
    arrived = rng.random(n) < 0.6
    m = async_engine.staleness_discounts(staleness, decay=decay)
    m = m * (arrived & active)
    tau = (rng.random(n) < p).astype(np.float32)
    A = opt_alpha.optimize_masked(p, adj, active, sweeps=10).A
    op = _edge_relay(A) if backend == "segment" else torch.as_tensor(A, dtype=torch.float32)
    buf = rng.standard_normal((n, 32)).astype(np.float32)
    poisoned = buf.copy()
    poisoned[m == 0.0] = 1e30
    clean = buf.copy()
    clean[m == 0.0] = 0.0
    a = torch.as_tensor(active, dtype=torch.float32, device=device)
    got = async_engine.async_increment_flat(
        op, tau, m, torch.as_tensor(poisoned, device=device), n=n, active=a, backend=backend)
    want = async_engine.async_increment_flat(
        op, tau, m, torch.as_tensor(clean, device=device), n=n, active=a, backend=backend)
    assert got.device.type == device
    assert bool(torch.isfinite(got).all()), backend
    assert torch.equal(got, want), backend


@given(random_pytree(), st.integers(0, 2**31 - 1))
@settings(max_examples=40, deadline=None)
def test_tree_dot_and_norm_agree_with_raveled(tree, seed):
    """The structured reductions and their raveled counterparts are the same
    f32 quantity (summation order differs, so: to f32 precision), and the
    reference's."""
    ref = _reference()
    rng = np.random.default_rng(seed)
    other = tree_map(lambda x: torch.from_numpy(rng.standard_normal(tuple(x.shape))).to(x.dtype),
                     tree)
    fa, _ = tree_ravel(tree)
    fb, _ = tree_ravel(other)
    np.testing.assert_allclose(float(tree_dot(tree, other)), float(torch.dot(fa, fb)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tree_norm(tree)), float(torch.linalg.norm(fa)),
                               rtol=1e-5, atol=1e-6)
    jt, jo = _to_jax(ref, tree), _to_jax(ref, other)
    np.testing.assert_allclose(float(tree_dot(tree, other)), float(ref.utils.tree_dot(jt, jo)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tree_norm(tree)), float(ref.utils.tree_norm(jt)),
                               rtol=1e-5, atol=1e-6)
