"""The port's ring relay (``repro_torch.fl.ring``) on gloo worlds of k = 2
and 4 CPU ranks, against the dense contraction and against the JAX
package's ring.  Oracle: ``tests/test_ring_relay.py``, whose way of running
the JAX ring (a subprocess with ``XLA_FLAGS`` forcing k host devices) this
file reuses on the same numpy inputs.

* Block ring on the flat (n, D) buffer, m = n/k clients a rank, with and
  without a churn mask: within 1e-5 of ``aggregation.colrel_increment_flat``
  and of the JAX package's ``ring_colrel_increment_flat``; the same result on
  every rank.
* The pytree forms (one client a rank) through ``make_ring_round_mixer``, on
  a 1-D client mesh and on a (pod, data, model) mesh whose client axes are
  ("pod", "data"): within 1e-5 of the dense relay + blind sum and of the JAX
  mixer.
* One rank (no process group): the ring is the dense product and sends
  nothing.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.core import aggregation, connectivity, opt_alpha, relay, topology
from repro_torch.fl import ring
from repro_torch.launch.mesh import Mesh, make_client_mesh, run_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N, D = 8, 48

_JAX_RING = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.core import aggregation, relay as relay_lib
from repro.fl.ring import make_ring_round_mixer, ring_colrel_increment_flat
from repro.launch.mesh import make_client_mesh, make_local_mesh

inp = dict(np.load(sys.argv[1]))
k = int(inp["k"])
A, tau, buf, churn = (jnp.asarray(inp[x], jnp.float32) for x in ("A", "tau", "buf", "churn"))
n = A.shape[0]
out = {}
mesh = make_client_mesh(k)
for label, active in (("full", None), ("churn", churn)):
    w = aggregation.active_weight(active, n=n)
    A_eff, tau_eff = (A, tau) if active is None else (
        relay_lib.mask_relay_matrix(A, active), tau * active)

    def local(A_, t_, w_, b_):
        return ring_colrel_increment_flat(A_, t_, b_, w=w_, axis_name="clients", n_shards=k)

    out[label] = np.asarray(jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(None, None), P(None), P(), P("clients", None)),
        out_specs=P(None), check_rep=False,
    ))(A_eff, tau_eff, jnp.asarray(w, jnp.float32), buf))
deltas = {"w": jnp.asarray(inp["dw"]), "b": jnp.asarray(inp["db"])}
for label, m, axes in (("mixer", make_local_mesh(k, 1), ("data",)),
                       ("mixer_pod", make_local_mesh(k // 2, 1, pod=2), ("pod", "data"))):
    with m:
        mixer = make_ring_round_mixer(inp["A_one"], w=1.0 / k, mesh=m, client_axes=axes)
        got = jax.jit(mixer)(jnp.asarray(inp["tau_one"]), deltas)
    for key in got:
        out[f"{label}_{key}"] = np.asarray(got[key])
np.savez(sys.argv[2], **out)
"""


def _inputs(k):
    p = connectivity.heterogeneous_profile(N).p
    rng = np.random.default_rng(3)
    p_one = connectivity.heterogeneous_profile(k).p
    return dict(
        k=np.asarray(k),
        A=opt_alpha.optimize(p, topology.ring(N, 2), sweeps=10).A.astype(np.float32),
        buf=rng.standard_normal((N, D)).astype(np.float32),
        tau=(rng.random(N) < p).astype(np.float32),
        churn=(rng.random(N) < 0.7).astype(np.float32),
        A_one=opt_alpha.optimize(p_one, topology.ring(k, 1), sweeps=10).A.astype(np.float32),
        dw=rng.standard_normal((k, 12, 5)).astype(np.float32),
        db=rng.standard_normal((k, 7)).astype(np.float32),
        tau_one=(rng.random(k) < p_one).astype(np.float32),
    )


def _jax_ring(inp, k, tmp_path):
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={k}")
    proc = subprocess.run([sys.executable, "-c", _JAX_RING, str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          capture_output=True, text=True, env=env, timeout=420)
    assert proc.returncode == 0, proc.stderr
    return dict(np.load(tmp_path / "out.npz"))


@pytest.mark.parametrize("k", [2, 4])
def test_ring_equals_einsum_and_the_jax_ring(k, tmp_path):
    inp = _inputs(k)
    ranks = run_ranks(torch_ranks.ring_cases, k, num_threads=1, timeout=300, args=(
        inp["A"], inp["tau"], inp["churn"], inp["buf"], inp["A_one"],
        {"w": inp["dw"], "b": inp["db"]}, inp["tau_one"]))
    want_jax = _jax_ring(inp, k, tmp_path)
    for r in ranks[1:]:  # the increment is the same on every rank
        for label in ("full", "churn"):
            assert np.array_equal(r[label], ranks[0][label])
    got = ranks[0]
    buf = torch.from_numpy(inp["buf"])
    for label, active in (("full", None), ("churn", torch.from_numpy(inp["churn"]))):
        dense = aggregation.colrel_increment_flat(
            torch.from_numpy(inp["A"]), torch.from_numpy(inp["tau"]), buf, n=N, active=active)
        np.testing.assert_allclose(got[label], dense.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[label], want_jax[label], atol=1e-5, rtol=0)
    deltas = {"w": torch.from_numpy(inp["dw"]), "b": torch.from_numpy(inp["db"])}
    dense = relay.masked_aggregate(torch.from_numpy(inp["tau_one"]),
                                   relay.relay(torch.from_numpy(inp["A_one"]), deltas), w=1.0 / k)
    for label in ("mixer", "mixer_pod"):
        for key in ("w", "b"):
            assert got[label][key].shape == inp[f"d{key}"].shape[1:]
            np.testing.assert_allclose(got[label][key], dense[key].numpy(), atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[label][key], want_jax[f"{label}_{key}"],
                                       atol=1e-5, rtol=0)


def test_one_rank_ring_is_the_block_product_and_sends_nothing(monkeypatch):
    inp = _inputs(2)
    mesh = make_client_mesh()
    monkeypatch.setattr(Mesh, "rotate", lambda *a: pytest.fail("a one-rank ring rotated"))
    A, tau, buf = (torch.from_numpy(inp[x]) for x in ("A", "tau", "buf"))
    relayed = ring.ring_relay_flat(A, buf, axis_name="clients", n_shards=1, mesh=mesh)
    assert torch.equal(relayed, A @ buf)
    u = ring.ring_colrel_increment_flat(A, tau, buf, w=1.0 / N, axis_name="clients",
                                        n_shards=1, mesh=mesh)
    dense = aggregation.colrel_increment_flat(A, tau, buf, n=N)
    np.testing.assert_allclose(u.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        ring.ring_relay_flat(A[:7, :7], buf[:7], axis_name="clients", n_shards=2, mesh=mesh)
    with pytest.raises(ValueError, match="holds 1 ranks"):
        ring.ring_relay_flat(A, buf, axis_name="clients", n_shards=2, mesh=mesh)
