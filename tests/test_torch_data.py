"""The port's numpy data layer against the JAX package's: the same seeds give
the same arrays."""
import numpy as np
import pytest

from repro.data import loader as jax_loader
from repro.data import partition as jax_partition
from repro.data import synthetic as jax_synthetic
from repro_torch.data import loader, partition, synthetic


def test_cifar_like_equal():
    got = synthetic.cifar_like(64, seed=3)
    want = jax_synthetic.cifar_like(64, seed=3)
    assert np.array_equal(got.inputs, want.inputs)
    assert np.array_equal(got.labels, want.labels)
    assert got.inputs.shape == (64, 32, 32, 3) and len(got) == 64


def test_other_generators_equal():
    for name, kw in (("gaussian_classification", {"n": 50, "dim": 8}),
                     ("lm_tokens", {"n_seqs": 6, "seq_len": 9})):
        got = getattr(synthetic, name)(**kw, seed=2)
        want = getattr(jax_synthetic, name)(**kw, seed=2)
        assert np.array_equal(got.inputs, want.inputs)
        assert np.array_equal(got.labels, want.labels)
    for a, b in zip(synthetic.quadratic_problem(5, 3), jax_synthetic.quadratic_problem(5, 3)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["iid", "sort"])
@pytest.mark.parametrize("vectorized", [None, True])
def test_partitions_and_round_batches_equal(kind, vectorized):
    ds = synthetic.cifar_like(120, seed=0)
    jds = jax_synthetic.cifar_like(120, seed=0)
    if kind == "iid":
        parts = partition.iid_partition(ds, 6, seed=1)
        jparts = jax_partition.iid_partition(jds, 6, seed=1)
    else:
        parts = partition.sort_and_partition(ds, 6, seed=1)
        jparts = jax_partition.sort_and_partition(jds, 6, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip(parts, jparts))
    assert np.array_equal(partition.client_label_histogram(ds, parts, 10),
                          jax_partition.client_label_histogram(jds, jparts, 10))
    fl = loader.FederatedLoader(ds, parts, seed=4, vectorized=vectorized)
    jfl = jax_loader.FederatedLoader(jds, jparts, seed=4, vectorized=vectorized)
    for _ in range(2):
        got, want = fl.round_batch(3, 5), jfl.round_batch(3, 5)
        assert got.keys() == want.keys() == {"images", "labels"}
        assert got["images"].shape == (6, 3, 5, 32, 32, 3)
        assert all(np.array_equal(got[key], want[key]) for key in got)
