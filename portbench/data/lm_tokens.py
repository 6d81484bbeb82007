"""Synthetic token streams for next-token prediction, IID over the clients.

``lm_tokens`` is a frozen copy of
``src/repro_torch/data/synthetic.py::lm_tokens`` at commit ae7eabb: each
sequence follows t_{k+1} = (a·t_k + b) mod V with its stream's (a, b),
each token redrawn uniformly with probability ``noise``.  A dataset row is
one (seq + 1,) int32 sequence, its label the stream id; the loader and the
reference cut it into tokens ``x[..., :-1]`` and targets ``x[..., 1:]``.
"""
from __future__ import annotations

import numpy as np

from portbench.inputs import Dataset, iid_partition

LM = True


def lm_tokens(n_seqs: int, seq_len: int, *, vocab: int = 512, n_streams: int = 8,
              noise: float = 0.05, seed: int = 0) -> Dataset:
    """(n_seqs, seq_len + 1) int32 token sequences; labels the stream ids."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, vocab - 1, size=(n_streams,)) | 1  # odd → full cycle-ish
    b = rng.integers(0, vocab, size=(n_streams,))
    stream = rng.integers(0, n_streams, size=(n_seqs,))
    toks = np.empty((n_seqs, seq_len + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=(n_seqs,))
    for k in range(seq_len):
        nxt = (a[stream] * toks[:, k] + b[stream]) % vocab
        flip = rng.random(n_seqs) < noise
        nxt = np.where(flip, rng.integers(0, vocab, size=(n_seqs,)), nxt)
        toks[:, k + 1] = nxt
    return Dataset(toks.astype(np.int32), stream.astype(np.int32))


def make(data: dict, n_clients: int, seeds: dict):
    """``n_train`` sequences of ``seq_len`` + 1 tokens (``vocab``,
    ``n_streams``, ``noise``) and an IID partition."""
    if data["partition"] != "iid":
        raise ValueError(f"lm_tokens: unknown partition {data['partition']!r} (known: iid)")
    ds = lm_tokens(data["n_train"], data["seq_len"], vocab=data["vocab"],
                   n_streams=data["n_streams"], noise=data["noise"], seed=seeds["data"])
    return ds, iid_partition(len(ds), n_clients, seed=seeds["partition"])
