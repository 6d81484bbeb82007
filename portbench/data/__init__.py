"""One module a kind of data (a configuration's ``data.kind``):
``make(data, n_clients, seeds) -> (Dataset, client partitions)`` from the
``data`` block and the run's sub-seeds, and ``LM: bool``: whether the
dataset's inputs are (N, seq + 1) token sequences that the port's loader
splits into tokens and next-token targets (``round_batch(..., lm=True)``)
and the reference's batch stream splits the same way."""
