"""The reference's side of each channel kind: ``reference/channels/<kind>.py``
holds ``rounds(spec, adj, seeds, k)`` → the first ``k`` rounds' channel
states ``(adj, p, active)``: the round's graph (bool (n, n)), its uplink
probabilities (f32 (n,)) and its membership mask (bool (n,), or None when
every client takes part).  Each follows the semantics of the JAX package's
host-numpy channel classes (``src/repro/channels/``, copied at commit
c3a27a4, not imported), which the port's ``channels`` follows state for
state; the reference imports nothing of either package."""
