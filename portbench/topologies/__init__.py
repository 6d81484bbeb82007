"""One module a topology kind (a traffic mix's ``channel.topology.kind``):
``adjacency(spec, n)`` → the symmetric bool (n, n) base graph, zero
diagonal.  It is an input the benchmark makes and hands to both the port
and the reference."""
