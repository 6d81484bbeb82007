"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ColRel.

One run measures one cell of ``BENCHMARK.json`` (a model configuration
under a channel traffic mix) through the port's pipelined round engine::

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: ``configs/<config>.json`` (sizes;
its ``model`` names ``models/<model>.py``, the port binding and FLOP
counter (``leaf_shapes``, ``init_params``, ``program_loss``,
``port_params``, ``cpu_size``, ``forward_flops_per_sample``), and
``reference/<model>.py``, the plain model's ``loss``; its ``data.kind``
names ``data/<kind>.py``, the dataset and partition both sides take),
``traffic/<traffic>.json`` (the channel and the engine's feed, read by
``generator.py``, which finds each mechanism the mix names in
``topologies/``, ``channels/``, ``policies/`` and ``engines/``, and its
reference side in ``reference/channels/`` and ``reference/policies/``),
``metrics/<metric>.py`` (one reader a per-layer metric) and
``checks/<workload>.json`` (the limits that decide ``correct``).  Nothing
under ``reference/`` imports the port.
"""
