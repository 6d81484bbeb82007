"""One reader a per-layer metric: ``metrics/<name>.py`` holds
``read(ctx: portbench.harness.TraceContext) -> float | None``.  A reader
that finds nothing to read returns None, and the metric is left out of the
result's line."""
