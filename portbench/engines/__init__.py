"""One module an engine kind (a traffic mix's ``engine.kind``):
``engine(spec, sim)`` → an object with the port's ``run_schedule``
signature (``generator, params, server_state, *, schedule, rounds,
next_batch, lr, policy``) and a ``prefetch_stats`` (``prep_s``,
``wait_s``) after each call; a ``tracer`` attribute, where it has one,
is set for the span window."""
