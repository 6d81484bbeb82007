"""Device ms a round of host-to-device copies of staged batches: the union
of the port's ``prefetch.copy`` spans (CUDA events around each chunk's
copies on the engine's stream, ``channels/scheduler.py::_to_device``) over
the span window's rounds.  The copies' bytes are the ``prefetch.bytes``
counter.  Without a card, or without device-timed spans, nothing is read."""

from portbench import spans


def read(ctx):
    t = spans.timeline(ctx)
    if t is None or not t.named("prefetch.copy"):
        return None
    return spans.ms_per_round(ctx, spans.measure(t.named("prefetch.copy")))
