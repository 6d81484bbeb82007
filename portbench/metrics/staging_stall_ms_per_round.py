"""Ms a round the device sat idle while the engine waited on staging: the
span window's device-idle time (``portbench/spans.py``) that the port's
``prefetch.wait`` spans overlap (``channels/scheduler.py::SegmentPrefetcher``:
the consumer's ``get`` from the staging queue).  This is what staging costs
the card, where ``host_wait_ms_per_round`` is what it costs the host.
Without a card, or without device-timed spans, nothing is read."""

from portbench import spans


def read(ctx):
    t = spans.timeline(ctx)
    if t is None or not t.named("prefetch.wait"):
        return None
    return spans.ms_per_round(ctx, spans.measure(spans.intersect(t.idle,
                                                                 t.named("prefetch.wait"))))
