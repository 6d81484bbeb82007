"""Ms a round the device sat idle while the engine launched or replayed a
chunk: the span window's device-idle time (``portbench/spans.py``) that the
port's ``pipelined.chunk`` spans overlap and its ``prefetch.wait`` spans do
not.  Without a card, or without device-timed spans, nothing is read."""

from portbench import spans


def read(ctx):
    t = spans.timeline(ctx)
    if t is None or not t.named("pipelined.chunk"):
        return None
    stalled = spans.subtract(spans.intersect(t.idle, t.named("pipelined.chunk")),
                             t.named("prefetch.wait"))
    return spans.ms_per_round(ctx, spans.measure(stalled))
