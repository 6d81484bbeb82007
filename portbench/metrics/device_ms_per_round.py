"""Device ms a round of the rounds themselves: the union of the port's
``pipelined.device`` spans (the device's own execution of each chunk, from
CUDA events around its enqueue, ``fl/engine.py::PipelinedScanEngine``)
less its ``prefetch.copy`` spans, over the span window's rounds.  The
staging thread's copies go on the engine's stream, so one it enqueues while
the engine is between a chunk's two events runs inside that chunk's span,
and the device ran no round meanwhile.  Without a card, or without
device-timed spans, nothing is read."""

from portbench import spans


def read(ctx):
    t = spans.timeline(ctx)
    if t is None or not t.named("pipelined.device"):
        return None
    rounds = spans.subtract(t.named("pipelined.device"), t.named("prefetch.copy"))
    return spans.ms_per_round(ctx, spans.measure(rounds))
