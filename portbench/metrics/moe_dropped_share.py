"""The share of the token choices routed to this chip's experts that the
experts dropped at capacity, in the span window: the port's
``moe.choices_dropped`` over ``moe.choices_here`` (DeepSeekMoE's counters,
summed over layers, clients and local steps, handed to the tracer once
each chunk has run), in %.  A program without the counters, or a window
that routed nothing here, has nothing to read."""


def read(ctx):
    here = ctx.counters.get("moe.choices_here", 0)
    if here <= 0:
        return None
    return 100.0 * ctx.counters.get("moe.choices_dropped", 0) / here
