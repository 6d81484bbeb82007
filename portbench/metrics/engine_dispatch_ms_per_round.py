"""Host ms a round the pipelined engine spends launching or replaying its
chunks: the port's ``pipelined.chunk`` spans over the span window's rounds
(``fl/engine.py::PipelinedScanEngine``)."""


def read(ctx):
    if not ctx.has_span("pipelined.chunk") or ctx.span_window.rounds == 0:
        return None
    return 1e3 * ctx.span_seconds("pipelined.chunk") / ctx.span_window.rounds
