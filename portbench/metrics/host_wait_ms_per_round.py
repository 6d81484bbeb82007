"""Host ms a round the engine waited on staging (``SegmentPrefetcher``'s
``PrefetchStats.wait_s``: batch gather, stacking, pinned copy and relay
solves left on the critical path), over the untraced window of a traced
run (no fences, no profiler)."""


def read(ctx):
    w = ctx.untraced_window
    if w is None or w.rounds == 0:
        return None
    return 1e3 * w.wait_s / w.rounds
