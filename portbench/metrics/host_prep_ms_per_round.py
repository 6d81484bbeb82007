"""Host ms a round of all staging, hidden behind the device or not
(``PrefetchStats.prep_s``), over the untraced window of a traced run."""


def read(ctx):
    w = ctx.untraced_window
    if w is None or w.rounds == 0:
        return None
    return 1e3 * w.prep_s / w.rounds
