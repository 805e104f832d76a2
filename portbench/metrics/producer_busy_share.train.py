"""The producer's busy time (``producer_busy_s``, the loop's counter: the
pack cache's reader on a replay) over the window's untraced passes, as a
share of their time."""


def read(ctx):
    if ctx["window_s"] <= 0 or "producer_busy_s" not in ctx["counters"]:
        return None
    return 100.0 * ctx["counters"]["producer_busy_s"] / ctx["window_s"]
