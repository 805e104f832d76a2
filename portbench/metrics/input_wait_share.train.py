"""The consumer's wait for input (``consumer_starve_s``, the loop's
counter) over the window's untraced passes, as a share of their time."""


def read(ctx):
    if ctx["window_s"] <= 0 or "consumer_starve_s" not in ctx["counters"]:
        return None
    return 100.0 * ctx["counters"]["consumer_starve_s"] / ctx["window_s"]
