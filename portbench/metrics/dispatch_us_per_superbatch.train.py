"""The consumer's host time dispatching work (``dispatch_s``, the loop's
counter: the packed step's graph replays and the pass's per-batch tail
step) per packed superbatch, over the window's untraced passes."""


def read(ctx):
    if not ctx["superbatches"] or "dispatch_s" not in ctx["counters"]:
        return None
    return 1e6 * ctx["counters"]["dispatch_s"] / ctx["superbatches"]
