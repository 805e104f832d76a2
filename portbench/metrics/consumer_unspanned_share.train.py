"""The share of the window's untraced passes in which the consumer thread
was inside none of its counted spans: the pass's edges (``pass_open_s``,
``pass_close_s``), its waits for input (``consumer_starve_s``), its
dispatches (``dispatch_s``) and its hand-offs to the writer
(``writer_stall_s``)."""

KEYS = ("pass_open_s", "consumer_starve_s", "dispatch_s", "writer_stall_s",
        "pass_close_s")


def read(ctx):
    c = ctx["counters"]
    if ctx["window_s"] <= 0 or any(k not in c for k in KEYS):
        return None
    return 100.0 * (1.0 - sum(c[k] for k in KEYS) / ctx["window_s"])
