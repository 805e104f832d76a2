"""The host time the program spent capturing CUDA graphs (``capture_s``,
the packed graphs' counter and their ``fwt.graph.capture`` spans; the
harness differences it pass by pass) per replay pass, over the window's
untraced passes."""


def read(ctx):
    if not ctx["passes"] or "capture_s" not in ctx["counters"]:
        return None
    return 1e3 * ctx["counters"]["capture_s"] / ctx["passes"]
