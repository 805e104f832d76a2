"""The host time the program spent releasing CUDA graphs
(``graph_release_s``, the loop's counter and its ``fwt.graph.release``
spans: a graph dropped and its pool returned to the card with
``empty_cache``, which waits for the card) per replay pass, over the
window's untraced passes. The counter counts one call's releases."""


def read(ctx):
    if not ctx["passes"] or "graph_release_s" not in ctx["counters"]:
        return None
    return 1e3 * ctx["counters"]["graph_release_s"] / ctx["passes"]
