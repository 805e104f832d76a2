"""CUDA graphs the program captured (``graph_captures``, the loop's
counter) per replay pass, over the window's untraced passes: a (layout,
K) whose graph was released since its last replay is captured again."""


def read(ctx):
    if not ctx["passes"] or "graph_captures" not in ctx["counters"]:
        return None
    return ctx["counters"]["graph_captures"] / ctx["passes"]
