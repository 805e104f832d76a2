"""The memory the pools of the model's live packed-step CUDA graphs hold
at the end of a replay pass (``graph_pool_bytes``, the loop's counter),
in MiB, averaged over the window's untraced passes: how far the graphs a
model keeps fill its byte budget."""


def read(ctx):
    if not ctx["passes"] or "graph_pool_bytes" not in ctx["counters"]:
        return None
    return ctx["counters"]["graph_pool_bytes"] / ctx["passes"] / 2**20
