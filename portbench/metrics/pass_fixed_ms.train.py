"""A ``run_train_loop`` call's edges per replay pass, over the window's
untraced passes: ``pass_open_s`` (``fwt.pass.open``: from the call's entry
to the consumer's first wait for input) plus ``pass_close_s``
(``fwt.pass.close``: from the end of the stream to the call's return)."""


def read(ctx):
    c = ctx["counters"]
    if not ctx["passes"] or "pass_open_s" not in c or "pass_close_s" not in c:
        return None
    return 1e3 * (c["pass_open_s"] + c["pass_close_s"]) / ctx["passes"]
