"""The whole step's least time (roofline.py: the larger of its f32
operations over the f32 peak and its bytes over the memory rate) summed
over the window's untraced passes, over their wall time."""


def read(ctx):
    if ctx["window_s"] <= 0 or not ctx["passes"]:
        return None
    return 100.0 * ctx["least"]["step"] * ctx["passes"] / ctx["window_s"]
