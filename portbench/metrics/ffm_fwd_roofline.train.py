"""The FFM forward kernel's least time (roofline.py, over the traced
pass's batches) over its device time in the traced pass."""

from portbench.trace import kernel_seconds


def read(ctx):
    sec, calls = kernel_seconds(ctx["trace"], "ffm_fwd_kernel")
    if calls == 0 or sec <= 0:
        return None
    return 100.0 * ctx["least"]["ffm_fwd"] * ctx["trace"]["passes"] / sec
