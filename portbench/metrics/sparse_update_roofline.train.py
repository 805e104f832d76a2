"""The sparse AdaGrad update's least time (roofline.py: both calls of
each step, LR and FFM) over the device time of its two kernels
(``tile_kernel``, ``crossing_kernel``) in the traced pass."""

from portbench.trace import kernel_seconds


def read(ctx):
    sec, calls = kernel_seconds(ctx["trace"], "tile_kernel", "crossing_kernel")
    if calls == 0 or sec <= 0:
        return None
    return 100.0 * ctx["least"]["sparse_update"] * ctx["trace"]["passes"] / sec
