"""The device's busy time in the traced pass (the union of its kernels,
copies and sets) per training step."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    return 1e6 * t["busy_s"] / (ctx["least"]["steps"] * t["passes"])
