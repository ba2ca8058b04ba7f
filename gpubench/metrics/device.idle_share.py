"""The share of the traced window in which no operation ran on the card:
one minus the union of kernel, copy and fill intervals over the window,
in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
