"""The device's idle share of the traced window: 1 - (the union of its
kernel, copy and set intervals) / the window's wall time, in %."""


def read(name, ctx):
    if not name.endswith("." + ctx["kind"]):
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
