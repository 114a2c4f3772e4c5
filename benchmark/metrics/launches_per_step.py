"""Kernel launches on the device in the traced window per train step."""


def read(name, ctx):
    if ctx["kind"] != "train":
        return None
    return len(ctx["trace"].kernels()) / ctx["units"]
