"""The device memory allocated at its peak over the traced window (the
count reset at the window's start), GiB."""


def read(name, ctx):
    if not name.endswith("." + ctx["kind"]):
        return None
    return ctx["peak_bytes"] / 2**30
