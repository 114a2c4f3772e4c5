"""The share of the traced window, in %, in which the device idled while
the host was inside the sampler's ``sample`` span (its steps and UNet calls
included): the idle gaps of the device trace put down by their midpoints
(``benchmark/spans.py``)."""

from benchmark.spans import idle_share


def read(name, ctx):
    if not name.endswith("." + ctx["kind"]):
        return None
    return idle_share(ctx, "sampler")
