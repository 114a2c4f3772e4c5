"""The share of the traced window, in %, in which the device idled while
the host did a request's or a pipeline call's own work (the innermost span
open ``request``, ``request.*``, ``pipeline`` or ``pipeline.inputs``): the
idle gaps of the device trace put down by their midpoints
(``benchmark/spans.py``)."""

from benchmark.spans import idle_share


def read(name, ctx):
    if not name.endswith("." + ctx["kind"]):
        return None
    return idle_share(ctx, "entry")
