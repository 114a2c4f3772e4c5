"""The model's operations of the units completed in the traced window
(``flops.py``'s count by shapes) over the window's wall time and the bf16
tensor-core peak, in %."""

from benchmark.flops import PEAK_BF16


def read(name, ctx):
    if not name.endswith("." + ctx["kind"]):
        return None
    return 100.0 * ctx["flops_per_unit"] * ctx["units"] / (ctx["trace"].window_s * PEAK_BF16)
