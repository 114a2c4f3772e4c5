"""The flash-attention forward kernel's share of its roofline: the sum of
its launches' least times (``flops.attention_bound_s`` at each launch's
shape, as the program's dispatcher recorded it) over the sum of their device
times in the trace, in %.  Where the trace lost some launches' events, the
bound is scaled by the share it kept."""

from benchmark.flops import attention_bound_s

KERNEL = "flash_fwd_kernel"


def read(name, ctx):
    if ctx["kind"] != "infer":
        return None
    tr = ctx["trace"]
    times = [e - s for s, e, n in tr.kernels() if KERNEL in n]
    sites = [shape for kernel, shape in ctx["sites"] if kernel == "flash_fwd"]
    if not times or not sites:
        return None
    bound = sum(attention_bound_s(*shape) for shape in sites) * len(times) / len(sites)
    return 100.0 * bound / (sum(times) * 1e-9)
