"""The flash-attention backward kernels' share of their roofline (the dq
and the dk/dv launches together) at the function's work of
10 B H Nq Nk D, in %.  The backward's shapes are those of the forward's
launches that take a gradient: a remat step records each forward site twice
(the forward, then its recomputation), and the first self-attention of the
UNet, ahead of every cross-attention, gets none under prompt-only
training."""

from collections import Counter

from benchmark.flops import attention_bound_s

KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(name, ctx):
    if ctx["kind"] != "train":
        return None
    tr = ctx["trace"]
    times = [e - s for s, e, n in tr.kernels() if any(k in n for k in KERNELS)]
    fwd = [shape for kernel, shape in ctx["sites"] if kernel == "flash_fwd"]
    steps = ctx["units"]
    if not times or not fwd or len(fwd) % (2 * steps):
        return None
    per_step = Counter(fwd[: len(fwd) // (2 * steps)])
    per_step[fwd[0]] -= 1  # the first self-attention: no backward
    sites = [s for s, k in per_step.items() for _ in range(k)] * steps
    dq = sum(1 for s, e, n in tr.kernels() if KERNELS[0] in n)
    bound = sum(attention_bound_s(*s, backward=True) for s in sites) * (dq / len(sites) if dq else 1.0)
    return 100.0 * bound / (sum(times) * 1e-9)
