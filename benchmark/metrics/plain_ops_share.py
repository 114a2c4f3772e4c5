"""The share of device time in kernels that are not the program's own (its
kernels live in namespace ``lr``): PyTorch's elementwise ops, norms, casts,
cuBLAS and cuDNN, and the copies, in %."""

from benchmark.trace import PORT_KERNEL


def read(name, ctx):
    if not name.endswith("." + ctx["kind"]):
        return None
    tr = ctx["trace"]
    total = tr.device_time_s()
    return 100.0 * tr.device_time_s(lambda n: PORT_KERNEL not in n) / total if total else None
