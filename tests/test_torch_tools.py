"""The measurement helpers shared by ``chip_smoke.py`` and the profiling
scripts: the launch counts per forward they check equal the port's dispatch
at full width (on torch's ``meta`` device), and the bound of a kernel site
is the larger of its bytes over the memory rate and its operations over the
tensor-core peak."""

from collections import Counter

import pytest
import torch

from leftrefill_torch import kernels, tools


@pytest.mark.parametrize("path", ["bf16", "int8", "int8_unfused", "multiview_v4"])
def test_per_forward_counts_match_the_dispatch(monkeypatch, path):
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    rows, hw = (8, (64, 64)) if path == "multiview_v4" else (2, (64, 128))
    with torch.device("meta"):
        if path == "multiview_v4":
            unet = MultiViewUnetModel(view_num=4, dtype=torch.bfloat16)
        else:
            unet = UNetModel(dtype=torch.bfloat16, quant=path != "bf16", fused=path == "int8")
        x, ts, ctx = torch.empty(rows, *hw, 9), torch.empty(rows, dtype=torch.long), torch.empty(rows, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=path != "multiview_v4")
    expected = {"bf16": tools.PER_FORWARD_BF16, "int8": tools.PER_FORWARD_INT8,
                "int8_unfused": tools.PER_FORWARD_INT8_UNFUSED, "multiview_v4": tools.PER_FORWARD_MV4}[path]
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in expected.items() if v})
    assert set(expected) == set(tools.LAUNCH_COUNTERS) == set(kernels.NAMES) == set(tools.KERNEL_FNS)


def test_bounds():
    """The ds-1 flash site is bound by its operations (4 B H N^2 D at the
    bf16 peak), the fused prologues by their bytes (2 + 1 bytes an element
    and the fold)."""
    ms, by = tools.bound_ms("flash_fwd", (2, 5, 8192, 8192, 64))
    assert by == "operations" and ms == pytest.approx(4 * 10 * 8192**2 * 64 / tools.PEAK_BF16 * 1e3)
    n = 2 * 64 * 128 * 320
    ms, by = tools.bound_ms("affine_silu_quant", (2, 64, 128, 320))
    assert by == "bytes" and ms == pytest.approx((3 * n + 8 * 2 * 320 + 4) / tools.HBM_BYTES_PER_S * 1e3)
    nbytes, ops = tools.site_cost("ln_quant", (16384, 320, True))
    assert ops == 0 and nbytes == 5 * 16384 * 320 + 4 * 16384 + 8 * 320
    assert tools.bound_ms("conv3x3_int8", (2, 64, 128, 320, 320))[1] == "operations"
