"""The measurement helpers shared by ``chip_smoke.py`` and the profiling
scripts: the launch counts per forward and per train step they check equal
the port's dispatch at full width (on torch's ``meta`` device), and the bound of a kernel site
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


@pytest.mark.parametrize("path", ["1ref_b8", "multiview_v4"])
def test_per_train_step_counts_match_the_dispatch(monkeypatch, path):
    """A full-width remat train step on ``meta`` (the frozen UNet, the
    context carrying the prompt's gradient): its kernel sites, forward,
    recompute and backward, are ``tools.PER_TRAIN_STEP(_MV4)``, and the
    backward kernels' sites by shape ``tools.TRAIN_SITES(_MV4)``."""
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    mv = path == "multiview_v4"
    rows, hw = (4, (64, 64)) if mv else (8, (64, 128))
    with torch.device("meta"):
        unet = (MultiViewUnetModel(view_num=4, dtype=torch.bfloat16, remat=True) if mv
                else UNetModel(dtype=torch.bfloat16, remat=True))
        x, ts = torch.empty(rows, *hw, 9), torch.empty(rows, dtype=torch.long)
        ctx = torch.empty(rows, 77, 1024, requires_grad=True)
    unet.requires_grad_(False)
    with kernels.record_sites() as sites:
        unet(x, ts, ctx).float().sum().backward()
    per_step, by_shape = (tools.PER_TRAIN_STEP_MV4, tools.TRAIN_SITES_MV4) if mv else \
        (tools.PER_TRAIN_STEP, tools.TRAIN_SITES)
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in per_step.items() if v})
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert Counter(shape for n, shape in sites if n == name) == Counter(by_shape)


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
    # the backward: S, dP and dQ (three products), or S, dP, dV and dK (four)
    shape, ops = (8, 5, 8192, 8192, 64), 2 * 40 * 8192**2 * 64
    assert tools.bound_ms("flash_bwd_dq", shape) == (pytest.approx(3 * ops / tools.PEAK_BF16 * 1e3), "operations")
    assert tools.bound_ms("flash_bwd_dkv", shape) == (pytest.approx(4 * ops / tools.PEAK_BF16 * 1e3), "operations")
    nbytes, _ = tools.site_cost("flash_bwd_dkv", shape)
    assert nbytes == 2 * 40 * 64 * 4 * 8192 + 8 * 40 * 8192 + 4 * 40 * 8192 * 64


def test_ptxas_report_reads_each_instantiation():
    """``chip_smoke.py`` phase 1 reads ptxas's report from the build log: one
    line per template instantiation of the named kernel, with its stack,
    spills, registers and barriers, and nothing of other kernels."""
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_116flash_fwd_kernelILi64EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN2lr12_GLOBAL__N_116flash_fwd_kernelILi64EEEv14CUtensorMap_st",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_114conv3x3_kernelILi80EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 72 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_116flash_fwd_kernelILi128EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 162 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_119flash_bwd_dq_kernelILi64EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_120flash_bwd_dkv_kernelILi128EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 224 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 200 registers, used 16 barriers",
    ])
    assert chip_smoke.ptxas_report(log, "flash_fwd_kernel") == [
        "flash_fwd_kernel<64>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 168 registers, used 16 barriers;",
        "flash_fwd_kernel<128>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 162 registers, used 16 barriers;",
    ]
    assert chip_smoke.ptxas_report(log, "conv3x3_kernel") == [
        "conv3x3_kernel<80>: 8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads; "
        "Used 72 registers, used 2 barriers;"]
    assert chip_smoke.ptxas_report(log, "flash_bwd_dq_kernel") == [
        "flash_bwd_dq_kernel<64>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 154 registers, used 16 barriers;",
        "flash_bwd_dq_kernel<128>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 200 registers, used 16 barriers;",
    ]
    assert chip_smoke.ptxas_report(log, "flash_bwd_dkv_kernel") == [
        "flash_bwd_dkv_kernel<128>: 16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads; "
        "Used 224 registers, used 16 barriers;"]


@pytest.mark.parametrize("views,per_step", [(None, tools.PER_TRAIN_STEP), (4, tools.PER_TRAIN_STEP_MV4)])
def test_library_baselines_train_walks_every_backward_site(views, per_step):
    """``library_baselines --train [--multiview 4]`` times the flash
    backward at each shape of one train step once: its sites' launches add up
    to the step's dq and dk/dv launches, the 8192-token (V=4: 16384) site
    among them; another view count is refused before anything runs."""
    from leftrefill_torch.tools.library_baselines import train_sites

    sites = train_sites(views)
    shapes = [shape for shape, _ in sites]
    assert len(set(shapes)) == len(shapes) == (3 if views is None else 4)
    assert sum(n for _, n in sites) == per_step["flash_bwd_dq"] == per_step["flash_bwd_dkv"]
    assert max(shape[2] for shape in shapes) == (8192 if views is None else 16384)
    assert all(nq % 64 == 0 and nk % 64 == 0 and d == 64 for _, _, nq, nk, d in shapes)
    with pytest.raises(SystemExit):
        train_sites(2)
