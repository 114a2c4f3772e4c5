"""The measurement helpers shared by ``chip_smoke.py`` and the profiling
scripts: the launch counts per forward and per train step they check equal
the port's dispatch at full width (on torch's ``meta`` device), and the bound of a kernel site
is the larger of its bytes over the memory rate and its operations over the
tensor-core peak."""

from collections import Counter
from pathlib import Path

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
    assert set(expected) == set(tools.LAUNCH_COUNTERS) == set(tools.KERNEL_FNS)
    assert set(kernels.NAMES) == set(tools.LAUNCH_COUNTERS) - set(tools.PROBES)


@pytest.mark.parametrize("path", ["bf16", "multiview_v4"])
def test_task_sampling_forward_counts_match_the_pinned_counts(monkeypatch, path):
    """The evaluation CLI samples through ``RefInpaintTask.log_images``,
    whose UNet forward has neither the cross-attention K/V cache nor the
    shared CFG prefix: its kernel sites per forward are still
    ``tools.PER_FORWARD_BF16`` (``PER_FORWARD_MV4`` at V=4), the counts
    ``chip_smoke.py`` phase 11e holds it to."""
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    mv = path == "multiview_v4"
    rows, hw = (8, (64, 64)) if mv else (2, (64, 128))
    with torch.device("meta"):
        unet = MultiViewUnetModel(view_num=4, dtype=torch.bfloat16) if mv else UNetModel(dtype=torch.bfloat16)
        x, ts, ctx = torch.empty(rows, *hw, 9), torch.empty(rows, dtype=torch.long), torch.empty(rows, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        unet(x, ts, ctx)
    expected = tools.PER_FORWARD_MV4 if mv else tools.PER_FORWARD_BF16
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in expected.items() if v})


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


def test_per_train_step_nvs_counts_match_the_dispatch(monkeypatch):
    """The novel-view-synthesis train step at full width on ``meta``, as
    the training CLI runs it (``configs/novel_view_synthesis.yaml`` with
    LoRA rank 16 and the refinement branch, batch 16 of 256x512 canvases,
    the LoRA pack through ``compute_loss`` with the task's conditioning):
    its kernel sites, forward and backward, are ``tools.PER_TRAIN_STEP_NVS``
    and the backward kernels' by shape ``tools.TRAIN_SITES_NVS``; every
    trainable parameter gets a gradient."""
    from leftrefill_torch.config import build_model_from_config, load_yaml
    from leftrefill_torch.models.lora import default_target, init_lora
    from leftrefill_torch.tasks import build_task
    from leftrefill_torch.train import compute_loss, create_train_state, lora_predicate, wrap_lora_params
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    cfg = load_yaml(str(Path(__file__).resolve().parent.parent / "configs" / "novel_view_synthesis.yaml"))
    cfg["model"]["params"]["lora"]["do_lora"] = True
    cfg["model"]["params"]["refinement_config"]["use_input_refinement"] = True
    bundle = build_model_from_config(cfg, device="meta")
    task = build_task(bundle, "meta")
    with torch.device("meta"):
        model = wrap_lora_params(bundle.model, init_lora(bundle.model.unet, rank=16, target=default_target))
        b = 16
        batch = {"image": torch.empty(b, 256, 512, 3), "mask": torch.empty(b, 256, 512, 1),
                 "masked_image": torch.empty(b, 256, 512, 3), "tokens": torch.zeros(b, 77, dtype=torch.long),
                 "rel_pose": torch.empty(b, 4)}
        draws = dict(t=torch.zeros(b, dtype=torch.long), noise=torch.empty(b, 32, 64, 4, dtype=torch.bfloat16),
                     vae_noise=torch.empty(b, 32, 64, 4), cfg_draws=torch.empty(b))
    create_train_state(model, predicate=lora_predicate(nvs_prompt_filter))
    with kernels.record_sites() as sites:
        compute_loss(model, batch, cond_builder=task.cond_builder, **draws)[0].backward()
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in tools.PER_TRAIN_STEP_NVS.items() if v})
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert Counter(shape for n, shape in sites if n == name) == Counter(tools.TRAIN_SITES_NVS)
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)


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
    # the GEGLUs' up kernels (no template argument) and down kernels, bf16 and
    # int8: each name reads its own entries only
    geglu = "\n".join([
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_115geglu_up_kernelE14CUtensorMap_st' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_117geglu_down_kernelILi160EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_120geglu_int8_up_kernelE14CUtensorMap_st'"
        " for 'sm_90a'",
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 166 registers, used 3 barriers",
        "ptxas info    : Compiling entry function '_ZN2lr12_GLOBAL__N_122geglu_int8_down_kernelILi64EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 120 registers, used 2 barriers",
    ])
    assert chip_smoke.ptxas_report(geglu, "geglu_up_kernel") == [
        "geglu_up_kernel<>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 168 registers, used 3 barriers;"]
    assert chip_smoke.ptxas_report(geglu, "geglu_down_kernel") == [
        "geglu_down_kernel<160>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 168 registers, used 2 barriers;"]
    assert chip_smoke.ptxas_report(geglu, "geglu_int8_up_kernel") == [
        "geglu_int8_up_kernel<>: 8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 166 registers, used 3 barriers;"]
    assert chip_smoke.ptxas_report(geglu, "geglu_int8_down_kernel") == [
        "geglu_int8_down_kernel<64>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 120 registers, used 2 barriers;"]


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


# the GEGLU paths of library_baselines --geglu: (views, train, int8) -> the
# dispatch they stand for on meta
GEGLU_PATHS = {"forward": (None, False, False), "forward_mv4": (4, False, False), "train": (None, True, False),
               "train_mv4": (4, True, False), "int8": (None, False, True)}


def _geglu_dispatch(path: str) -> Counter:
    """(kernel, shape) of every GEGLU site the port dispatches on one pass
    of ``path`` at full width, on torch's ``meta`` device."""
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel

    views, train, int8 = GEGLU_PATHS[path]
    rows, hw = ((4 if train else 8), (64, 64)) if views else ((8 if train else 2), (64, 128))
    with torch.device("meta"):
        unet = (MultiViewUnetModel(view_num=4, dtype=torch.bfloat16, remat=train) if views
                else UNetModel(dtype=torch.bfloat16, quant=int8, remat=train))
        x, ts = torch.empty(rows, *hw, 9), torch.empty(rows, dtype=torch.long)
        ctx = torch.empty(rows, 77, 1024, requires_grad=train)
    if train:
        unet.requires_grad_(False)
        with kernels.record_sites() as sites:
            unet(x, ts, ctx).float().sum().backward()
    else:
        with torch.no_grad(), kernels.record_sites() as sites:
            unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=not views)
    return Counter(s for s in sites if s[0].startswith("geglu"))


@pytest.mark.parametrize("path", sorted(GEGLU_PATHS))
def test_library_baselines_geglu_walks_every_site(monkeypatch, path):
    """``library_baselines --geglu`` times K3 (or KI3) at each GEGLU shape of
    the path once: its sites are the port's dispatch on ``meta`` shape for
    shape, 16 a forward and 32 a train step (forward and remat recompute);
    a path the script does not know is refused before anything runs."""
    from leftrefill_torch.tools.library_baselines import geglu_sites

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    views, train, int8 = GEGLU_PATHS[path]
    sites = geglu_sites(views, train, int8)
    name = "geglu_int8" if int8 else "geglu"
    assert Counter({(name, shape): n for shape, n in sites}) == _geglu_dispatch(path)
    assert sum(n for _, n in sites) == (tools.PER_TRAIN_STEP if train else tools.PER_FORWARD_BF16)["geglu"]
    for bad in ((2, False, False), (4, False, True), (None, True, True)):
        with pytest.raises(SystemExit):
            geglu_sites(*bad)


def test_geglu_yardsticks():
    """The GEGLU yardsticks of ``library_fn`` (``tools.COMPOSED``): K3's
    cuBLAS composition computes K3's function within rel L2 1e-2 of
    ``geglu_plain`` (bf16 biases and products: the same work, not the same
    values), and ``library_baselines`` falls back to the same composition."""
    from leftrefill_torch.ops import mlp
    from leftrefill_torch.tools import library_baselines

    gen = torch.Generator().manual_seed(0)
    r, din, inner, dout = 128, 64, 256, 64
    args = (torch.randn(r, din, generator=gen).to(torch.bfloat16),
            (torch.randn(2 * inner, din, generator=gen) * din**-0.5).to(torch.bfloat16),
            torch.randn(2 * inner, generator=gen) * 0.1,
            (torch.randn(dout, inner, generator=gen) * inner**-0.5).to(torch.bfloat16),
            torch.randn(dout, generator=gen) * 0.1)
    assert set(tools.COMPOSED) == {"geglu", "geglu_int8", "conv3x3_int8", "dense_int8_res"}
    ref = mlp.geglu_plain(*args)
    for fn in (tools.library_fn("geglu", args), library_baselines.geglu_yardstick("geglu", args)):
        out = fn()
        assert out.dtype == torch.bfloat16 and out.shape == (r, dout)
        assert tools.rel_l2(out, ref) < 1e-2
    assert tools.library_fn("ln_quant", args) is None  # no call computes a fused normalize-and-quantize


def test_conv_int8_yardstick_has_the_kernels_product():
    """KI1's yardstick (``tools.library_fn``, and ``library_baselines``'s
    own copy of it for an earlier tree) is the ``torch._int_mm`` product of
    KI1's M = B H W, N = Co and K = 9 Ci on the int8 im2col: its int32 sums
    are the plain version's accumulators (the epilogue left out)."""
    from leftrefill_torch.ops import quant
    from leftrefill_torch.tools import library_baselines

    gen = torch.Generator().manual_seed(0)
    b, h, w, ci, co = 2, 4, 8, 32, 24
    xq = torch.randint(-127, 128, (b, h, w, ci), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (co, 3, 3, ci), generator=gen, dtype=torch.int8)
    ones, zeros = torch.ones(co), torch.zeros(co)
    cols, wmat = tools.conv3x3_int8_operands(xq, wq)
    assert cols.shape == (b * h * w, 9 * ci) and wmat.shape == (co, 9 * ci)
    acc = quant.conv3x3_int8_plain(xq, ones, wq, zeros, torch.float32).reshape(b * h * w, co)
    site = (xq, ones, wq, zeros)
    for fn in (tools.library_fn("conv3x3_int8", site), library_baselines.conv_int8_yardstick(site)):
        out = fn()
        assert out.dtype == torch.int32 and out.shape == (b * h * w, co)
        assert torch.equal(out.float(), acc)


def test_dense_int8_yardstick_has_the_kernels_product():
    """KI2's yardstick (``tools.library_fn``, and ``library_baselines``'s
    own copy of it for an earlier tree) is the ``torch._int_mm`` product
    [R, K] x [K, N] of the kernel's operands: the plain version's int32
    accumulators (the dequant, bias and residual left out)."""
    from leftrefill_torch.ops import quant
    from leftrefill_torch.tools import library_baselines

    gen = torch.Generator().manual_seed(0)
    r, k, n = 48, 64, 40
    xq = torch.randint(-127, 128, (r, k), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    site = (xq, torch.ones(r, 1), wq, torch.ones(n), torch.zeros(n), torch.zeros(r, n, dtype=torch.bfloat16))
    acc = quant.int_mm(xq, wq)
    for fn in (tools.library_fn("dense_int8_res", site), library_baselines.dense_int8_yardstick(site)):
        out = fn()
        assert out.dtype == torch.int32 and out.shape == (r, n)
        assert torch.equal(out, acc)


# off-path KI2 shapes: rows not a multiple of any tile, with a 64-byte K
# tail, or with K split over a 2-block cluster
DENSE_RAGGED, DENSE_SPLIT = (1000, 320, 640), (200, 1280, 640)


def test_dense_int8_plan_mirror_at_every_site():
    """``quant.dense_int8_res_plan``, the Python mirror of KI2's launcher,
    at the 11 KI2 sites of a fused int8 forward and a ragged shape on 132
    SMs: tiles x splits within one wave, a cluster of 1 or 2 blocks that
    is the grid's K split with at least 2 K steps a split, 128- or 64-row
    tiles whose columns divide N, a grid that covers the output, shared
    memory within an H100 block's; no UNet site splits K (64-row tiles at
    1024 and 256 rows), a shape with fewer tiles does (one launch: no
    partials)."""
    from leftrefill_torch.ops import mlp, quant
    from leftrefill_torch.tools.library_baselines import int8_sites

    shapes = [shape for (name, shape), _ in int8_sites(False) if name == "dense_int8_res"]
    assert sorted(shapes) == [(256, 1280, 1280), (1024, 1280, 1280), (4096, 640, 640)]
    plans = {}
    for r, k, n in [*shapes, DENSE_RAGGED, DENSE_SPLIT]:
        plan = quant.dense_int8_res_plan(r, k, n, 132)
        (bm, bn), s = plan["tile"], plan["splits"]
        assert bm in (128, 64) and bn in (160, 128, 64) and n % bn == 0
        assert s in (1, 2) and plan["cluster"] == (1, 1, s) and plan["grid"] == (-(-r // bm), n // bn, s)
        assert -(-k // 128) >= 2 * s or s == 1
        assert plan["grid"][0] * plan["grid"][1] * s <= 132
        assert plan["smem"] == quant.dense_int8_res_smem(bm, bn) <= mlp.SMEM_LIMIT
        plans[(r, k, n)] = (bm, bn, s)
    assert plans[(4096, 640, 640)] == (128, 160, 1)
    assert plans[(1024, 1280, 1280)] == (64, 160, 1)
    assert plans[(256, 1280, 1280)] == (64, 64, 1)
    assert DENSE_RAGGED[0] % plans[DENSE_RAGGED][0]
    # the 2-block split where the tiles are fewer still: 4 row tiles of 64 x 64 by 10 column tiles
    assert plans[DENSE_SPLIT] == (64, 64, 2) and DENSE_SPLIT[0] % 64


def _int8_dispatch(unfused: bool) -> Counter:
    """(kernel, shape) of every int8 kernel site (KI1, KI2, K4, K7, K8) the
    port dispatches in one full-width CFG-doubled int8 forward on ``meta``."""
    from leftrefill_torch.models.unet import UNetModel

    with torch.device("meta"):
        unet = UNetModel(dtype=torch.bfloat16, quant=True, fused=not unfused)
        x, ts, ctx = torch.empty(2, 64, 128, 9), torch.empty(2, dtype=torch.long), torch.empty(2, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=True)
    return Counter(s for s in sites if s[0] not in ("flash_fwd", "geglu_int8"))


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
def test_library_baselines_int8_walks_every_site(monkeypatch, unfused):
    """``library_baselines --int8 [--unfused]`` times each int8 kernel at each
    shape of the int8 forward once: its sites are the port's dispatch on
    ``meta`` shape for shape, 47 KI1, 11 KI2 and (fused) 44 K4, 48 K7 and 16
    K8 a forward; ``--unfused`` goes with ``--int8`` alone."""
    import sys

    from leftrefill_torch.tools import library_baselines

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    sites = library_baselines.int8_sites(unfused)
    assert Counter(dict(sites)) == _int8_dispatch(unfused)
    per_forward = tools.PER_FORWARD_INT8_UNFUSED if unfused else tools.PER_FORWARD_INT8
    counted = Counter()
    for (name, _), n in sites:
        counted[name] += n
    assert counted == Counter({k: v for k, v in per_forward.items() if v and k not in ("flash_fwd", "geglu_int8")})
    monkeypatch.setattr(sys, "argv", ["library_baselines", "--unfused"])
    with pytest.raises(SystemExit):
        library_baselines.main()


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
def test_conv_int8_plan_mirror_at_every_site(unfused):
    """``quant.conv3x3_int8_plan``, the Python mirror of KI1's launcher, at
    every KI1 site of the int8 forward on 132 SMs: shared memory within an
    H100 block's, a cluster of at most 4 blocks that is the grid's K split, each split at least 4 K steps, 128-pixel patches
    and channel tiles that cover the image and Co, and at least 64 blocks
    at every level (64 at 8x16, where 8-block clusters took twice as long)."""
    from leftrefill_torch.ops import mlp, quant
    from leftrefill_torch.tools.library_baselines import int8_sites

    splits = {}
    for (name, shape), _ in int8_sites(unfused):
        if name != "conv3x3_int8":
            continue
        b, h, w, ci, co = shape
        plan = quant.conv3x3_int8_plan(b, h, w, ci, co, 132)
        rows, cols = plan["patch"]
        bn, s = plan["tile"][1], plan["splits"]
        assert plan["smem"] <= mlp.SMEM_LIMIT and plan["tile"][0] == rows * cols == 128
        assert plan["cluster"] == (1, 1, s) and s in (1, 2, 4) and plan["grid"][2] == s
        assert s == 1 or 9 * -(-ci // 128) >= 4 * s
        assert bn in (160, 128, 64) and (co % bn == 0 or bn == 64)
        assert plan["grid"][0] == b * -(-h // rows) * -(-w // cols) and plan["grid"][1] * bn >= co
        assert cols >= min(w, 128) and plan["grid"][0] * plan["grid"][1] * s >= 64
        splits[(h, w)] = max(splits.get((h, w), 1), s)
    # the small levels split K over a cluster, the large ones do not
    assert splits == {(64, 128): 1, (32, 64): 1, (16, 32): 2, (8, 16): 4}


@pytest.mark.parametrize("path", sorted(GEGLU_PATHS))
def test_geglu_plan_mirror_at_every_site(path):
    """``mlp.geglu_plan``, the Python mirror of the ``.cu`` launchers, at
    every GEGLU site of the path on 132 SMs: both kernels' shared memory
    within an H100 block's, 128-row tiles, up blocks 128 inner columns wide
    (KI3's in clusters of chunk / 128 <= 8 blocks, the portable limit, that
    divide the inner tiles, and persistent: no fixed grid), down tiles of
    160, 128 or 64 columns that cover dout, and grids that cover the rows."""
    from leftrefill_torch.ops import mlp
    from leftrefill_torch.tools.library_baselines import geglu_sites

    for shape, _ in geglu_sites(*GEGLU_PATHS[path]):
        r, din, inner, dout = shape[:4]
        chunk = shape[4] if len(shape) > 4 else None
        plan = mlp.geglu_plan(r, din, inner, dout, 132, chunk=chunk)
        up, down = plan["up"], plan["down"]
        assert max(up["smem"], down["smem"]) <= mlp.SMEM_LIMIT
        assert up["tile"] == (128, 128) and up["items"] == inner // 128 * r // 128
        assert up["grid"] == ((inner // 128, r // 128) if chunk is None else None)  # KI3's: persistent
        assert up["cluster"] == (1 if chunk is None else chunk // 128) <= 8
        assert (inner // 128) % up["cluster"] == 0
        bn = down["tile"][1]
        assert down["tile"][0] == 128 and bn in (160, 128, 64) and dout % bn == 0
        assert down["grid"] == (dout // bn, r // 128) and down["cluster"] == 1
        assert down["items"] == dout // bn * r // 128
        assert mlp.down_tile(r, dout, 132) == bn
    # the levels that give the rows fewer blocks than SMs take narrower tiles
    assert mlp.down_tile(1024, 1280, 132) == 128 and mlp.down_tile(256, 1280, 132) == 64
    assert mlp.down_tile(16384, 320, 132) == 160


def test_profile_groups_match_the_kernel_names():
    """``profile_request`` files every kernel that ``csrc/`` declares under
    its own group: the GEGLUs' up and down kernels (with their template
    arguments, as the profiler names them) under K3 and KI3, none of them
    under another group, and nothing of K3 under KI3."""
    import re

    from leftrefill_torch.tools.profile_request import GROUPS

    def group(name):
        return next((g for g, pat in GROUPS if re.search(pat, name)), "other")

    declared = {}
    for src in kernels.CSRC.glob("*.cu"):
        for name in re.findall(r"__global__ void.*?\b(\w+_kernel)\s*\(", src.read_text(), re.S):
            declared[name] = src.stem
    geglu = {n: f for n, f in declared.items() if f.startswith("geglu")}
    assert set(geglu) == {"geglu_up_kernel", "geglu_down_kernel", "geglu_int8_up_kernel", "geglu_int8_down_kernel"}
    for name, stem in geglu.items():
        want = "KI3 geglu_int8" if "int8" in stem else "K3 geglu"
        assert group(f"void lr::(anonymous namespace)::{name}(CUtensorMap_st, CUtensorMap_st)") == want
        assert group(f"void lr::(anonymous namespace)::{name}<160>(CUtensorMap_st)") == want
    for name, stem in declared.items():
        assert group(f"void lr::(anonymous namespace)::{name}<true>(int)") != "other", name
    # KI1 (one kernel, templated on its tile and output type) under its own
    # group, never K2's or cuDNN's; K7 and K8 each under theirs
    assert declared["conv3x3_int8_kernel"] == "conv3x3_int8"
    for out in ("__nv_bfloat16", "float"):
        assert group(f"void lr::(anonymous namespace)::conv3x3_int8_kernel<160, {out}>(CUtensorMap_st)") == \
            "KI1 conv3x3_int8"
    assert declared["ln_quant_kernel"] == declared["gn_quant_kernel"] == "quant_prologue"
    assert group("void lr::(anonymous namespace)::ln_quant_kernel<8, 5>(__nv_bfloat16 const*)") == "K7 ln_quant"
    assert group("void lr::(anonymous namespace)::gn_quant_kernel<32, 5>(__nv_bfloat16 const*)") == "K8 gn_quant"
    assert {n for n, f in declared.items() if f == "quant_prologue"} == {
        "affine_silu_quant_kernel", "ln_quant_kernel", "gn_quant_kernel"}


def test_geglu_variants_apply_to_the_sources():
    """``tools/geglu_variants.py`` builds its timing-only variants by text
    replacements in ``csrc/``: each replaced text occurs exactly once in the
    sources as they stand (a stale variant is refused before any build), and
    each variant changes the file it names; every kernel has the kernels as
    built among its variants."""
    from leftrefill_torch.tools import geglu_variants as gv

    as_built = gv.variant_source("as built", [])
    for name, variants in gv.VARIANTS.items():
        assert variants["as built"] == []
        for variant, edits in variants.items():
            src = gv.variant_source(variant, edits)
            for fname, _, _ in edits:
                assert src[fname] != as_built[fname]
    with pytest.raises(SystemExit):
        gv.variant_source("stale", [("geglu.cu", "no such text", "")])


def test_conv_int8_variants_apply_to_the_sources():
    """``tools/conv_int8_variants.py`` builds KI1's timing-only variants by
    text replacements in ``csrc/``: each replaced text occurs exactly once
    in the sources as they stand and each variant changes
    ``conv3x3_int8.cu``; the K6 probe's slab applies at the levels where a
    consumer's 64 pixels lie in one patch row and K is not split (64x128,
    32x64), the split caps where K is split (16x32, 8x16)."""
    from leftrefill_torch.tools import conv_int8_variants as cv
    from leftrefill_torch.tools.geglu_variants import variant_source
    from leftrefill_torch.tools.library_baselines import int8_sites

    as_built = variant_source("as built", [])
    assert cv.VARIANTS["as built"][0] == []
    for name, (edits, _) in cv.VARIANTS.items():
        src = variant_source(name, edits)
        assert all(fname == "conv3x3_int8.cu" for fname, _, _ in edits)
        if edits:
            assert src["conv3x3_int8.cu"] != as_built["conv3x3_int8.cu"]
    shapes = [shape for (name, shape), _ in int8_sites(False) if name == "conv3x3_int8"]
    assert {s[1:3] for s in shapes if cv._slab_sites(s)} == {(64, 128), (32, 64)}
    assert {s[1:3] for s in shapes if cv._split_sites(s)} == {(16, 32), (8, 16)}


def test_int8_epilogue_variants_apply_to_the_sources():
    """``tools/int8_epilogue_variants.py`` builds KI2's and K4's timing-only
    variants by text replacements in ``csrc/``: each replaced text occurs
    exactly once in the sources as they stand, and each variant changes the
    file of the kernel it names (KI2 ``dense_int8_res.cu``, K4
    ``quant_prologue.cu``) and no other."""
    from leftrefill_torch.tools import int8_epilogue_variants as ev
    from leftrefill_torch.tools.geglu_variants import variant_source

    as_built = variant_source("as built", [])
    files = {"dense_int8_res": "dense_int8_res.cu", "affine_silu_quant": "quant_prologue.cu"}
    assert ev.VARIANTS["as built"] == (None, [])
    for name, (kernel, edits) in ev.VARIANTS.items():
        src = variant_source(name, edits)
        changed = {f for f in src if src[f] != as_built[f]}
        assert changed == (set() if kernel is None else {files[kernel]}), name
