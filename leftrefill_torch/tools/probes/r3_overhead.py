"""P5, the launch floor, and the non-kernel cells of ``scripts/tpu_r3_overhead.py``
on the card.

    python -m leftrefill_torch.tools.probes.r3_overhead [--json PATH]

The floor: P5 (o = x + 1 on an [8, 128] bf16 tile) in host µs a call
(back-to-back calls, nothing synchronised), device µs a launch
(``torch.profiler``), and a chain of 1000 launches (each on the last one's
output) timed with CUDA events, eagerly and captured once in a
``torch.cuda.CUDAGraph`` and replayed (the counterpart of the script's
one-``jit`` ``lax.scan`` chain, which kept host dispatch out: a measurement,
not a change to any serving path).  Then the script's other cells through
the port's modules at L0 (B 2, 64x128, 320 channels): GN32 + SiLU with the
fast and with the fp32 affine; quantize + dequantize; one ResBlock, int8
(JAX's default fused configuration, and unfused) and bf16; the int8 3x3 conv
alone with its activation quantize; and the full-width UNet forward at
batch 2 (CFG-doubled, the K/V cache on), int8 and bf16, random weights from
the seed.  Device ms (all the kernels a call launches) and CUDA-event ms
(with the host's gaps) each.
"""

from __future__ import annotations

import torch

from leftrefill_torch import tools
from leftrefill_torch.ops import layers, probes, quant
from leftrefill_torch.tools.library_baselines import host_us
from leftrefill_torch.tools.probes import emit, finish, randn, start, timed

CHAIN = 1000


def chain(x: torch.Tensor) -> torch.Tensor:
    for _ in range(CHAIN):
        x = probes.noop(x)
    return x


def built(make, quantized: bool, gen):
    """``make(dtype, quant)`` on the card in bf16 (int8 with ``quantized``),
    its fp32 weights drawn from ``gen`` (``pipeline.fill_random_``) and
    quantized per output channel as ``build_sd2_inpaint_bundle`` does."""
    from leftrefill_torch.pipeline import fill_random_

    with torch.device("meta"):
        fp, model = make(torch.float32, False), make(torch.bfloat16, quantized)
    fp, model = fp.to_empty(device="cuda"), model.to_empty(device="cuda")
    fill_random_(fp, gen)
    state = quant.quantize_params_like(model, fp.state_dict()) if quantized else fp.state_dict()
    model.load_state_dict(state, strict=True)
    return model.eval()


def both(rows: list, cell: str, fn, calls: int = 20, **extra) -> None:
    emit(rows, cell=cell, ms=timed(fn, calls=calls), event_ms=tools.cuda_ms(fn, calls), **extra)


def main() -> int:
    from leftrefill_torch.models.unet import ResBlock, UNetModel

    args, card, gen = start(__doc__)
    rows = []
    z = randn(gen, 8, 128)
    if not torch.equal(probes.noop(z), probes.noop_plain(z)):
        raise SystemExit("r3_overhead: P5 differs from its plain version")
    emit(rows, cell="floor: P5 host us a call", us=host_us(lambda: probes.noop(z), 1000))
    emit(rows, cell="floor: P5 device us a launch", us=timed(lambda: probes.noop(z), calls=200) * 1e3)
    eager = tools.cuda_ms(lambda: chain(z), 5) / CHAIN * 1e3
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(z)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(z)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, chain(z)):
        raise SystemExit("r3_overhead: the replayed chain differs from the eager one")
    emit(rows, cell=f"floor: chain of {CHAIN} P5 launches", eager_us_a_launch=eager,
         graph_us_a_launch=tools.cuda_ms(graph.replay, 10) / CHAIN * 1e3)
    del graph, out

    with torch.inference_mode():
        b, h, w, c = 2, 64, 128, 320
        x = randn(gen, b, h, w, c)
        gamma, beta = 1 + 0.1 * randn(gen, c, dtype=torch.float32), 0.1 * randn(gen, c, dtype=torch.float32)
        for label, fast in (("fast_affine", True), ("fp32 affine", False)):
            both(rows, f"GN32+silu L0 ({label})",
                 lambda: layers.group_norm32(x, gamma, beta, fast_affine=fast, silu=True), shape=[b, h, w, c])

        def qa():
            xq, s = quant.quantize_activation(x)
            return xq.to(torch.bfloat16) * s

        both(rows, "quantize+dequant L0", qa, shape=[b, h, w, c])
        emb = randn(gen, b, 1280)
        for label, q8, fused in (("int8", True, True), ("int8 unfused", True, False), ("bf16", False, True)):
            rb = built(lambda dt, qz: ResBlock(c, c, 1280, dtype=dt, quant=qz, fused=fused), q8, gen)
            both(rows, f"ResBlock L0 {label} end-to-end", lambda: rb(x, emb), shape=[b, h, w, c])
            del rb
        wq, ws = quant.quantize_weight(0.05 * randn(gen, c, 3, 3, c, dtype=torch.float32))
        bias = torch.zeros(c, device="cuda")
        both(rows, "conv3x3_int8 L0 isolated (incl quant)", lambda: quant.conv3x3_int8_apply(x, wq, ws, bias),
             shape=[b, h, w, c, c])

        xu, tu, ctx = tools.unet_inputs(gen)
        for label, q8 in (("int8", True), ("bf16", False)):
            unet = built(lambda dt, qz: UNetModel(dtype=dt, quant=qz), q8, gen)
            kv = unet.cross_kv(ctx)
            tools.reset_launches()
            unet(xu, tu, ctx, cross_kv=kv, cfg_dup=True)
            torch.cuda.synchronize()
            launches = {n: m for n, m in tools.launches().items() if m}
            both(rows, f"full UNet fwd b2 {label}", lambda: unet(xu, tu, ctx, cross_kv=kv, cfg_dup=True), calls=3,
                 shape=[2, 64, 128, 9], kernel_launches=launches)
            del unet, kv
    return finish(args, card, "scripts/tpu_r3_overhead.py", rows)


if __name__ == "__main__":
    raise SystemExit(main())
