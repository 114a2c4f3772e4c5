"""Where the time of the serving and evaluation entry points goes, on one
CUDA GPU and its host.

    python -m leftrefill_torch.tools.profile_eval [--pairs 4] [--steps 50] [--json PATH]

The model is ``configs/ref_inpainting.yaml`` through
``serving.gradio_app.initialize_model`` (random weights, bf16); the images
are the fixtures of ``tests/fixtures/jpeg``: the 1600x1200 4:2:0 photo (the
size of a MegaDepth or camera photo) and the 160x120 ones.  It prints, and
writes to PATH as one JSON object:

1. the host's JPEG reader, through the native image layer and through the
   plain Python/numpy versions (``native.plain_image_ops``), in the same
   call: seconds to decode the photo (median of 3), and to build one
   ``TestInpaintingDataset`` item at 512 from a pair of them (two decodes,
   two area resizes, the mask), on one thread, with the host CPU's model
   name;
2. ``predict`` at 512 (DDIM-50, eta 1, CFG 2.5) on the photo pair and the
   palette mask: seconds per request (median of 3 after a warm-up), of
   which the host's canvas (``request_canvas``: resize, mask, stitch);
3. ``cli.test`` over ``--pairs`` pair directories (batch 1, DDIM
   ``--steps``, test_size 512), once with the photos as source and target
   and once with the 160x120 JPEGs: per batch the seconds from one
   batch's sampling to the next (median over the batches after the
   first), the sampling alone (``log_images``, synchronised) and the rest
   (metrics, PNGs, waiting for the loader, whose 4 threads decode beside
   the sampling loop).  The photo run's extra seconds per batch are what
   the decode costs the evaluation beyond what the loader hides.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures" / "jpeg"


def _median_seconds(fn, n: int = 3) -> float:
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def _write_pairs(root: Path, n: int, source: str, target: str) -> Path:
    for i in range(n):
        d = root / f"{i:04d}"
        d.mkdir(parents=True)
        shutil.copy(FIXTURES / source, d / "source.jpg")
        shutil.copy(FIXTURES / target, d / "target.jpg")
        shutil.copy(FIXTURES / "mask_palette.png", d / "mask.png")
    return root


def _cli_test(exp: Path, pairs: Path, out: Path, steps: int, n: int) -> dict:
    """cli.test over the pairs with ``log_images`` timed: per-batch seconds."""
    from leftrefill_torch import tasks
    from leftrefill_torch.cli import test as cli

    spans = []
    original = tasks.RefInpaintTask.log_images

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        log = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter()))
        return log

    tasks.RefInpaintTask.log_images = timed
    try:
        cli.main(["--model_path", str(exp), "--test_path", str(pairs), "--test_size", "512", "--ddim_steps",
                  str(steps), "--limit", str(n), "--output_path", str(out / "out"), "--metric_output",
                  str(out / "metrics")])
    finally:
        tasks.RefInpaintTask.log_images = original
    starts = [s for s, _ in spans]
    per_batch = [b - a for a, b in zip(starts, starts[1:])]
    sampling = [e - s for s, e in spans[1:]]
    return {"batches": len(spans), "seconds_per_batch": statistics.median(per_batch),
            "sampling_seconds": statistics.median(sampling),
            "rest_seconds": statistics.median(p - s for p, s in zip(per_batch, sampling))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval measures the card: CUDA is not available")
    from leftrefill_torch import tools
    from leftrefill_torch.data import native
    from leftrefill_torch.data.datasets import TestInpaintingDataset
    from leftrefill_torch.data.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE, imread
    from leftrefill_torch.serving import gradio_app

    report = {"card": tools.card_line(), "device": torch.cuda.get_device_name(0), "host_cpu": tools.host_cpu()}
    print(report["card"], "| host", report["host_cpu"], flush=True)
    photo = str(FIXTURES / "photo_1600x1200_420.jpg")
    root = Path(tempfile.mkdtemp(prefix="profile_eval_"))
    try:
        photos = _write_pairs(root / "photos", args.pairs, "photo_1600x1200_420.jpg", "photo_1600x1200_420.jpg")
        small = _write_pairs(root / "small", args.pairs, "baseline_420.jpg", "progressive_420.jpg")
        ds = TestInpaintingDataset(str(photos), img_size=512)
        for impl in ("native", "plain"):
            with native.plain_image_ops() if impl == "plain" else contextlib.nullcontext():
                report[f"jpeg_decode_seconds_1600x1200_420_{impl}"] = _median_seconds(
                    lambda: imread(photo, IMREAD_COLOR))
                report[f"dataset_item_seconds_photo_pair_512_{impl}"] = _median_seconds(lambda: ds[0])
            print(f"host, {impl}: decode {report[f'jpeg_decode_seconds_1600x1200_420_{impl}']:.4f} s a 1600x1200 "
                  f"photo, {report[f'dataset_item_seconds_photo_pair_512_{impl}']:.4f} s a dataset item of two",
                  flush=True)

        exp = root / "exp"
        exp.mkdir()
        shutil.copy(REPO / "configs" / "ref_inpainting.yaml", exp / "model_config.yaml")
        pipe = gradio_app.initialize_model(str(exp))
        ref, src = imread(photo, IMREAD_COLOR), imread(photo, IMREAD_COLOR)
        mask = imread(str(FIXTURES / "mask_palette.png"), IMREAD_GRAYSCALE)
        request = dict(ddim_steps=50, num_samples=1, scale=2.5, seed=0, img_size=512)
        gradio_app.predict(pipe, ref, src, mask, **request)  # warm-up
        report["predict_seconds_ddim50_512"] = _median_seconds(lambda: gradio_app.predict(pipe, ref, src, mask,
                                                                                          **request))
        report["predict_canvas_seconds"] = _median_seconds(lambda: gradio_app.request_canvas(ref, src, mask))
        print(f"predict 512 DDIM-50 bf16: {report['predict_seconds_ddim50_512']:.3f} s a request, of which "
              f"{report['predict_canvas_seconds']:.4f} s the host's canvas", flush=True)
        del pipe
        torch.cuda.empty_cache()

        for name, pairs in (("photos_1600x1200", photos), ("small_160x120", small)):
            report[f"cli_test_{name}"] = _cli_test(exp, pairs, root / name, args.steps, args.pairs)
            print(f"cli.test {name} DDIM-{args.steps}: {report[f'cli_test_{name}']}", flush=True)
        extra = (report["cli_test_photos_1600x1200"]["seconds_per_batch"]
                 - report["cli_test_small_160x120"]["seconds_per_batch"])
        report["photo_extra_seconds_per_batch"] = extra
        print(f"the photos cost {extra:.3f} s a batch beyond the small JPEGs", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
