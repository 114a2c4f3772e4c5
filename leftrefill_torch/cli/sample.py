"""One request from the command line (counterpart of
``leftrefill_tpu/cli/sample.py``): a reference, a target and its mask ->
the inpainted target, on the card unless given ``--device cpu``:

    python -m leftrefill_torch.cli.sample --model_path check_points/run1 \
        --reference ref.jpg --source src.jpg --mask mask.png --out out.png

The images are read as ``cv2.imread`` reads them (``data.image_io.imread``:
PNG or JPEG, the Exif orientation applied; the mask in grey) and the result
written as PNG (``--out`` must end in .png: the port has no JPEG writer).
With ``--num_samples`` above 1 the files are ``<out>_<i>.png``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True, help="experiment dir")
    p.add_argument("--reference", required=True)
    p.add_argument("--source", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--out", default="out.png")
    p.add_argument("--sd_ckpt", default=None)
    p.add_argument("--ddim_steps", default=50, type=int)
    p.add_argument("--sampler", default="ddim", choices=["ddim", "dpm++2m"],
                   help="dpm++2m with --ddim_steps 15 is the fast path")
    p.add_argument("--scale", default=2.5, type=float)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--num_samples", default=1, type=int)
    p.add_argument("--img_size", default=512, type=int)
    p.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.out.endswith(".png"):
        raise ValueError(f"--out {args.out}: the port writes PNG files only (it has no JPEG writer)")

    from leftrefill_torch.data.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE, imread, write_png
    from leftrefill_torch.serving.gradio_app import initialize_model, predict

    pipe = initialize_model(args.model_path, args.sd_ckpt, img_size=args.img_size, device=args.device)
    reference = imread(args.reference, IMREAD_COLOR)
    source = imread(args.source, IMREAD_COLOR)
    mask = imread(args.mask, IMREAD_GRAYSCALE)
    outs = predict(pipe, reference, source, mask, ddim_steps=args.ddim_steps, num_samples=args.num_samples,
                   scale=args.scale, seed=args.seed, img_size=args.img_size, sampler=args.sampler)
    for i, o in enumerate(outs):
        path = args.out if len(outs) == 1 else args.out[:-len(".png")] + f"_{i}.png"
        write_png(path, o)
        print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
