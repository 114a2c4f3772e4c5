"""The evaluation CLI (counterpart of ``leftrefill_tpu/cli/test.py``): the
test pairs through the model, PSNR, SSIM and, given LPIPS weights, LPIPS of
the prediction composited into the hole of the target half, on the card
unless given ``--device cpu``:

    python -m leftrefill_torch.cli.test --model_path check_points/run1 --exp_name run1 --test_path data/masked_pairs

JAX's flags: the model of ``<model_path>/model_config.yaml`` with random
weights (seeded ``--seed``), the SD checkpoint ``--sd_ckpt`` over them and
the best (or last) checkpoint of ``<model_path>/ckpts`` restored
(``serving.gradio_app.load_experiment``: bf16 on the card, fp32 on the
CPU); the pair
directories of ``--test_path`` (``TestInpaintingDataset``; ``--multiview``:
``InpaintingMultiViewDataset`` in test mode, its views flattened) batched on
a threaded loader; each batch sampled with DDIM (``--ddim_steps``, ``--eta``,
CFG ``--cfg``) from ``torch.Generator(device).manual_seed(seed + batch
index)`` (``--manual_pairs_x4``: each sample four times; ``--limit``: that
many batches); an area resize to ``--metric_size`` before the metrics; a
grid PNG per batch (masked, predicted and target canvases; with
``--multiview`` a strip of each reference view too) or, with
``--save_single``, one PNG per composited target under
``<output_path>/<exp>_<test_size>``; the means over the views with a hole
(not the multi-view references, which JAX's means include) in
``<metric_output>/<exp>_<test_size>.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Config")
    p.add_argument("--model_path", required=True, type=str, help="experiment dir with model_config.yaml + ckpts/")
    p.add_argument("--exp_name", default=None, type=str)
    p.add_argument("--test_path", default="data/masked_pairs", type=str)
    p.add_argument("--mask_path", default=None, type=str)
    p.add_argument("--sd_ckpt", default=None, type=str, help="frozen SD weights (torch ckpt)")
    p.add_argument("--cfg", default=2.5, type=float)
    p.add_argument("--eta", default=1.0, type=float)
    p.add_argument("--ddim_steps", default=50, type=int)
    p.add_argument("--test_size", default=512, type=int)
    p.add_argument("--metric_size", default=512, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--limit", default=0, type=int, help="cap #batches (0 = all)")
    p.add_argument("--manual_pairs_x4", action="store_true", help="run each sample 4x")
    p.add_argument("--save_single", action="store_true")
    p.add_argument("--multiview", action="store_true")
    p.add_argument("--output_path", default="./outputs", type=str)
    p.add_argument("--metric_output", default="./metric_outputs", type=str)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--lpips_weights", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return p.parse_args(argv)


def area_resize(images: np.ndarray, scale: float) -> np.ndarray:
    """Each [H, W(, C)] float32 image area-resized by ``scale`` on both axes
    (``cv2.resize(im, None, fx=scale, fy=scale, interpolation=INTER_AREA)``,
    whose size is the rounded scaled one)."""
    from leftrefill_torch.data.image_io import INTER_AREA, resize

    h, w = images.shape[1:3]
    size = (int(round(w * scale)), int(round(h * scale)))
    return np.stack([resize(im, size, INTER_AREA) for im in images])


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from leftrefill_torch.data.datasets import InpaintingMultiViewDataset, TestInpaintingDataset
    from leftrefill_torch.data.image_io import write_png
    from leftrefill_torch.data.loader import DataLoader, flatten_views
    from leftrefill_torch.eval.metrics import composite_metrics
    from leftrefill_torch.pipeline import request_device
    from leftrefill_torch.serving.gradio_app import load_experiment
    from leftrefill_torch.train.logger import to_uint8

    dev = request_device(args.device)
    task = load_experiment(args.model_path, args.sd_ckpt, seed=args.seed, device=dev)
    bundle, dc = task.bundle, task.bundle.data_config

    ds_kwargs = dict(img_size=args.test_size, token_map=dc.get("token_map"),
                     repeat_sp_token=dc.get("repeat_sp_token", 0), sp_token=dc.get("sp_token"))
    if args.multiview:
        dataset = InpaintingMultiViewDataset(
            image_path=args.test_path, pair_path=None, mask_path=args.mask_path, mode="test",
            view_num=dc.get("view_num", 4), view_token_len=dc.get("view_token_len", 30), **ds_kwargs)
    else:
        dataset = TestInpaintingDataset(root_path=args.test_path, mask_path=args.mask_path, **ds_kwargs)
    loader = DataLoader(dataset, args.batch_size, tokenizer=bundle.tokenizer, drop_last=False, num_workers=4)

    lpips_fn = None
    if args.lpips_weights:
        from leftrefill_torch.eval.lpips import LPIPS, load_lpips_weights

        lp = LPIPS().to(dev).eval()
        lp.load_state_dict(load_lpips_weights(args.lpips_weights))

        def lpips_fn(a, b):
            with torch.inference_mode():
                return lp(a, b)

    exp = args.exp_name or os.path.basename(args.model_path.rstrip("/"))
    out_dir = os.path.join(args.output_path, f"{exp}_{args.test_size}")
    os.makedirs(out_dir, exist_ok=True)

    psnr, ssim, lpips_vals = [], [], []
    for bi, batch in enumerate(loader):
        if args.multiview and batch["image"].ndim == 5:
            batch = flatten_views(batch)
        if args.manual_pairs_x4:
            batch = {k: np.repeat(v, 4, axis=0) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
        log = task.log_images(batch=batch, ddim_steps=args.ddim_steps, ddim_eta=args.eta,
                              unconditional_guidance_scale=args.cfg,
                              generator=torch.Generator(dev).manual_seed(args.seed + bi))
        reference_views = log.pop("reference", None)
        pred = log["pred"].float().cpu().numpy()
        pred = pred.reshape(-1, *pred.shape[-3:])
        origin = log["origin_image"].float().cpu().numpy().reshape(pred.shape)
        mask = log["mask"].float().cpu().numpy().reshape(pred.shape[:-1] + (1,))
        masked = log["masked_image"].float().cpu().numpy().reshape(pred.shape)
        if args.metric_size < args.test_size:  # area-downsample before the metrics (and the grid)
            scale = args.metric_size / args.test_size
            pred, origin, masked = area_resize(pred, scale), area_resize(origin, scale), area_resize(masked, scale)
            mask = area_resize(mask[..., 0], scale)[..., None]
        m = composite_metrics(*(torch.as_tensor(x, device=dev) for x in (pred, origin, mask)))
        # only views with a hole are scored: the multi-view references have none and would composite to
        # their target exactly (PSNR at its 120 dB clamp), which JAX's evaluation averages in
        scored = torch.as_tensor((mask > 0).reshape(mask.shape[0], -1).any(axis=1), device=dev)
        psnr.extend(m["psnr"][scored].tolist())
        ssim.extend(m["ssim"][scored].tolist())
        comp = m["composite"]
        if lpips_fn is not None:  # the target cropped as composite_metrics crops it (JAX's crops square views too)
            h, w = origin.shape[1:3]
            origin_r = torch.as_tensor(origin[:, :, w // 2:] if w != h else origin, device=dev)
            lpips_vals.extend(lpips_fn(comp[scored], origin_r[scored]).tolist())
        comp = comp.cpu().numpy()

        if args.save_single:
            for i in range(comp.shape[0]):
                write_png(os.path.join(out_dir, f"{bi:06}_{i}.png"), to_uint8(comp[i]))
        else:
            rows = [np.concatenate([to_uint8(masked[i]), to_uint8(pred[i]), to_uint8(origin[i])], axis=0)
                    for i in range(pred.shape[0])]
            write_png(os.path.join(out_dir, f"{bi:06}.png"), np.concatenate(rows, axis=1))
            if reference_views is not None:  # a strip of each reference view over the batch's scenes
                ref = reference_views.float().cpu().numpy()
                for idx in range(ref.shape[1]):
                    strip = np.concatenate([to_uint8(r) for r in ref[:, idx]], axis=0)
                    write_png(os.path.join(out_dir, f"{bi:06}_ref{idx}.png"), strip)
        if args.limit and bi + 1 >= args.limit:
            break

    print("EXP:", exp)
    print("PSNR:", float(np.mean(psnr)))
    print("SSIM:", float(np.mean(ssim)))
    if lpips_vals:
        print("LPIPS:", float(np.mean(lpips_vals)))
    os.makedirs(args.metric_output, exist_ok=True)
    with open(os.path.join(args.metric_output, f"{exp}_{args.test_size}.txt"), "w") as w:
        w.write("PSNR:" + str(np.mean(psnr)) + "\n")
        w.write("SSIM:" + str(np.mean(ssim)) + "\n")
        if lpips_vals:
            w.write("LPIPS:" + str(np.mean(lpips_vals)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
