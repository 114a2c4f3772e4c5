"""The port's evaluation data and entry points on the CPU:

- the test-mode datasets (``TestInpaintingDataset``,
  ``InpaintingCrossViewDataset``, ``InpaintingMultiViewDataset`` with and
  without ``concat_target``, ``InpaintingDataset``) equal to the JAX
  package's items bit for bit, on pair directories the test writes with
  OpenCV (JPEG with and without Exif orientation, PNG, colour and palette
  masks, sizes that shrink and that enlarge), and their training modes
  refused;
- ``cli.sample`` and ``cli.test`` (1-reference, ``--save_single``,
  ``--metric_size``, ``--manual_pairs_x4``, LPIPS from a weights file, and
  ``--multiview`` with its reference strips) run with ``--device cpu`` at
  the tiny config of ``tests/test_cli.py`` to their PNGs and metrics file."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from test_cli import MODEL_YAML
from test_cli_variants import MV_MODEL_YAML

from leftrefill_torch.data import datasets as td, image_io as io


def _exif_jpeg(path, img, orientation: int) -> None:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])
    tiff = b"MM\x00\x2a\x00\x00\x00\x08" + struct.pack(">HHHIHH", 1, 0x112, 3, 1, orientation, 0) + b"\x00" * 4
    data = buf.tobytes()
    with open(path, "wb") as f:
        f.write(data[:2] + b"\xff\xe1" + struct.pack(">H", len(tiff) + 8) + b"Exif\x00\x00" + tiff + data[2:])


def _palette_mask(path, mask: np.ndarray) -> None:
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    h, w = mask.shape
    raw = b"".join(b"\x00" + r.tobytes() for r in np.packbits(mask.astype(np.uint8), axis=1))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 1, 3, 0, 0, 0))
                + chunk(b"PLTE", bytes([0, 0, 0, 200, 255, 90])) + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


def write_pairs(root, n: int = 3, seed: int = 0) -> str:
    """``n`` pair directories 0000.. under ``root/pairs``: source, target and
    three more sources (JPEG; PNG in the second; an Exif-turned JPEG target
    in the third) of odd sizes, and a mask (a colour PNG; a 1-bit palette
    PNG in the second) with values on both sides of 127."""
    rng = np.random.RandomState(seed)
    pairs = os.path.join(root, "pairs")
    for i in range(n):
        d = os.path.join(pairs, f"{i:04d}")
        os.makedirs(d)
        h, w = (40, 50) if i != 1 else (23, 19)
        for name in ("source", "target", "source_1", "source_2", "source_3"):
            img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (5, 5), 2)
            if i == 2 and name == "target":
                _exif_jpeg(os.path.join(d, name + ".jpg"), img, 6)
            else:
                cv2.imwrite(os.path.join(d, name + (".png" if i == 1 else ".jpg")), img)
        m = np.zeros((h, w), np.uint8)
        m[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 255
        m[: h // 4, : w // 5] = 100  # below the > 127 threshold, kept by TestInpaintingDataset's / 255
        if i == 1:
            _palette_mask(os.path.join(d, "mask.png"), m > 0)
        else:
            cv2.imwrite(os.path.join(d, "mask.png"), np.stack([m, m // 2, 255 - m], -1))
    return pairs


def _items_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


DS_KW = dict(token_map={"left_token": "<l>", "right_token": "<r>", "task_token": "<t>", "real_token": "<s>"},
             repeat_sp_token=4, sp_token="<special-token>")


@pytest.mark.parametrize("img_size", [32, 64])
def test_test_datasets_match_jax(tmp_path, img_size):
    """Every item of the four test-mode datasets over the pair directories
    (a directory of masks too), at a size that shrinks and one that
    enlarges the 40x50 images."""
    from leftrefill_tpu.data import datasets as jd

    pairs = write_pairs(str(tmp_path))
    masks = tmp_path / "masks"
    masks.mkdir()
    for i in range(2):
        cv2.imwrite(str(masks / f"m{i}.png"), (np.random.RandomState(i).rand(30, 30) * 255).astype(np.uint8))
    images = tmp_path / "singles"
    images.mkdir()
    for i in range(3):
        cv2.imwrite(str(images / f"{i}.jpg"), np.random.RandomState(i).randint(0, 256, (30, 45, 3)).astype(np.uint8))
    cases = [
        (td.TestInpaintingDataset, jd.TestInpaintingDataset, dict(root_path=pairs, img_size=img_size, **DS_KW)),
        (td.TestInpaintingDataset, jd.TestInpaintingDataset,
         dict(root_path=pairs, img_size=img_size, mask_path=str(masks), **DS_KW)),
        (td.InpaintingCrossViewDataset, jd.InpaintingCrossViewDataset,
         dict(image_path=pairs, pair_path=None, mask_path=str(masks), mode="test", img_size=img_size, **DS_KW)),
        (td.InpaintingMultiViewDataset, jd.InpaintingMultiViewDataset,
         dict(image_path=pairs, pair_path=None, mask_path=None, mode="test", img_size=img_size, view_num=4,
              view_token_len=3, **DS_KW)),
        (td.InpaintingMultiViewDataset, jd.InpaintingMultiViewDataset,
         dict(image_path=pairs, pair_path=None, mask_path=None, mode="test", img_size=img_size, view_num=3,
              view_token_len=2, concat_target=True, **DS_KW)),
        (td.InpaintingDataset, jd.InpaintingDataset,
         dict(image_path=str(images), mask_path=None, mode="test", img_size=img_size, right_strip_frac=0.25,
              **DS_KW)),
    ]
    for ours_cls, jax_cls, kw in cases:
        ours, ref = ours_cls(**kw), jax_cls(**kw)
        assert len(ours) == len(ref) == 3
        for i in range(len(ref)):
            _items_equal(ours[i], ref[i])
    item = td.InpaintingMultiViewDataset(**cases[3][2])[2]
    assert item["idx"] == 2 and item["image"].shape == (4, img_size, img_size, 3)


def test_list_files_and_training_modes(tmp_path):
    """The list-file forms: the cross-view pair of lists (the second list
    first, then the first up to ``test_limit``: JAX's own copy raises there,
    ``os.path.isdir`` of a list, so the port's items are held to the
    directory form's), a pair list equal to JAX's; the training modes raise,
    naming what is missing."""
    from leftrefill_tpu.data import datasets as jd

    pairs = write_pairs(str(tmp_path))
    names = [os.path.join(pairs, n) for n in sorted(os.listdir(pairs))]
    (tmp_path / "a.txt").write_text("\n".join(names[:2]) + "\n")
    (tmp_path / "b.txt").write_text(names[2] + "\n")
    kw = dict(pair_path=None, mask_path=None, mode="test", img_size=32, **DS_KW)
    ours = td.InpaintingCrossViewDataset([str(tmp_path / "a.txt"), str(tmp_path / "b.txt")], test_limit=2, **kw)
    assert ours.pairs == [names[2], names[0]]
    whole = td.InpaintingCrossViewDataset(pairs, **kw)
    _items_equal(ours[0], whole[2])
    _items_equal(ours[1], whole[0])
    with pytest.raises(TypeError):
        jd.InpaintingCrossViewDataset([str(tmp_path / "a.txt"), str(tmp_path / "b.txt")], **kw)
    _items_equal(td.TestInpaintingDataset(str(tmp_path / "a.txt"), 32)[1],
                 jd.TestInpaintingDataset(str(tmp_path / "a.txt"), 32)[1])
    for cls, args in ((td.InpaintingCrossViewDataset, ("x", "y", ["m", "n"])),
                      (td.InpaintingMultiViewDataset, ("x", "y", ["m", "n"])), (td.InpaintingDataset, ("x", None))):
        with pytest.raises(NotImplementedError, match="FileMaskSampler"):
            cls(*args, mode="train")


def _exp(root, yaml_text: str) -> str:
    exp = os.path.join(root, "exp")
    os.makedirs(exp)
    with open(os.path.join(exp, "model_config.yaml"), "w") as f:
        f.write(yaml_text)
    return exp


def _lpips_file(path) -> str:
    from leftrefill_torch.eval.lpips import ALEX

    g = torch.Generator().manual_seed(0)
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, ch, 1, 1), generator=g) for i, (ch, _, _, _) in enumerate(ALEX)},
               path)
    return str(path)


def _metrics(path) -> dict:
    with open(path) as f:
        return {k: float(v) for k, v in (line.strip().split(":") for line in f)}


def test_cli_test_writes_grids_singles_and_metrics(tmp_path):
    """1-reference: two batches of two (the third pair alone), grids, then
    ``--save_single`` at 64 with ``--metric_size`` 32, ``--manual_pairs_x4``
    and LPIPS; the metrics files hold finite PSNR / SSIM (/ LPIPS)."""
    from leftrefill_torch.cli import test as cli

    torch.set_num_threads(2)
    pairs, exp = write_pairs(str(tmp_path)), _exp(str(tmp_path), MODEL_YAML)
    common = ["--model_path", exp, "--test_path", pairs, "--test_size", "32", "--ddim_steps", "4", "--device", "cpu",
              "--output_path", str(tmp_path / "out"), "--metric_output", str(tmp_path / "metrics")]
    assert cli.main(common + ["--batch_size", "2"]) == 0
    grids = sorted(os.listdir(tmp_path / "out" / "exp_32"))
    assert grids == ["000000.png", "000001.png"]
    assert io.read_png(str(tmp_path / "out" / "exp_32" / "000000.png")).shape == (96, 128, 3)  # 3 canvases x 2 pairs
    m = _metrics(tmp_path / "metrics" / "exp_32.txt")
    assert m.keys() == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in m.values())
    # 64 -> 32 before the metrics: AlexNet's taps need about 32 pixels
    assert cli.main(common + ["--exp_name", "single", "--test_size", "64", "--save_single", "--metric_size", "32",
                              "--manual_pairs_x4", "--limit", "1", "--lpips_weights", _lpips_file(tmp_path / "lp.pth")]) == 0
    singles = sorted(os.listdir(tmp_path / "out" / "single_64"))
    assert singles == [f"000000_{i}.png" for i in range(4)]
    assert io.read_png(str(tmp_path / "out" / "single_64" / singles[0])).shape == (32, 32, 3)
    m = _metrics(tmp_path / "metrics" / "single_64.txt")
    assert m.keys() == {"PSNR", "SSIM", "LPIPS"} and all(np.isfinite(v) for v in m.values())


def test_cli_test_multiview_writes_reference_strips(tmp_path):
    from leftrefill_torch.cli import test as cli

    torch.set_num_threads(2)
    pairs, exp = write_pairs(str(tmp_path)), _exp(str(tmp_path), MV_MODEL_YAML)
    out, metrics = tmp_path / "out", tmp_path / "metrics"
    assert cli.main(["--model_path", exp, "--test_path", pairs, "--test_size", "32", "--ddim_steps", "4",
                     "--device", "cpu", "--multiview", "--batch_size", "2", "--limit", "1", "--exp_name", "mv",
                     "--output_path", str(out), "--metric_output", str(metrics),
                     "--lpips_weights", _lpips_file(tmp_path / "lp.pth")]) == 0
    assert sorted(os.listdir(out / "mv_32")) == ["000000.png", "000000_ref0.png"]  # view_num 2: one reference
    assert io.read_png(str(out / "mv_32" / "000000_ref0.png")).shape == (64, 32, 3)  # the two scenes' views
    assert io.read_png(str(out / "mv_32" / "000000.png")).shape == (96, 128, 3)  # 2 scenes x 2 views
    m = _metrics(metrics / "mv_32.txt")  # LPIPS of square views: the target is not cropped (JAX's crops it)
    assert m.keys() == {"PSNR", "SSIM", "LPIPS"} and all(np.isfinite(v) for v in m.values())
    # only the target views are scored: a reference view has no hole and reads 120 dB, which would lift
    # the mean of two views above 60
    assert m["PSNR"] < 60, m


def test_cli_sample_writes_png(tmp_path):
    """A JPEG reference and target and a palette mask -> two 32x32 PNGs; an
    --out that is no PNG is refused."""
    from leftrefill_torch.cli import sample as cli

    torch.set_num_threads(2)
    pairs, exp = write_pairs(str(tmp_path)), _exp(str(tmp_path), MODEL_YAML)
    d = os.path.join(pairs, "0001")
    args = ["--model_path", exp, "--reference", os.path.join(pairs, "0000", "source.jpg"),
            "--source", os.path.join(pairs, "0002", "target.jpg"), "--mask", os.path.join(d, "mask.png"),
            "--img_size", "32", "--ddim_steps", "4", "--device", "cpu", "--num_samples", "2"]
    assert cli.main(args + ["--out", str(tmp_path / "o.png")]) == 0
    outs = [io.read_png(str(tmp_path / f"o_{i}.png")) for i in range(2)]
    assert all(o.shape == (32, 32, 3) and o.dtype == np.uint8 for o in outs) and not np.array_equal(*outs)
    with pytest.raises(ValueError, match="PNG"):
        cli.main(args + ["--out", str(tmp_path / "o.jpg")])
