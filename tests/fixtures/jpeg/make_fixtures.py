"""Writes the JPEG fixtures of this directory and OpenCV's decodes of them
(needs cv2; run from the repository root):

    python tests/fixtures/jpeg/make_fixtures.py

- ``photo_1600x1200_420.jpg``: a seeded 1600x1200 scene (smooth fields,
  discs, sensor-like noise), baseline 4:2:0 at quality 75, the size of a
  camera photo (its decode is held by digest: as a PNG it would pass 1 MB);
- ``baseline_420.jpg``, ``progressive_420.jpg``, ``baseline_444.jpg``,
  ``grey.jpg``: 160x120 scenes of the same kind;
- ``exif_orientation_6.jpg``: a 120x160 scene with an Exif APP1 segment
  spliced in, Orientation 6 (OpenCV turns it to 160x120);
- ``mask_palette.png``: a 1-bit palette mask (black, white) of 120x160.

``manifest.json`` maps each image to OpenCV's decode (``cv2.imread``,
IMREAD_COLOR, as RGB): its shape, the SHA-256 of its bytes and, for all but
the photo, the PNG that holds it (``*.cv2.png``)."""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

from leftrefill_torch.data.image_io import write_png  # noqa: E402


def scene(h: int, w: int, seed: int, noise: float) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) * (1600.0 / w)
    base = np.stack([128 + 60 * np.sin(xx / 97 + yy / 150), 128 + 60 * np.cos(xx / 130 - yy / 77),
                     128 + 50 * np.sin((xx + yy) / 200)], -1)
    low = cv2.resize(rng.randint(0, 256, (15, 20, 3)).astype(np.uint8), (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(0.6 * base + 0.4 * low, 0, 255).astype(np.uint8)
    for _ in range(12):
        cv2.circle(img, (int(rng.randint(0, w)), int(rng.randint(0, h))), int(rng.randint(w // 80, w // 10)),
                   tuple(int(c) for c in rng.randint(0, 256, 3)), -1)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def exif_app1(orientation: int) -> bytes:
    tiff = (b"MM\x00\x2a\x00\x00\x00\x08" + struct.pack(">H", 1) + struct.pack(">HHIHH", 0x112, 3, 1, orientation, 0)
            + b"\x00\x00\x00\x00")
    return b"\xff\xe1" + struct.pack(">H", len(tiff) + 8) + b"Exif\x00\x00" + tiff


def palette_png(path: str, mask: np.ndarray) -> None:
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    h, w = mask.shape
    rows = np.packbits(mask.astype(np.uint8), axis=1)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 1, 3, 0, 0, 0))
                + chunk(b"PLTE", bytes([0, 0, 0, 255, 255, 255])) + chunk(b"IDAT", zlib.compress(raw, 9))
                + chunk(b"IEND", b""))


def main() -> None:
    q = cv2.IMWRITE_JPEG_QUALITY
    files = {
        "photo_1600x1200_420.jpg": (scene(1200, 1600, 0, 6.0), [q, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111]),
        "baseline_420.jpg": (scene(120, 160, 1, 4.0), [q, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111]),
        "progressive_420.jpg": (scene(120, 160, 2, 4.0), [q, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "baseline_444.jpg": (scene(120, 160, 3, 4.0), [q, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111]),
        "grey.jpg": (cv2.cvtColor(scene(120, 160, 4, 4.0), cv2.COLOR_BGR2GRAY), [q, 80]),
        "exif_orientation_6.jpg": (scene(160, 120, 5, 4.0), [q, 85]),
    }
    for name, (img, params) in files.items():
        ok, buf = cv2.imencode(".jpg", img, params)
        data = buf.tobytes()
        if name.startswith("exif"):
            data = data[:2] + exif_app1(6) + data[2:]
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    mask = np.zeros((120, 160), bool)
    mask[30:90, 40:130] = True
    palette_png(os.path.join(HERE, "mask_palette.png"), mask)
    manifest = {}
    for name in list(files) + ["mask_palette.png"]:
        dec = cv2.imread(os.path.join(HERE, name), cv2.IMREAD_COLOR)[..., ::-1].copy()
        entry = {"shape": list(dec.shape), "sha256": hashlib.sha256(dec.tobytes()).hexdigest()}
        if not name.startswith("photo") and not name.endswith(".png"):
            entry["png"] = name.rsplit(".", 1)[0] + ".cv2.png"
            write_png(os.path.join(HERE, entry["png"]), dec)
        manifest[name] = entry
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    main()
