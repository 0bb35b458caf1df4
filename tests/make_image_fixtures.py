"""Write the image fixtures that chip_smoke.py decodes on the card, where
there is no Pillow: tests/data_torch_port/, with manifest.json holding the
SHA-256, dtype and shape of the array Pillow decodes from each file
(np.asarray(Image.open(path))).

  ycbcr_420_tiled.tif  512 x 512 RGB as YCbCr 4:2:0 JPEG-in-TIFF, 128 x 128
                       tiles of abbreviated streams, tables in JPEGTables
  grey_jpeg.tif        256 x 256 greyscale JPEG-in-TIFF in 64-row strips
                       (written by Pillow's libtiff)
  mask_g4.tif          512 x 512 1-bit mask, CCITT T.6 (Group 4)
  mask_g3_2d.tif       512 x 512 1-bit mask, CCITT T.4 2-D (Group 3)
  rgba16_adam7.png     160 x 160 16-bit RGBA, Adam7 (no noise: its low
                       bytes would not compress)
  palette.png          256 x 256 palette (8-bit indices)

Run with the repository root on the path: python tests/make_image_fixtures.py
"""

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from image_builders import (build_tiff, encode_png_any, pil_jpeg,  # noqa
                            split_tables)

OUT = os.path.join(HERE, "data_torch_port")


def digest(arr) -> str:
    """SHA-256 of an array's bytes, a bool array's as 0 / 1 (PIL's mode
    "1" arrays hold 255 in their bytes); chip_smoke.py hashes the same."""
    a = np.ascontiguousarray(arr)
    if a.dtype == bool:
        a = a.astype(np.uint8)
    return hashlib.sha256(a.tobytes()).hexdigest()


def texture(h, w, c, seed, noise=0.04):
    """A scene-like image: smooth fields, edges and a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for i in range(c):
        f = (0.5 + 0.25 * np.sin(9 * xx + 5 * yy + i)
             + 0.15 * np.sign(np.sin(23 * xx * (i + 1)) * np.cos(17 * yy))
             + noise * rng.standard_normal((h, w)))
        out.append(f)
    return np.clip(np.stack(out, -1), 0, 1)


def mask(n, seed):
    yy, xx = np.mgrid[0:n, 0:n]
    m = np.zeros((n, n), bool)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, n, 2).tolist() + [rng.uniform(10, 90)]
        m ^= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return m


def main():
    from PIL import Image
    os.makedirs(OUT, exist_ok=True)
    files = {}

    img = (texture(512, 512, 3, 0) * 255).astype(np.uint8)
    tiles = [pil_jpeg(img[y:y + 128, x:x + 128], subsampling=2, quality=80)
             for y in range(0, 512, 128) for x in range(0, 512, 128)]
    tables = split_tables(tiles[0])[0]
    tags = {258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 530: (3, [2, 2]), 347: (7, tables)}
    files["ycbcr_420_tiled.tif"] = build_tiff(
        512, 512, tags, [split_tables(t)[1] for t in tiles],
        tiled=(128, 128))

    grey = (texture(256, 256, 1, 1)[..., 0] * 255).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(grey).save(b, "TIFF", compression="jpeg",
                               tiffinfo={278: 64})
    files["grey_jpeg.tif"] = b.getvalue()

    for name, compression, t4 in (("mask_g4.tif", "group4", 0),
                                  ("mask_g3_2d.tif", "group3", 1)):
        b = io.BytesIO()
        Image.fromarray(mask(512, len(name))).save(
            b, "TIFF", compression=compression,
            tiffinfo={292: t4} if t4 else {})
        files[name] = b.getvalue()

    rgba = (texture(160, 160, 4, 2, noise=0.0) * 65535).astype(np.int64)
    files["rgba16_adam7.png"] = encode_png_any(rgba, 16, 6, interlace=True)

    pal = Image.fromarray((texture(256, 256, 3, 3) * 255).astype(
        np.uint8)).convert("P", palette=Image.Palette.ADAPTIVE, colors=256)
    b = io.BytesIO()
    pal.save(b, "PNG")
    files["palette.png"] = b.getvalue()

    manifest = {}
    for name, data in sorted(files.items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        im = Image.open(path)
        arr = np.ascontiguousarray(np.asarray(im))
        manifest[name] = {
            "sha256": digest(arr),
            "dtype": str(arr.dtype), "shape": list(arr.shape),
            "pil_mode": im.mode, "bytes": len(data)}
    manifest["_written_by"] = (f"tests/make_image_fixtures.py, Pillow "
                               f"{__import__('PIL').__version__}")
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(json.dumps({k: v["bytes"] for k, v in manifest.items()
                      if isinstance(v, dict)}),
          sum(v["bytes"] for v in manifest.values() if isinstance(v, dict)))


if __name__ == "__main__":
    main()
