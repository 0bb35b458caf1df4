"""Decode times of an all-Paeth 800 x 800 RGBA PNG frame: the port's
utils/png (zlib and the host C unfilter) against PIL, which the JAX
package reads frames with, on the host that runs it.

    python tests/png_times.py [reps]

prints one JSON line: the best of `reps` interleaved decodes of each, in
seconds, and their ratio.  tests/test_torch_port_host_data.py holds the
ratio to 3.
"""

import io
import json
import os
import sys
import time

import numpy as np


def paeth_frame() -> np.ndarray:
    """A smooth 800 x 800 RGBA frame with an opaque disc (lego-like)."""
    yy, xx = np.mgrid[0:800, 0:800] / 800.0
    img = np.zeros((800, 800, 4), np.uint8)
    img[..., 0] = 127 + 100 * np.sin(13 * xx)
    img[..., 1] = 127 + 100 * np.cos(9 * yy)
    img[..., 2] = 255 * xx * yy
    img[..., 3] = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.1) * 255
    return img


def decode_times(reps: int = 7):
    from PIL import Image
    from brdfnerf_tpu_torch.utils import png
    img = paeth_frame()
    buf = png.encode_png(img, png.PAETH)
    assert np.array_equal(png.decode_image(buf)[0], img)
    port, pil = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        png.decode_image(buf)
        port.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(Image.open(io.BytesIO(buf)))
        pil.append(time.perf_counter() - t0)
    return {"port_s": min(port), "pil_s": min(pil),
            "ratio": min(port) / min(pil)}


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(json.dumps(decode_times(int(sys.argv[1]) if len(sys.argv) > 1
                                  else 7)))
