"""Decode times of the committed image fixtures (tests/data_torch_port):
the port's host C libraries, their NumPy twins and, where Pillow is
installed, Pillow's own decode of the same file, each the best of
`--reps` runs after a first call (which builds the library), on the
machine's CPU.

Run from the repository root: python tests/image_decode_times.py [--reps N]
Prints one line a file and a JSON object of milliseconds as the last line.
"""

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(ROOT, "tests", "data_torch_port")


def best_ms(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return min(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import chip_smoke
    from brdfnerf_tpu_torch.utils import geotiff, png
    try:
        from PIL import Image
    except ImportError:
        Image = None

    def read(path):
        return png.read_png(path) if path.endswith(".png") else \
            geotiff.read_pixels(path)

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        names = sorted(n for n in json.load(f) if not n.startswith("_"))
    result = {}
    for name in names:
        path = os.path.join(FIXTURES, name)
        read(path)
        c_ms = best_ms(lambda: read(path), args.reps)
        with chip_smoke.host_twins():
            twin_ms = best_ms(lambda: read(path), max(1, args.reps // 2))
        pil_ms = (best_ms(lambda: np.asarray(Image.open(path)), args.reps)
                  if Image is not None else None)
        result[name] = {"c_ms": c_ms, "twin_ms": twin_ms, "pil_ms": pil_ms}
        print(f"{name}: host C {c_ms:.3f} ms, NumPy twin {twin_ms:.1f} ms, "
              f"Pillow " + (f"{pil_ms:.3f} ms" if pil_ms is not None
                            else "not installed"), flush=True)
    print(json.dumps({"cpu": platform.processor() or platform.machine(),
                      "reps": args.reps, "files": result}))


if __name__ == "__main__":
    main()
