"""BRF probe CLI: reflectance-vs-view-angle curves for chosen pixels
(the JAX package's cli/brf_probe.py; reference eval.py:300-363
eval_pixel_variedvw).

python -m brdfnerf_tpu_torch.cli.brf_probe --logs_dir <run> --epoch_number N \
    [--pixels r,c r,c ...] [--image_idx 1]

Writes brf_<src>_<r>_<c>.txt (zenith, R, G, B columns) and, where
matplotlib imports, a PNG plot per probed pixel.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None, device=None):
    """Probe on CUDA unless `device` names another (the tests pass
    device='cpu')."""
    p = argparse.ArgumentParser()
    p.add_argument("--logs_dir", required=True)
    p.add_argument("--epoch_number", type=int, required=True)
    p.add_argument("--image_idx", type=int, default=1)
    p.add_argument("--pixels", nargs="*", default=None,
                   help="row,col pairs; default = image center")
    p.add_argument("--n_views", type=int, default=33)
    p.add_argument("--param_probe", action="store_true",
                   help="also print the weighted-sum BRDF-parameter "
                        "readout per pixel (rpv_k/theta/rhoc, normal, "
                        "albedo; eval.py:320-363 eval_pixel_variedvw)")
    p.add_argument("--output_dir", default=None)
    args = p.parse_args(argv)

    from ..analysis import brf_probe, pixel_param_probe
    from ..serve import load_renderer

    out_dir = args.output_dir or os.path.join(
        args.logs_dir, f"brf_epoch{args.epoch_number}")
    ren = load_renderer(args.logs_dir, args.epoch_number,
                        output_dir=out_dir, device=device)
    cfg, ds = ren.cfg, ren.dataset
    s = ds.get_image(args.image_idx)
    h, w = s["h"], s["w"]

    pixels = ([(int(r), int(c)) for r, c in
               (pp.split(",") for pp in args.pixels)]
              if args.pixels else [(h // 2, w // 2)])
    for r, c in pixels:
        ray = s["rays"][r * w + c]
        if args.param_probe:
            pp_out = pixel_param_probe(ren.net, cfg.model, cfg.render, ray)
            print(f"-- param probe ({r},{c}):")
            for name, v in sorted(pp_out.items()):
                if name.startswith("mean_"):
                    print(f"  {name[5:]}: {np.round(np.asarray(v), 5)}")
        out = brf_probe(ren.net, cfg.model, cfg.render, ray,
                        n_views=args.n_views)
        curve = out.get("brf", out["rgb"])
        base = os.path.join(out_dir, f"brf_{s['src_id']}_{r}_{c}")
        np.savetxt(base + ".txt",
                   np.column_stack([out["view_zenith_deg"], curve]),
                   header="view_zenith_deg R G B")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(5, 3.2))
            for i, ch in enumerate("RGB"):
                ax.plot(out["view_zenith_deg"], curve[:, i], label=ch)
            ax.set_xlabel("view zenith (deg, principal plane)")
            ax.set_ylabel("BRF")
            ax.legend()
            fig.tight_layout()
            fig.savefig(base + ".png", dpi=120)
            plt.close(fig)
        except Exception as e:
            print(f"plot skipped: {e}")
        print(f"probed ({r},{c}) -> {base}.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
