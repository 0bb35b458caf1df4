"""create_dsm CLI: render the most-nadir view with the most-nadir sun and
save the resulting DSM (+ MAE when GT is available); the JAX package's
cli/create_dsm.py.

Reference: create_dsm.py:19-139 picks the image with the smallest view
incidence angle (sat_utils.sort_by_increasing_view_incidence_angle:356-366)
and overrides every ray's sun direction with the most-nadir sun
(sort_by_increasing_solar_incidence_angle:368-382).  Here incidence angles
come directly from the dataset's own ray geometry (angle between the mean
ray direction and nadir) instead of rpcm.incidence_angles: same ordering,
no external dependency.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def most_nadir_indices(ds):
    """(view_idx, sun_dir) with smallest view / solar incidence angles."""
    best_view, best_ang = 0, np.inf
    best_sun, best_sun_ang = None, np.inf
    for idx in range(len(ds)):
        s = ds.get_image(idx)
        d = s["rays"][:, 3:6].mean(0)
        d = d / np.linalg.norm(d)
        ang = np.degrees(np.arccos(np.clip(-d[2], -1, 1)))
        if ang < best_ang:
            best_view, best_ang = idx, ang
        sun = s["rays"][0, 8:11]
        sun_ang = np.degrees(np.arccos(np.clip(sun[2], -1, 1)))
        if sun_ang < best_sun_ang:
            best_sun, best_sun_ang = sun, sun_ang
    return best_view, best_sun


def main(argv=None, device=None):
    """Render on CUDA unless `device` names another (the tests pass
    device='cpu')."""
    p = argparse.ArgumentParser(description="render most-nadir DSM")
    p.add_argument("--logs_dir", type=str, required=True,
                   help="run dir containing opts.json")
    p.add_argument("--epoch_number", type=int, required=True)
    p.add_argument("--output_dir", type=str, default=None)
    args = p.parse_args(argv)

    from ..geo import dsm as dsm_mod
    from ..serve import load_renderer

    out_dir = args.output_dir or os.path.join(
        args.logs_dir, f"dsm_epoch{args.epoch_number}")
    r = load_renderer(args.logs_dir, args.epoch_number,
                      output_dir=out_dir, device=device)
    ropts, val_ds = r.args, r.dataset

    view_idx, sun = most_nadir_indices(val_ds)
    s = val_ds.get_image(view_idx)
    rays = s["rays"].copy()
    rays[:, 8:11] = sun                      # sun-direction override
    s["rays"] = rays
    out = r.render_image(s)
    roi = (dsm_mod.load_roi(ropts.gt_dir, ropts.aoi_id)
           if ropts.gt_dir else None)
    dsm, prof = dsm_mod.dsm_from_depth(
        rays, out.get("depth_fine", out["depth_coarse"]),
        val_ds.scene, cs=val_ds.cfg.cs,
        utm_zone=val_ds.utm_zone,
        resolution=(float(roi[3]) if roi is not None else 0.5),
        dsm_path=os.path.join(out_dir, f"{s['src_id']}_dsm.tif"))
    print(f"wrote {out_dir}/{s['src_id']}_dsm.tif (view {view_idx})")
    if ropts.gt_dir:
        rep = dsm_mod.mae_report(dsm, prof, ropts.gt_dir, ropts.aoi_id,
                                 out_dir=out_dir, src_id=s["src_id"],
                                 epoch_number=args.epoch_number)
        print(f"DSM MAE {rep.mae:.3f} m, normal MAE {rep.mae_nr:.2f} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
