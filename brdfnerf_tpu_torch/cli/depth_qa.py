"""Depth-supervision QA: rasterize the MicMac dense-depth 3D points into a
DSM and score it against the lidar GT, which measures the quality of the
supervision source itself (the JAX package's cli/depth_qa.py; reference:
datasets/cal_rmse_depth.py:95-136).  Host only.

python -m brdfnerf_tpu_torch.cli.depth_qa --root_dir ... --gt_dir ... --aoi_id ...
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def depth_qa(root_dir: str, gt_dir: str, aoi_id: str,
             depth_subdir: str = "DenseDepth_ZM4", out_dir: str = None):
    """{image id: supervision DSM MAE (m)} over the depth directory's
    *_3DPts.txt files."""
    from ..data.satellite import load_depth_files
    from ..geo.dsm import rasterize_cloud, mae_report
    from ..utils.geotiff import GeoProfile

    roi = np.loadtxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"))
    xoff, yoff_b = float(roi[0]), float(roi[1])
    size = int(roi[2])
    res = float(roi[3])
    depth_dir = os.path.join(root_dir, depth_subdir)
    results = {}
    for p3 in sorted(glob.glob(os.path.join(depth_dir, "*_3DPts.txt"))):
        img_id = os.path.basename(p3)[:-len("_3DPts.txt")]
        _, pts3d, _ = load_depth_files(depth_dir, img_id)
        dsm = rasterize_cloud(pts3d, xoff, yoff_b + size * res, res,
                              size, size)
        prof = GeoProfile(width=size, height=size, ulx=xoff,
                          uly=yoff_b + size * res, xres=res, yres=res)
        rep = mae_report(dsm, prof, gt_dir, aoi_id, out_dir=out_dir,
                         src_id=f"depthqa_{img_id}", calc_mae_nr=False)
        results[img_id] = rep.mae
        print(f"{img_id}: supervision DSM MAE {rep.mae:.3f} m")
    if results:
        print(f"mean supervision MAE {np.mean(list(results.values())):.3f} m")
    return results


def main(argv=None, device=None):
    """device: accepted as every CLI's main takes it; the QA runs on the
    host."""
    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--aoi_id", required=True)
    p.add_argument("--inputdds", default="DenseDepth_ZM4")
    p.add_argument("--output_dir", default=None)
    a = p.parse_args(argv)
    depth_qa(a.root_dir, a.gt_dir, a.aoi_id, a.inputdds, a.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
