"""Offline dataset generation CLI (reference: generate_dataset.py:483-508);
the port's copy of the JAX package's cli/generate_dataset.py, with its
flags.

Mirrors the reference's __main__ — crop the GT DSM to the AOI window,
then crop every source image to that footprint with RPC offset fixups,
emitting the per-image JSONs, masks, and train/test splits the training
CLI consumes:

    python -m brdfnerf_tpu_torch.cli.generate_dataset --aoi_id AOI \
        --dsm_dir <gt> --dsm_file <big_dsm.tif> \
        --coor_left <ulx> --coor_upper <uly> --resolution <m/px> \
        --img_dir <full-scene tifs + RPC sidecars> --out_dir <out>

Reference flag names kept (--aoi_id/--dsm_dir/--dsm_file/--coor_left/
--coor_upper/--resolution/--img_dir); the reference hardcodes per-AOI
crop sizes and image lists (generate_dataset.py:438-481, 302-428) — here
--size sets the crop window and every --img_dir GeoTIFF with an RPC
sidecar (<img>.rpc / <img>.RPB / <img>_rpc.txt, RPC00B text) is used.
Bundle adjustment stays an external tool, as in the reference; when a
`ba_output/` directory exists next to --img_dir, adjusted RPCs are read
from it (adjusted_rpc_from_ba).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional, Tuple


def _find_rpc_sidecar(img_path: str) -> Optional[str]:
    from .. import dataset_gen as dg
    return dg.find_rpc_sidecar(img_path)


def main(argv=None) -> int:
    from .. import dataset_gen as dg

    p = argparse.ArgumentParser(
        description="Crop DSM + image patches, emit JSONs/masks/splits")
    p.add_argument("--aoi_id", type=str, required=True)
    p.add_argument("--dsm_dir", type=str, required=True,
                   help="dir receiving {aoi}_DSM.tif/.txt (and holding "
                        "--dsm_file)")
    p.add_argument("--dsm_file", type=str, default=None,
                   help="large source DSM to crop; omit if "
                        "{aoi}_DSM.tif already exists in --dsm_dir")
    p.add_argument("--coor_left", type=float, default=None)
    p.add_argument("--coor_upper", type=float, default=None)
    p.add_argument("--resolution", type=float, default=None,
                   help="informational; the crop keeps the source DSM's "
                        "resolution (gdal resampling not reproduced)")
    p.add_argument("--img_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, default=None,
                   help="default: <dsm_dir>/..")
    p.add_argument("--size", type=int, default=512,
                   help="DSM crop window in pixels (the reference "
                        "hardcodes per-AOI boxes)")
    p.add_argument("--utm_zone", type=int, required=True)
    p.add_argument("--south", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_ba", action="store_true",
                   help="run bundle adjustment on the emitted crops with "
                        "the reference's pipeline contract "
                        "(generate_dataset.py:40-86) and fold rpcs_adj + "
                        "keypoints + pts3d.npy back into the JSONs; "
                        "degrades gracefully (skips) when the "
                        "bundle_adjust package is not installed")
    args = p.parse_args(argv)

    dsm_tif = os.path.join(args.dsm_dir, f"{args.aoi_id}_DSM.tif")
    if args.dsm_file:
        src = (args.dsm_file if os.path.isabs(args.dsm_file)
               else os.path.join(args.dsm_dir, args.dsm_file))
        assert args.coor_left is not None and args.coor_upper is not None, \
            "--coor_left/--coor_upper required with --dsm_file"
        dg.crop_dsm(src, dsm_tif, args.coor_left, args.coor_upper,
                    args.size, args.size)
        print(f"[generate_dataset] wrote {dsm_tif} + ROI txt")
    assert os.path.exists(dsm_tif), f"{dsm_tif} not found"

    images: List[Tuple[str, dict]] = []
    for img in sorted(glob.glob(os.path.join(args.img_dir, "*.tif"))):
        img_id = os.path.splitext(os.path.basename(img))[0]
        rpc_d = dg.adjusted_rpc_from_ba(
            os.path.join(args.img_dir, "ba_output"), img_id)
        if rpc_d is None:
            sidecar = _find_rpc_sidecar(img)
            if sidecar is None:
                print(f"[generate_dataset] skipping {img} (no RPC sidecar)")
                continue
            rpc_d = dg.parse_rpc_file(sidecar)
        images.append((img, rpc_d))
    assert images, f"no usable GeoTIFF+RPC pairs under {args.img_dir}"

    sun_table = None
    sun_txt = os.path.join(args.img_dir, "pleiades_sun_angles.txt")
    if os.path.exists(sun_txt):
        sun_table = dg.load_sun_angle_table(sun_txt)

    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.dsm_dir))
    root = dg.crop_image_patches(
        args.aoi_id, args.dsm_dir, images, out_dir,
        utm_zone=args.utm_zone, northern=not args.south,
        sun_angles=sun_table, seed=args.seed)
    if args.run_ba:
        # reference order: BA runs on the emitted crops, then its adjusted
        # RPCs/keypoints replace the JSON contents (generate_dataset.py:
        # 503-508 CropImagePatches -> run_ba -> create_dataset use_ba)
        crops_dir = os.path.join(out_dir, f"dataset{args.aoi_id}",
                                 args.aoi_id, "RGB-crops", args.aoi_id)
        ba_out = dg.run_ba(crops_dir, os.path.join(out_dir, "ba"))
        if ba_out is not None:
            n = dg.apply_ba_to_dataset(root, ba_out)
            print(f"[generate_dataset] BA folded into {n} image JSONs")
    print(f"[generate_dataset] dataset root: {root} "
          f"({len(images)} images)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
