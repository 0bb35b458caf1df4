"""Evaluation CLI: python -m brdfnerf_tpu_torch.cli.eval --logs_dir <logs/exp>
--epoch_number N --split val (the JAX package's cli/eval.py; reference
eval.py:225-517 semantics).

Reloads opts.json as the config source of truth (eval.py:228-229), loads
the epoch checkpoint (.npz, or the reference's .ckpt), renders every image
of the requested split through the block render on the card, writes
rgb/depth/DSM GeoTIFFs plus registered DSM diffs (rdsm/, rdsm_diff/), and
prints mean PSNR / SSIM / DSM MAE.  Prints which fused kernels the render
launches, or why none.  --find_best_t on a run with the t-embedding renders
each image once per embedding index and keeps the best.  Each image's
panel stack (utils/viz) is written as {src}_panels.png.

Gate semantics on eval: apply_brdf = (brdf_on < 1), apply_theta likewise,
cos_irra = (cos_irra_on < 1) (eval.py:383-384).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict

import numpy as np

from . import opts as opts_mod


def find_best_t_for_val_image(r, sample, n_vocab: int):
    """Best-PSNR transient-embedding search (eval.py:184-199): render the
    image once per vocab index through the Renderer `r`, score the
    unmasked PSNR, keep the argmax (the first of equals) and its render.
    Returns (t, psnr, render)."""
    import torch
    from ..metrics import psnr
    gt = torch.from_numpy(np.asarray(sample["rgbs"]).reshape(-1, 3))
    best_t, best_psnr, best_out = 0, -float("inf"), None
    for t in range(n_vocab):
        out = r.render_image(sample, t=t)
        rgb = torch.from_numpy(out.get("rgb_fine", out["rgb_coarse"]))
        p = float(psnr(rgb.reshape(-1, 3), gt))
        if p > best_psnr:
            best_t, best_psnr, best_out = t, p, out
    return best_t, best_psnr, best_out


def evaluate(run_dir: str, epoch_number: int, split: str = "val",
             checkpoints_dir: str = None, output_dir: str = None,
             find_best_t: bool = False, compute_dtype: str = None,
             normal_at_surface: bool = None,
             sun_march_samples: int = None,
             n_devices: int = 0, device=None) -> Dict:
    """Score a run's epoch checkpoint on `split` (on CUDA unless `device`
    names another): {psnr, ssim, mae, mae_nr} means over the test images
    (is_val), or over every image with split='train'.  With the search,
    each image's embedding index is printed ('[eval] best t for image
    i: t')."""
    import torch
    from ..geo import dsm as dsm_mod
    from ..metrics import masked_scores
    from ..serve import load_renderer
    from ..utils import viz
    from ..utils.geotiff import GeoProfile, write_geotiff
    from .train import kernels_line

    out_dir = output_dir or os.path.join(run_dir, f"eval_epoch{epoch_number}")
    # serve.load_renderer: opts.json reload, the split's dataset ('train' =
    # every training image, eval.py:238-249), the checkpoint restored onto
    # the device, the serving overrides; it creates out_dir
    r = load_renderer(run_dir, epoch_number,
                      checkpoints_dir=checkpoints_dir, split=split,
                      compute_dtype=compute_dtype,
                      normal_at_surface=normal_at_surface,
                      sun_march_samples=sun_march_samples,
                      output_dir=out_dir, n_devices=n_devices, device=device)
    # the best-PSNR embedding search applies to models that carry the
    # transient t embedding (the t table exists exactly when beta is on)
    search_t = find_best_t and r.cfg.model.beta
    args, ds = r.args, r.dataset
    print(kernels_line(r.cfg, r.device, train=False), flush=True)

    psnrs, ssims, maes, maes_nr = [], [], [], []
    for idx in range(len(ds)):
        s = ds.get_image(idx)
        t0 = time.perf_counter()
        if search_t:
            t_idx, best_p, out = find_best_t_for_val_image(
                r, s, int(r.cfg.model.t_embedding_vocab))
            print(f"[eval] best t for image {idx}: {t_idx} "
                  f"(psnr {best_p:.2f})")
        else:
            out = r.render_image(s)
        render_s = time.perf_counter() - t0
        h, w = s["h"], s["w"]
        # score the fine pass when a fine model exists (reference eval typ)
        rgb = out.get("rgb_fine", out["rgb_coarse"]).reshape(h, w, 3)
        gt = s["rgbs"].reshape(h, w, 3)
        mask = s.get("mask")
        mval = (torch.from_numpy(mask.reshape(h, w, 1))
                if mask is not None else None)
        # masked + max(gt)-rescaled scoring, reference convention
        # (eval.py:469-471)
        sc = masked_scores(torch.from_numpy(rgb), torch.from_numpy(gt),
                           mval, scl=True)
        p, sv = sc["psnr"], sc["ssim"]
        p_scl, sv_scl = sc["psnr_scl"], sc["ssim_scl"]
        src = s.get("src_id", str(idx))
        # the diagnostic panel stack (eval.py:494-497 save_nerf_output
        # analog): rgb/gt/depth + BRDF parameter / normal / sun maps
        try:
            panel = viz.render_summary_panels(
                out, gt, h, w,
                visu_scale=float(getattr(args, "visu_scale", 1.0)))
            viz.save_png(os.path.join(out_dir, f"{src}_panels.png"), panel)
        except Exception as e:
            print(f"[eval] panel save failed: {e}")
        write_geotiff(os.path.join(out_dir, f"{src}_rgb.tif"),
                      (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
                      .transpose(2, 0, 1), GeoProfile())
        depth = out.get("depth_fine", out["depth_coarse"])
        write_geotiff(os.path.join(out_dir, f"{src}_depth.tif"),
                      depth.reshape(1, h, w).astype(np.float32), GeoProfile())
        t0 = time.perf_counter()
        scene = getattr(ds, "scene", None)
        if scene is not None:
            roi = (dsm_mod.load_roi(args.gt_dir, args.aoi_id)
                   if args.gt_dir else None)
            dsm, prof = dsm_mod.dsm_from_depth(
                s["rays"], depth, scene, cs=ds.cfg.cs,
                utm_zone=ds.utm_zone,
                resolution=(float(roi[3]) if roi is not None else 0.5),
                dsm_path=os.path.join(out_dir, "dsm", f"{src}_dsm.tif"))
            if args.gt_dir:
                rep = dsm_mod.mae_report(
                    dsm, prof, args.gt_dir, args.aoi_id,
                    out_dir=os.path.join(out_dir, "rdsm"),
                    src_id=src, epoch_number=epoch_number)
                if s.get("is_val", True) or split == "train":
                    maes.append(rep.mae)
                    maes_nr.append(rep.mae_nr)
        dsm_s = time.perf_counter() - t0
        if s.get("is_val", True) or split == "train":
            psnrs.append(p)
            ssims.append(sv)
        print(f"{src}: psnr {p:.2f} ({p_scl:.2f} scl) "
              f"ssim {sv:.3f} ({sv_scl:.3f} scl)"
              + (f" mae {maes[-1]:.2f}" if maes and s.get("is_val", True)
                 else ""))
        print(f"[eval] {src}: {len(depth)} rays rendered in {render_s:.3f} s"
              f"; DSM and its registration (NumPy, on the host) "
              f"{dsm_s:.3f} s", flush=True)

    result = {"psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
              "ssim": float(np.mean(ssims)) if ssims else float("nan"),
              "mae": float(np.mean(maes)) if maes else float("nan"),
              "mae_nr": float(np.mean(maes_nr)) if maes_nr else float("nan")}
    print(f"mean: psnr {result['psnr']:.2f} ssim {result['ssim']:.3f} "
          f"mae {result['mae']:.3f} mae_nr {result['mae_nr']:.2f}")
    return result


def main(argv=None, device=None):
    """Evaluate on CUDA unless `device` names another (the tests pass
    device='cpu')."""
    args = opts_mod.eval_parser().parse_args(argv)
    # reference contract: the run directory is logs_dir/run_id
    # (eval.py:225-228); with no run_id, logs_dir IS the run directory
    run_dir = (os.path.join(args.logs_dir, args.run_id)
               if args.run_id else args.logs_dir)
    evaluate(run_dir, args.epoch_number, split=args.split,
             checkpoints_dir=args.checkpoints_dir,
             output_dir=args.output_dir,
             find_best_t=bool(args.find_best_t),
             compute_dtype=args.compute_dtype,
             normal_at_surface=args.normal_at_surface,
             sun_march_samples=args.sun_march_samples,
             n_devices=args.n_devices, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
