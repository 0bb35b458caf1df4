"""DSM construction + evaluation: point-cloud rasterization, ROI crop,
NCC-registered altitude/normal MAE, NaN infill.

Rebuilds the reference's GDAL/plyflatten/numba chain in NumPy/scipy:

  * rasterize_cloud   <- plyflatten(cloud, radius=1, sigma=inf)
                         (satellite_rgb_dep.py:636-699)
  * dsm_from_depth    <- get_latlonalt/get_dsm_from_nerf_prediction
                         (satellite_rgb_dep.py:601-699)
  * crop_to_roi       <- gdal.Translate(projWin=...) (sat_utils.py:206-210)
  * pointwise_diff    <- sat_utils.dsm_pointwise_diff:185-276
  * mae_report        <- sat_utils.compute_mae_and_save_dsm_diff:315-350
                         + MaskDoD:278-297
  * interpolate_nans  <- eval.quickly_interpolate_nans_from_singlechannel_img
                         (eval.py:107-133) / Cloud2Grid (sat_utils.py:299-313)
  * normals MAE       <- get_pts3d_from_dsm + calc_nr_diff
                         (sat_utils.py:164-183)

The port's copy of the JAX package's geo/dsm.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .geodesy import ecef_to_latlon, utm_from_latlon
from . import registration
from ..utils.geotiff import GeoProfile, read_geotiff, write_geotiff, utm_epsg
from ..data.satellite import SceneLoc, normals_from_grid_points


# -------------------------------------------------------------- rasterize

def rasterize_cloud(cloud: np.ndarray, xoff: float, yoff: float,
                    resolution: float, xsize: int, ysize: int,
                    radius: int = 1) -> np.ndarray:
    """Splat (P, 3) [east, north, alt] points onto a (ysize, xsize) grid.

    plyflatten semantics with sigma=inf: every point contributes equally to
    all cells within `radius` cells of its own; output = per-cell average,
    NaN where empty.  yoff is the TOP edge (max northing); row index grows
    southward.
    """
    cols = np.floor((cloud[:, 0] - xoff) / resolution).astype(np.int64)
    rows = np.floor((yoff - cloud[:, 1]) / resolution).astype(np.int64)
    acc = np.zeros((ysize, xsize), np.float64)
    cnt = np.zeros((ysize, xsize), np.float64)
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            r = rows + dr
            c = cols + dc
            ok = (r >= 0) & (r < ysize) & (c >= 0) & (c < xsize)
            np.add.at(acc, (r[ok], c[ok]), cloud[ok, 2])
            np.add.at(cnt, (r[ok], c[ok]), 1.0)
    with np.errstate(invalid="ignore"):
        dsm = acc / cnt
    dsm[cnt == 0] = np.nan
    return dsm.astype(np.float32)


def dsm_from_depth(rays: np.ndarray, depth: np.ndarray, scene: SceneLoc,
                   cs: str = "utm", utm_zone: Optional[Tuple[int, str]] = None,
                   roi: Optional[np.ndarray] = None,
                   resolution: float = 0.5,
                   dsm_path: Optional[str] = None):
    """NeRF depth -> georeferenced DSM.

    rays: (h*w, >=8) normalized rays; depth: (h*w,) predicted depth.
    roi: optional (x, y, s, r) GT ROI metadata (xoff, yoff-bottom, size,
    resolution) — matches the {aoi}_DSM.txt files.
    Returns (dsm (ys, xs) float32 with NaNs, GeoProfile).
    """
    rays = np.asarray(rays, np.float64)
    depth = np.asarray(depth, np.float64).reshape(-1)
    xyz_n = rays[:, 0:3] + rays[:, 3:6] * depth[:, None]
    xyz = scene.denormalize_points(xyz_n)
    if cs == "ecef":
        lat, lon, alt = ecef_to_latlon(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        zone = utm_zone[0] if utm_zone else None
        # pass the scene's hemisphere letter through rather than letting
        # utm_from_latlon infer it from the first point of the cloud
        southern = (utm_zone[1] < "N") if utm_zone else None
        east, north = utm_from_latlon(lat, lon, zone=zone,
                                      southern=southern)
        cloud = np.stack([east, north, alt], -1)
    else:
        cloud = xyz
    if roi is not None:
        xoff, yoff_b = float(roi[0]), float(roi[1])
        xsize = ysize = int(roi[2])
        resolution = float(roi[3])
        yoff = yoff_b + ysize * resolution       # top edge
    else:
        xmin, xmax = cloud[:, 0].min(), cloud[:, 0].max()
        ymin, ymax = cloud[:, 1].min(), cloud[:, 1].max()
        xoff = np.floor(xmin / resolution) * resolution
        xsize = int(1 + np.floor((xmax - xoff) / resolution))
        yoff = np.ceil(ymax / resolution) * resolution
        ysize = int(1 - np.floor((ymin - yoff) / resolution))
    dsm = rasterize_cloud(cloud, xoff, yoff, resolution, xsize, ysize)
    epsg = None
    if utm_zone is not None:
        epsg = utm_epsg(utm_zone[0], utm_zone[1] >= "N")
    prof = GeoProfile(width=xsize, height=ysize, count=1, dtype="float32",
                      ulx=xoff, uly=yoff, xres=resolution, yres=resolution,
                      epsg=epsg, nodata=float("nan"))
    if dsm_path is not None:
        os.makedirs(os.path.dirname(dsm_path) or ".", exist_ok=True)
        write_geotiff(dsm_path, dsm[None], prof)
    return dsm, prof


def load_roi(gt_dir: str, aoi_id: str) -> Optional[np.ndarray]:
    """The {aoi}_DSM.txt ROI (xoff, yoff_bottom, size, resolution), or
    None when absent — callers pass roi[3] as the rasterization
    resolution so prediction and GT share one grid."""
    path = os.path.join(gt_dir, f"{aoi_id}_DSM.txt")
    if not os.path.exists(path):
        return None
    return np.loadtxt(path)


# ------------------------------------------------------------------- crop

def crop_to_roi(dsm: np.ndarray, prof: GeoProfile, ulx: float, uly: float,
                xsize: int, ysize: int) -> np.ndarray:
    """Extract the (ysize, xsize) window whose upper-left model corner is
    (ulx, uly), NaN-padding outside — gdal.Translate projWin semantics
    (sat_utils.py:206-210)."""
    c0 = int(round((ulx - prof.ulx) / prof.xres))
    r0 = int(round((prof.uly - uly) / prof.yres))
    out = np.full((ysize, xsize), np.nan, np.float32)
    r1, c1 = r0 + ysize, c0 + xsize
    sr0, sc0 = max(0, r0), max(0, c0)
    sr1, sc1 = min(dsm.shape[0], r1), min(dsm.shape[1], c1)
    if sr1 > sr0 and sc1 > sc0:
        out[sr0 - r0:sr1 - r0, sc0 - c0:sc1 - c0] = dsm[sr0:sr1, sc0:sc1]
    return out


# -------------------------------------------------------------- NaN infill

def interpolate_nans(img: np.ndarray) -> np.ndarray:
    """Nearest-neighbor infill of NaN pixels (eval.py:107-133 uses scipy
    griddata nearest; the distance transform below is the same result in
    O(N))."""
    from scipy import ndimage
    mask = np.isnan(img)
    if not mask.any() or mask.all():
        return img
    idx = ndimage.distance_transform_edt(mask, return_distances=False,
                                         return_indices=True)
    return img[tuple(idx)]


# ------------------------------------------------------------ normal stats

def dsm_normal_angular_diff(pred: np.ndarray, gt: np.ndarray,
                            resolution: float) -> np.ndarray:
    """Per-pixel angle (degrees) between surface normals of two DSMs on the
    same grid (sat_utils.get_pts3d_from_dsm:175-183 + calc_nr_diff:164-173).
    """
    h, w = gt.shape
    cols, rows = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))

    def normals(dsm):
        pts = np.stack([cols * resolution, rows * resolution, dsm], -1)
        n, _ = normals_from_grid_points(pts.astype(np.float32))
        return n.reshape(h, w, 3)

    # NaNs propagate through the cross products exactly as in the reference
    # (torch NaN arithmetic), excluding NaN-adjacent pixels via nanmean;
    # grid-border pixels keep zero normals on BOTH sides -> acos(0) = 90deg,
    # a reference behavior kept for metric parity.
    with np.errstate(invalid="ignore"):
        n1 = normals(pred)
        n2 = normals(gt)
        dot = np.clip(np.sum(n1 * n2, -1), -1.0, 1.0)
        ang = np.degrees(np.arccos(dot))
    return ang


# ------------------------------------------------------------- evaluation

@dataclass
class DSMReport:
    mae: float
    mae_in: float
    mae_out: float
    mae_nr: float
    diff: np.ndarray            # registered pred - gt
    diff_in: np.ndarray
    diff_nr: Optional[np.ndarray]
    rdsm: np.ndarray            # registered predicted DSM on the GT grid


def pointwise_diff(pred_dsm: np.ndarray, pred_prof: GeoProfile,
                   gt_dsm: np.ndarray, roi: np.ndarray,
                   pred_mask: Optional[np.ndarray] = None,
                   register_xy: bool = True,
                   calc_mae_nr: bool = False):
    """Crop predicted DSM to the GT ROI, register, diff
    (sat_utils.dsm_pointwise_diff:185-276).

    roi: (xoff, yoff_bottom, size, resolution).  Returns (diff, diff_nr,
    rdsm) on the GT grid."""
    xoff, yoff_b = float(roi[0]), float(roi[1])
    size = int(roi[2])
    res = float(roi[3])
    if abs(pred_prof.xres - res) > 1e-9:
        raise ValueError(
            f"predicted DSM resolution {pred_prof.xres} != GT ROI "
            f"resolution {res}: the crop/diff would compare incommensurate "
            f"grids — rasterize the prediction at the GT resolution "
            f"(dsm_from_depth(resolution=roi[3]) or load_roi)")
    uly = yoff_b + size * res
    pred = crop_to_roi(pred_dsm, pred_prof, xoff, uly, size, size)
    if pred_mask is not None:
        pred = pred.copy()
        pred[~pred_mask] = np.nan

    if register_xy and np.isfinite(pred).any():
        dx, dy, a, b = registration.compute_shift(gt_dsm.astype(np.float64),
                                                  pred.astype(np.float64),
                                                  scaling=False)
        rdsm = registration.apply_shift(pred.astype(np.float64), dx, dy, a, b)
    else:
        rdsm = pred + np.nanmean(gt_dsm - pred)
    diff = (rdsm - gt_dsm).astype(np.float32)
    diff_nr = None
    if calc_mae_nr:
        diff_nr = dsm_normal_angular_diff(rdsm, gt_dsm, res).astype(np.float32)
    return diff, diff_nr, rdsm.astype(np.float32)


def _split_by_mask(diff: np.ndarray, mask: Optional[np.ndarray]):
    """(diff_in, diff_out): NaN outside / inside the mask (MaskDoD)."""
    if mask is None:
        return diff, diff
    d_in = diff.copy()
    d_out = diff.copy()
    d_in[~mask] = np.nan
    d_out[mask] = np.nan
    return d_in, d_out


def mae_report(pred_dsm: np.ndarray, pred_prof: GeoProfile, gt_dir: str,
               aoi_id: str, out_dir: Optional[str] = None,
               src_id: str = "", epoch_number: int = -1,
               calc_mae_nr: bool = True) -> DSMReport:
    """Full DSM evaluation against the lidar GT directory layout
    ({aoi}_DSM.tif / {aoi}_DSM.txt / optional {aoi}_Mask.tif)
    (sat_utils.compute_mae_and_save_dsm_diff:315-350)."""
    gt_dsm_path = os.path.join(gt_dir, f"{aoi_id}_DSM.tif")
    roi = np.loadtxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"))
    gt_arr, _ = read_geotiff(gt_dsm_path)
    gt_dsm = gt_arr[0].astype(np.float64)

    mask = None
    mask_path = os.path.join(gt_dir, f"{aoi_id}_Mask.tif")
    if os.path.exists(mask_path):
        m_arr, _ = read_geotiff(mask_path)
        mask = m_arr[0] > 0

    diff, diff_nr, rdsm = pointwise_diff(pred_dsm, pred_prof, gt_dsm, roi,
                                         calc_mae_nr=calc_mae_nr)
    mae = float(np.nanmean(np.abs(diff)))
    mae_nr = float(np.nanmean(np.abs(diff_nr))) if calc_mae_nr else -1.0
    diff_in, diff_out = _split_by_mask(diff, mask)
    if mask is not None:
        mae_in = float(np.nanmean(np.abs(diff_in)))
        mae_out = float(np.nanmean(np.abs(diff_out)))
    else:
        mae_in = mae_out = -1.0

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        suffix = (f"_epoch{epoch_number}" if epoch_number >= 0 else "")
        res = float(roi[3])
        prof = GeoProfile(width=diff.shape[1], height=diff.shape[0],
                          ulx=float(roi[0]),
                          uly=float(roi[1]) + int(roi[2]) * res,
                          xres=res, yres=res, epsg=pred_prof.epsg,
                          nodata=float("nan"))
        write_geotiff(os.path.join(out_dir, f"{src_id}_rdsm{suffix}.tif"),
                      rdsm[None], prof)
        # the reference shuffles diffs into a sibling rdsm_diff/ directory
        # (eval.py:498-503)
        diff_dir = os.path.join(os.path.dirname(out_dir.rstrip("/")),
                                "rdsm_diff")
        os.makedirs(diff_dir, exist_ok=True)
        write_geotiff(os.path.join(diff_dir,
                                   f"{src_id}_rdsm_diff{suffix}.tif"),
                      diff[None], prof)
    return DSMReport(mae=mae, mae_in=mae_in, mae_out=mae_out, mae_nr=mae_nr,
                     diff=diff, diff_in=diff_in, diff_nr=diff_nr, rdsm=rdsm)
