"""Satellite multi-view dataset: RPC ray generation + dense depth supervision.

Rebuilds the reference's production loaders (datasets/satellite.py,
datasets/satellite_depth.py, datasets/satellite_rgb_dep.py) from their file
formats up, NumPy/float64 host-side feeding device-resident float32 ray
stores:

  * per-image JSON metadata: {img, height, width, rpc (rpcm dict),
    min_alt, max_alt, sun_elevation, sun_azimuth, [keypoints]}
    (written by the reference's generate_dataset.py:90-170)
  * train/test split files: newline lists of json names
    (satellite_rgb_dep.py:177-185)
  * scene.loc normalization JSON: per-axis {X,Y,Z}_{scale,offset}
    (satellite.py:141-164)
  * MicMac dense depth: {img}_2DPts.txt (w-first pixel coords; first two
    lines are NOT header — plain int pairs), {img}_3DPts.txt (UTM xyz),
    {img}_Correl.txt (correlation scores) (README.md:89-92,
    satellite_rgb_dep.py:419-427)
  * optional {json}_mask.tif binary masks (satellite_rgb_dep.py:263-285)

Ray layout is the reference's universal (N, 11) currency:
[o(3), d(3), near, far, sun_d(3)] (satellite.py:170-177).  Rays are built
by localizing each pixel at max_alt (origin) and min_alt (far end) through
the float64 vectorized RPC inverse (geo.rpc.localization_np), in ECEF or
UTM coordinates (satellite_rgb_dep.py:23-78), then normalized by the
scene center/range.

Behavioral quirk preserved deliberately (SURVEY.md 2.1): the reference
multiplies all depth stds by (depth_max - depth_min) where both are 0
(satellite_rgb_dep.py:407-408,539), making the effective supervision std
identically 0 so GT-guided samples collapse onto the exact MicMac depth.
`std_quirk=True` (default) reproduces this; False keeps the documented
stdscale*(1-w)+margin law.

The port's copy of the JAX package's data/satellite.py, the sat-nerf
keypoint store (load_sparse_depth) included.  Masks are read through this
package's own GeoTIFF reader; at img_downscale > 1 images, masks and depth
fields are resized by utils/resample's look-alikes of the cv2 calls the
JAX package makes (INTER_LINEAR for images, INTER_NEAREST for the rest),
with the JAX package's size formulas.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geo import rpc as rpc_mod
from ..geo.geodesy import (latlon_to_ecef, utm_from_latlon, sun_direction,
                           scaling_params, utm_zone_from_latlon)
from ..utils.geotiff import read_geotiff, read_pixels
from ..utils.resample import resize_linear, resize_nearest


# ----------------------------------------------------------------- metadata

# Per-AOI altitude-bound overrides applied when mod_alt_bound is set
# (sat_utils.py:58-74; keyed on aoi_id[1:] there, i.e. vendor-prefix
# agnostic).
_ALT_OVERRIDES = {
    "ji_012": {"max_alt": 210},
    "ji_021": {"max_alt": 210},
    "ji_006": {"max_alt": 220, "min_alt": 50},
    "ji_005": {"max_alt": 295, "min_alt": 55},
}


def read_meta_json(path: str, aoi_id: str = "",
                   mod_alt_bound: bool = False) -> dict:
    with open(path) as f:
        d = json.load(f)
    if mod_alt_bound and "min_alt" in d and "max_alt" in d:
        ov = _ALT_OVERRIDES.get(aoi_id[1:] if aoi_id else "")
        if ov:
            d.update(ov)
    return d


def _savez_atomic(path: str, **arrays) -> None:
    """np.savez to a temp name + os.replace: an interrupted run must never
    leave a truncated .npz at the final path (np.load on one raises
    zipfile.BadZipFile forever after)."""
    import tempfile
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path))
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _load_npz(path: str) -> Optional[dict]:
    """Cache read that treats a corrupt/unreadable .npz as a miss (the
    bad file is removed so the rebuild below repopulates it)."""
    import zipfile
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile, KeyError):
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def file_id(filename: str) -> str:
    return os.path.splitext(os.path.basename(filename))[0]


# ---------------------------------------------------------------- ray maker

def get_rays_np(cols, rows, rpc: rpc_mod.RPCModel, min_alt: float,
                max_alt: float, cs: str = "utm") -> np.ndarray:
    """(P,) pixel coords -> (P, 8) float64 rays [o, d, near=0, far=|far-near|].

    Origin = localization at max_alt (closest to the camera), far point =
    localization at min_alt; direction = normalized difference
    (satellite_rgb_dep.py:23-78).
    """
    cols = np.asarray(cols, np.float64)
    rows = np.asarray(rows, np.float64)
    lon_n, lat_n = rpc_mod.localization_np(rpc, cols, rows, max_alt)
    lon_f, lat_f = rpc_mod.localization_np(rpc, cols, rows, min_alt)
    if cs == "ecef":
        near = np.stack(latlon_to_ecef(lat_n, lon_n,
                                       np.full_like(lat_n, max_alt)), -1)
        far = np.stack(latlon_to_ecef(lat_f, lon_f,
                                      np.full_like(lat_f, min_alt)), -1)
    elif cs == "utm":
        zone, _ = utm_zone_from_latlon(float(lat_n.ravel()[0]),
                                       float(lon_n.ravel()[0]))
        e_n, n_n = utm_from_latlon(lat_n, lon_n, zone=zone)
        e_f, n_f = utm_from_latlon(lat_f, lon_f, zone=zone)
        near = np.stack([e_n, n_n, np.full_like(e_n, max_alt)], -1)
        far = np.stack([e_f, n_f, np.full_like(e_f, min_alt)], -1)
    else:
        raise ValueError(f"unknown coordinate system {cs}")
    d = far - near
    dist = np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate(
        [near, d / dist, np.zeros_like(dist), dist], axis=-1)
    return rays


# ----------------------------------------------------------- normalization

@dataclass
class SceneLoc:
    """Scene normalization: subtract center, divide by the max half-range
    (satellite.py:228-237 / satellite_rgb_dep.py:550-559)."""
    center: np.ndarray            # (3,) float64
    range: float

    def normalize_rays(self, rays: np.ndarray) -> np.ndarray:
        out = rays.copy()
        out[:, 0:3] = (out[:, 0:3] - self.center) / self.range
        out[:, 6:8] = out[:, 6:8] / self.range
        return out

    def normalize_points(self, pts: np.ndarray) -> np.ndarray:
        return (pts - self.center) / self.range

    def denormalize_points(self, pts: np.ndarray) -> np.ndarray:
        return pts * self.range + self.center

    def to_dict(self) -> dict:
        return {"X_scale": self.range, "X_offset": float(self.center[0]),
                "Y_scale": self.range, "Y_offset": float(self.center[1]),
                "Z_scale": self.range, "Z_offset": float(self.center[2])}

    @staticmethod
    def from_dict(d: dict) -> "SceneLoc":
        center = np.asarray([float(d["X_offset"]), float(d["Y_offset"]),
                             float(d["Z_offset"])], np.float64)
        rng = max(float(d["X_scale"]), float(d["Y_scale"]),
                  float(d["Z_scale"]))
        return SceneLoc(center=center, range=rng)


def compute_scene_loc(json_paths: List[str], img_downscale: float = 1.0,
                      cs: str = "utm", aoi_id: str = "",
                      mod_alt_bound: bool = False,
                      stride: int = 1) -> dict:
    """Build the scene.loc dict from all images' ray endpoints
    (satellite.py:141-164).  `stride` subsamples the pixel grid: the
    min/max of near+far endpoints over a regular subgrid equals the
    full-grid bounds to well under a meter for smooth RPC geometry, and
    cuts the one-time cost by stride^2."""
    all_pts = []
    for p in json_paths:
        d = read_meta_json(p, aoi_id, mod_alt_bound)
        h = int(d["height"] // img_downscale)
        w = int(d["width"] // img_downscale)
        rpc = rpc_mod.rescale_rpc(rpc_mod.rpc_from_dict(d["rpc"]),
                                  1.0 / img_downscale)
        cols, rows = np.meshgrid(np.arange(0, w, stride),
                                 np.arange(0, h, stride))
        rays = get_rays_np(cols.ravel(), rows.ravel(), rpc,
                           float(d["min_alt"]), float(d["max_alt"]), cs)
        near_pts = rays[:, 0:3]
        far_pts = rays[:, 0:3] + rays[:, 7:8] * rays[:, 3:6]
        all_pts.append(near_pts)
        all_pts.append(far_pts)
    pts = np.concatenate(all_pts, 0)
    out = {}
    for i, ax in enumerate("XYZ"):
        s, o = scaling_params(pts[:, i])
        out[f"{ax}_scale"], out[f"{ax}_offset"] = s, o
    return out


def load_or_create_scene_loc(json_dir: str, **kwargs) -> SceneLoc:
    """scene.loc is rebuilt when the settings it depends on change.

    The reference caches scene.loc keyed only by path (satellite.py:141),
    so toggling mod_alt_bound / img_downscale / cs silently reuses stale
    scene bounds there; here a `_fingerprint` field (an addition the
    reference's readers ignore — they pick named keys) invalidates it."""
    loc_path = os.path.join(json_dir, "scene.loc")
    fp = "|".join(f"{k}={kwargs.get(k)}" for k in
                  ("img_downscale", "cs", "aoi_id", "mod_alt_bound"))
    if os.path.exists(loc_path):
        with open(loc_path) as f:
            d = json.load(f)
        if d.get("_fingerprint", fp) == fp:   # legacy files: keep
            return SceneLoc.from_dict(d)
    json_paths = sorted(glob.glob(os.path.join(json_dir, "*.json")))
    d = compute_scene_loc(json_paths, **kwargs)
    d["_fingerprint"] = fp
    with open(loc_path, "w") as f:
        json.dump(d, f, indent=2)
    return SceneLoc.from_dict(d)


# -------------------------------------------------------------- image pixels

def scale_image(img: np.ndarray, scale: float = 1.0 / 255.0,
                bound: Tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """--scale modes (satellite_rgb_dep.py:87-105): const multiplier;
    scale==0 -> global min/max from `bound`; scale<0 -> per-channel minmax."""
    img = img.astype(np.float32)
    if abs(scale) < 1e-5:
        lo, hi = bound
        img = (img - lo) / (hi - lo)
    elif scale < 0:
        for i in range(img.shape[-1]):
            lo, hi = img[..., i].min(), img[..., i].max()
            img[..., i] = (img[..., i] - lo) / max(hi - lo, 1e-12)
    else:
        img = img * scale
    return np.clip(img, 0.0, 1.0)


def load_rgb(img_path: str, img_downscale: float = 1.0,
             scale: float = 1.0 / 255.0,
             bound: Tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """GeoTIFF -> flat (h*w, 3) floats in [0, 1] (satellite.py:67-80)."""
    arr, _ = read_geotiff(img_path)            # (bands, H, W)
    img = arr.transpose(1, 2, 0)
    if img.shape[-1] == 1:
        img = np.tile(img, (1, 1, 3))
    img = scale_image(img[..., :3], scale, bound)
    if img_downscale > 1:
        h = int(img.shape[0] // img_downscale)
        w = int(img.shape[1] // img_downscale)
        img = resize_linear(img, w, h)
    return img.reshape(-1, 3)


def pixel_value_bound(json_paths: List[str], img_dir: str,
                      aoi_id: str = "", mod_alt_bound: bool = False):
    """Global min/max over all split images (satellite_rgb_dep.py:287-309)."""
    lo, hi = np.inf, -np.inf
    for p in json_paths:
        d = read_meta_json(p, aoi_id, mod_alt_bound)
        arr, _ = read_geotiff(os.path.join(img_dir, d["img"]))
        lo = min(lo, float(arr.min()))
        hi = max(hi, float(arr.max()))
    return lo, hi


def load_mask(json_path: str, h: int, w: int) -> np.ndarray:
    """{json}_mask.tif -> flat bool (satellite_rgb_dep.py:263-285);
    all-ones when absent.  The pixels are those PIL gives
    (utils/geotiff.read_pixels: bool for a 1-bit mask under any
    compression, one band as (H, W), several as (H, W, bands)); a mask of
    another size than (h, w) is resized as cv2's INTER_NEAREST does
    (utils/resample)."""
    mask_p = json_path[:-5] + "_mask.tif"
    if not os.path.isfile(mask_p):
        return np.ones(h * w, bool)
    m = read_pixels(mask_p)
    if m.shape[:2] != (h, w):
        m = resize_nearest(m.astype(np.uint8), w, h)
    return (m.reshape(-1) > 0)


# ----------------------------------------------------------------- normals

def normals_from_grid_points(pts3d: np.ndarray,
                             valid: Optional[np.ndarray] = None):
    """GT surface normals from an (H, W, 3) grid of 3D points: average of
    the four cross products of unit steps to N/S/E/W neighbors
    (sat_utils.calc_normal_from_pts3d:16-50).  Returns (H*W, 3) normals
    (default +z where undefined) and an (H*W,) validity mask requiring all
    four neighbors valid."""
    h, w, _ = pts3d.shape
    if valid is None:
        valid = np.ones((h, w), np.float32)
    valid_nr = np.where(valid < 1e-5, valid, np.ones_like(valid))
    # reference QUIRK kept (sat_utils.py:24): the interior assignment
    # overwrites the center-validity term, so an interior pixel with an
    # INVALID center but 4 valid neighbors is still flagged valid — its
    # normal is then computed against the hole's zero point.  Rare in
    # practice (MicMac holes cluster), and changing it would diverge from
    # the reference's normal-supervision masks.
    inner = (valid[2:, 1:-1] * valid[:-2, 1:-1]
             * valid[1:-1, 2:] * valid[1:-1, :-2])
    valid_nr[1:-1, 1:-1] = inner

    def unit(v):
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(n, 1.1920929e-07 ** 0.5)

    c = pts3d[1:-1, 1:-1]
    south = unit(pts3d[2:, 1:-1] - c)
    north = unit(pts3d[:-2, 1:-1] - c)
    east = unit(pts3d[1:-1, 2:] - c)
    west = unit(pts3d[1:-1, :-2] - c)
    n_mean = (unit(np.cross(east, north)) + unit(np.cross(west, south))
              + unit(np.cross(north, west)) + unit(np.cross(south, east)))
    n_mean = unit(n_mean / 4.0)
    normals = np.zeros_like(pts3d)
    normals[1:-1, 1:-1] = n_mean
    out = np.zeros((h * w, 3), np.float32)
    out[:, 2] = 1.0
    flat_n = normals.reshape(-1, 3)
    flat_v = valid_nr.reshape(-1)
    sel = flat_v > 0
    out[sel] = flat_n[sel]
    return out, flat_v.astype(np.float32)


# ------------------------------------------------------------ depth loading

def _resize_flat(flat: np.ndarray, h: int, w: int, downscale: float,
                 nearest: bool = True) -> np.ndarray:
    """Downscale an (h*w, C) per-pixel field to the working resolution.
    The reference uses torch interpolate default 'nearest'
    (satellite_rgb_dep.py:397-399)."""
    if downscale <= 1:
        return flat
    nh, nw = int(h / downscale), int(w / downscale)
    img = flat.reshape(h, w, -1)
    out = (resize_nearest if nearest else resize_linear)(img, nw, nh)
    if out.ndim == 2:
        out = out[..., None]
    return out.reshape(nh * nw, flat.shape[-1] if flat.ndim > 1 else 1)


def load_depth_files(depth_dir: str, img_id: str, cs: str = "utm"):
    """Parse the MicMac triplet for one image (satellite_rgb_dep.py:419-427).
    Returns (pts2d (P,2) int, pts3d (P,3) float64, correl (P,))."""
    pts2d = np.loadtxt(os.path.join(depth_dir, img_id + "_2DPts.txt"),
                       dtype=np.int64).reshape(-1, 2)
    suffix = "_3DPts_ecef.txt" if cs == "ecef" else "_3DPts.txt"
    pts3d = np.loadtxt(os.path.join(depth_dir, img_id + suffix),
                       dtype=np.float64).reshape(-1, 3)
    correl = np.loadtxt(os.path.join(depth_dir, img_id + "_Correl.txt"),
                        dtype=np.float64).reshape(-1)
    return pts2d, pts3d, correl


def build_depth_arrays(meta: dict, depth_dir: str, scene: SceneLoc,
                       img_downscale: float = 1.0, cs: str = "utm",
                       corrscale: float = 1.0, stdscale: float = 1.0,
                       margin: float = 0.0001, std_quirk: bool = True):
    """Dense depth supervision for one image, padded to the full pixel grid
    (satellite_rgb_dep.py:401-548).

    Returns dict with flat (h*w, .) arrays: depths (2: [depth, weight]),
    valid_depth, depth_std, normals (3), valid_normal.
    """
    h, w = int(meta["height"]), int(meta["width"])
    img_id = file_id(meta["img"])
    pts2d, pts3d, correl = load_depth_files(depth_dir, img_id, cs)

    valid = np.zeros(h * w, np.float32)
    flat_idx = pts2d[:, 1] * w + pts2d[:, 0]
    valid[flat_idx] = 1.0

    # correlation -> weight: minmax then corrscale (satellite_rgb_dep.py:433-436)
    c_lo, c_hi = correl.min(), correl.max()
    weights = corrscale * (correl - c_lo) / max(c_hi - c_lo, 1e-12)

    rpc = rpc_mod.rescale_rpc(rpc_mod.rpc_from_dict(meta["rpc"]),
                              1.0 / img_downscale)
    cols = pts2d[:, 0] / img_downscale
    rows = pts2d[:, 1] / img_downscale
    rays = get_rays_np(cols, rows, rpc, float(meta["min_alt"]),
                       float(meta["max_alt"]), cs)
    rays = scene.normalize_rays(rays)

    pts3d_n = scene.normalize_points(pts3d)
    depths = np.linalg.norm(pts3d_n - rays[:, 0:3], axis=1).astype(np.float32)

    # extra weighting by ray-to-nadir cosine (satellite_rgb_dep.py:479-492)
    nadir_cos = -rays[:, 5]            # dot(rays_d, [0,0,-1])
    weights = (weights * nadir_cos).astype(np.float32)

    std = (stdscale * (1.0 - weights) + margin).astype(np.float32)
    if std_quirk:
        # reproduce all_depth_stds * (depth_max - depth_min) with both 0
        # (satellite_rgb_dep.py:407-408,539)
        std = np.zeros_like(std)

    def pad(vals, fill=0.0, c=1):
        out = np.full((h * w, c), fill, np.float32)
        out[flat_idx] = vals.reshape(-1, c).astype(np.float32)
        return out

    depths_padded = pad(depths, fill=float(depths.mean()))
    weights_padded = pad(weights)
    std_padded = pad(std)

    pts3d_padded = np.zeros((h * w, 3), np.float32)
    pts3d_padded[flat_idx] = pts3d_n.astype(np.float32)
    normals, valid_normal = normals_from_grid_points(
        pts3d_padded.reshape(h, w, 3), valid.reshape(h, w))

    ds = img_downscale
    return {
        "depths": np.concatenate(
            [_resize_flat(depths_padded, h, w, ds),
             _resize_flat(weights_padded, h, w, ds)], axis=1),
        "valid_depth": _resize_flat(valid[:, None], h, w, ds)[:, 0],
        "depth_std": _resize_flat(std_padded, h, w, ds)[:, 0],
        "normals": _resize_flat(normals, h, w, ds),
        "valid_normal": _resize_flat(valid_normal[:, None], h, w, ds)[:, 0],
    }


# ------------------------------------------------------------------ dataset

@dataclass
class SatelliteConfig:
    root_dir: str                      # json + split + scene.loc directory
    img_dir: Optional[str] = None
    cache_dir: Optional[str] = None    # per-image ray cache (reference
    # caches via torch.save keyed by img_id, satellite.py:195-206 — its
    # cache READ is disabled (`if 0:`); here the cache actually works)
    depth_subdir: str = "DenseDepth_ZM4"   # --inputdds (opt.py:205-206)
    aoi_id: str = "Dji_012"
    cs: str = "utm"                    # --cs
    img_downscale: float = 1.0
    scale: float = 1.0 / 255.0         # --scale pixel-value mode
    corrscale: float = 1.0             # opt.py:223-224
    stdscale: float = 1.0
    margin: float = 0.0001
    mod_alt_bound: bool = False
    infile_postfix: str = ".txt"
    std_quirk: bool = True
    load_depth: bool = True
    sparse_depth: bool = False         # sat-nerf keypoint mode
    scene_loc_stride: int = 4


def _read_split(cfg: SatelliteConfig, name: str) -> List[str]:
    path = os.path.join(cfg.root_dir, f"{name}{cfg.infile_postfix}")
    with open(path) as f:
        names = [ln for ln in f.read().split("\n") if ln.strip()]
    return [os.path.join(cfg.root_dir, n) for n in names]


class SatelliteDataset:
    """Unified satellite loader (covers SatelliteDataset /
    SatelliteDataset_depth / SatelliteRGBDEPDataset roles).

    split='train': `.store` is a dict of aligned flat per-pixel arrays over
    all training images — rays (N,11) float32, rgbs (N,3), ts (N,), rows,
    cols, and (when load_depth) depths (N,2), valid_depth, depth_std,
    normals (N,3), valid_normal.

    split='val': per-image samples via get_image(i); item 0 is a training
    image for fit-vs-generalization debugging (satellite_rgb_dep.py:193-208),
    flagged is_val=False.
    """

    def __init__(self, cfg: SatelliteConfig, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.img_dir = cfg.img_dir or cfg.root_dir
        self.depth_dir = os.path.join(cfg.root_dir, cfg.depth_subdir)
        self.scene = load_or_create_scene_loc(
            cfg.root_dir, img_downscale=cfg.img_downscale, cs=cfg.cs,
            aoi_id=cfg.aoi_id, mod_alt_bound=cfg.mod_alt_bound,
            stride=cfg.scene_loc_stride)
        self.train_files = _read_split(cfg, "train")
        self.test_files = _read_split(cfg, "test")
        self._bound = (0.0, 1.0)
        if abs(cfg.scale) < 1e-5:
            self._bound = pixel_value_bound(
                self.train_files + self.test_files, self.img_dir,
                cfg.aoi_id, cfg.mod_alt_bound)
        # UTM zone for DSM reconstruction, from the first image's rays
        self.utm_zone: Optional[Tuple[int, str]] = None
        self.depth_store: Optional[Dict[str, np.ndarray]] = None
        if split == "train":
            self.store = self._load_images(self.train_files)
            if cfg.sparse_depth:
                # sat-nerf keypoint mode: a separate store of tie-point rays
                # with bundle-adjustment depths and confidence weights; the
                # trainer draws a sub-batch from it each step, which the
                # step renders a second time for the depth loss (reference:
                # datasets/__init__.py:19-26, main.py:177-183,256-262)
                sparse = load_sparse_depth(
                    self.train_files, cfg.root_dir, self.scene,
                    cfg.img_downscale, cfg.cs, cfg.aoi_id,
                    cfg.mod_alt_bound)
                self.depth_store = {"rays": sparse["rays"],
                                    "depths": sparse["depths"],
                                    "ts": sparse["ts"]}
        elif split == "train_render":
            # eval --split train: render every TRAINING image as a full
            # image (eval.py:238-249 split selection)
            self.val_files = list(self.train_files)
            self.val_ids = list(range(len(self.train_files)))
        else:
            self.val_files = [self.train_files[0]] + self.test_files
            self.val_ids = [0] + [len(self.train_files) + i
                                  for i in range(len(self.test_files))]

    # -- shared per-image loaders ------------------------------------

    def _image_meta(self, json_p: str) -> dict:
        return read_meta_json(json_p, self.cfg.aoi_id,
                              self.cfg.mod_alt_bound)

    def _image_rays(self, meta: dict) -> Tuple[np.ndarray, int, int,
                                               np.ndarray, np.ndarray]:
        cfg = self.cfg
        h = int(meta["height"] // cfg.img_downscale)
        w = int(meta["width"] // cfg.img_downscale)
        rpc = rpc_mod.rescale_rpc(rpc_mod.rpc_from_dict(meta["rpc"]),
                                  1.0 / cfg.img_downscale)
        cols, rows = np.meshgrid(np.arange(w), np.arange(h))
        cols, rows = cols.ravel(), rows.ravel()
        cache_p = None
        if cfg.cache_dir:
            os.makedirs(cfg.cache_dir, exist_ok=True)
            # mod_alt_bound changes the near/far altitudes the rays are
            # built from, so it must be part of the cache key — otherwise
            # a cache built under one setting is silently reused under
            # the other with inconsistent geometry
            cache_p = os.path.join(
                cfg.cache_dir,
                f"{file_id(meta['img'])}_ds{cfg.img_downscale:g}"
                f"_{cfg.cs}_mab{int(bool(cfg.mod_alt_bound))}.npz")
        cached = (_load_npz(cache_p)
                  if cache_p and os.path.exists(cache_p) else None)
        if cached is not None:
            rays = cached["rays"]
        else:
            rays = get_rays_np(cols, rows, rpc, float(meta["min_alt"]),
                               float(meta["max_alt"]), cfg.cs)
            if cache_p:
                _savez_atomic(cache_p, rays=rays)
        if self.utm_zone is None and cfg.cs == "utm":
            # under the thread-pooled loader images race here; the zone is
            # a scene-wide property (same for every view of the AOI), so a
            # benign last-writer-wins assignment of an identical value
            lon, lat = rpc_mod.localization_np(
                rpc, np.asarray([cols[0]]), np.asarray([rows[0]]),
                float(meta["min_alt"]))
            self.utm_zone = utm_zone_from_latlon(float(lat[0]), float(lon[0]))
        rays = self.scene.normalize_rays(rays).astype(np.float32)
        return rays, h, w, cols, rows

    def _depth_arrays_cached(self, meta: dict) -> Dict[str, np.ndarray]:
        """`build_depth_arrays` behind the per-image cache: the dense-depth
        supervision re-runs Newton RPC localization over every MicMac
        point, which dominates warm-start ingestion once the ray cache
        hits.  The key carries every input that shapes the arrays (incl.
        the scene normalization and the depth files' mtimes, so an edited
        triplet or a recomputed scene.loc invalidates)."""
        cfg = self.cfg
        if not cfg.cache_dir:
            return build_depth_arrays(
                meta, self.depth_dir, self.scene, cfg.img_downscale,
                cfg.cs, cfg.corrscale, cfg.stdscale, cfg.margin,
                cfg.std_quirk)
        import hashlib
        img_id = file_id(meta["img"])
        suffix = "_3DPts_ecef.txt" if cfg.cs == "ecef" else "_3DPts.txt"
        mtimes = [
            os.path.getmtime(os.path.join(self.depth_dir, img_id + s))
            for s in ("_2DPts.txt", suffix, "_Correl.txt")]
        key = hashlib.sha256(repr((
            cfg.img_downscale, cfg.cs, cfg.corrscale, cfg.stdscale,
            cfg.margin, cfg.std_quirk, sorted(self.scene.to_dict().items()),
            float(meta["min_alt"]), float(meta["max_alt"]), mtimes,
            sorted((k, repr(v)) for k, v in meta["rpc"].items()),
        )).encode()).hexdigest()[:16]
        os.makedirs(cfg.cache_dir, exist_ok=True)
        cache_p = os.path.join(cfg.cache_dir, f"{img_id}_depth_{key}.npz")
        if os.path.exists(cache_p):
            cached = _load_npz(cache_p)
            if cached is not None:
                return cached
        arrays = build_depth_arrays(
            meta, self.depth_dir, self.scene, cfg.img_downscale,
            cfg.cs, cfg.corrscale, cfg.stdscale, cfg.margin,
            cfg.std_quirk)
        _savez_atomic(cache_p, **arrays)
        return arrays

    def _load_one(self, t: int, json_p: str, with_depth: bool,
                  depth_required: bool = False) -> Dict:
        cfg = self.cfg
        meta = self._image_meta(json_p)
        rays, h, w, cols, rows = self._image_rays(meta)
        rgbs = load_rgb(os.path.join(self.img_dir, meta["img"]),
                        cfg.img_downscale, cfg.scale, self._bound)
        sun = sun_direction(float(meta["sun_elevation"]),
                            float(meta["sun_azimuth"])).astype(np.float32)
        sun_dirs = np.tile(sun.reshape(1, 3), (rays.shape[0], 1))
        out = {
            "rays": np.concatenate([rays, sun_dirs], axis=1),
            "rgbs": rgbs.astype(np.float32),
            "ts": np.full(rays.shape[0], t, np.int32),
            "rows": rows.astype(np.int32), "cols": cols.astype(np.int32),
            "h": h, "w": w, "src_id": file_id(meta["img"]),
            "meta": meta,
        }
        if with_depth:
            try:
                out.update(self._depth_arrays_cached(meta))
            except (OSError, IOError) as e:
                # Validation images may legitimately have no MicMac depth
                # triplet; for TRAINING images a missing triplet would
                # silently drop depth supervision for the whole store (the
                # reference fails loudly at load, satellite_rgb_dep.py) —
                # fail loudly here too.
                if depth_required:
                    raise RuntimeError(
                        f"load_depth is set but MicMac depth files for "
                        f"training image {meta['img']!r} could not be read "
                        f"from {self.depth_dir}: {e}") from e
        return out

    def _load_images(self, json_files: List[str]) -> Dict[str, np.ndarray]:
        # per-image ingestion is independent and NumPy/BLAS-bound (Newton
        # RPC localization, GEMM poly evaluation, file parsing — all GIL-
        # releasing), so images load concurrently; results keep list order
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=min(len(json_files), os.cpu_count() or 4)) as ex:
            parts = list(ex.map(
                lambda tp: self._load_one(tp[0], tp[1], self.cfg.load_depth,
                                          depth_required=self.cfg.load_depth),
                enumerate(json_files)))
        keys = ["rays", "rgbs", "ts", "rows", "cols"]
        if self.cfg.load_depth and all("depths" in p for p in parts):
            keys += ["depths", "valid_depth", "depth_std", "normals",
                     "valid_normal"]
        return {k: np.concatenate([p[k] for p in parts], 0) for k in keys}

    # -- val interface ------------------------------------------------

    def __len__(self):
        if self.split == "train":
            return self.store["rays"].shape[0]
        return len(self.val_files)

    def get_image(self, idx: int) -> Dict:
        """One full validation image with mask + depth arrays."""
        json_p = self.val_files[idx]
        sample = self._load_one(self.val_ids[idx], json_p,
                                self.cfg.load_depth)
        sample["mask"] = load_mask(json_p, sample["h"], sample["w"])
        sample["is_val"] = (self.split != "train_render") and idx > 0
        sample["save_cross"] = idx == 0
        sample["idx"] = idx
        return sample


# --------------------------------------------- sparse keypoint depth (sat-nerf)

def _keypoint_weights(json_files: List[str], pts3d: np.ndarray,
                      aoi_id: str = "", mod_alt_bound: bool = False
                      ) -> np.ndarray:
    """Per-tie-point confidence from bundle-adjustment reprojection errors:
    w_p = exp(-(e_p / mean(e))^2), e_p summed over the observing cameras
    (satellite_depth.py:103-129).  pts3d: ECEF (the BA output
    convention)."""
    from ..geo.geodesy import ecef_to_latlon
    errors = np.zeros((pts3d.shape[0], len(json_files)), np.float64)
    for t, json_p in enumerate(json_files):
        d = read_meta_json(json_p, aoi_id, mod_alt_bound)
        kp = d["keypoints"]
        idx = np.asarray(kp.get("pts3d_indices", kp.get("pts_indices")),
                         np.int64)
        obs = np.asarray(kp["2d_coordinates"], np.float64)
        rpc = rpc_mod.rpc_from_dict(d["rpc"])
        lat, lon, alt = ecef_to_latlon(pts3d[idx, 0], pts3d[idx, 1],
                                       pts3d[idx, 2])
        col, row = rpc_mod.projection_np(rpc, lon, lat, alt)
        errors[idx, t] = np.linalg.norm(obs - np.stack([col, row], -1),
                                        axis=1)
    e = errors.sum(axis=1)
    return np.exp(-(e / max(e.mean(), 1e-12)) ** 2)


def load_sparse_depth(json_files: List[str], root_dir: str, scene: SceneLoc,
                      img_downscale: float = 1.0, cs: str = "utm",
                      aoi_id: str = "", mod_alt_bound: bool = False):
    """Bundle-adjustment keypoint depth supervision (SatelliteDataset_depth,
    datasets/satellite_depth.py:46-129): rays at the keypoint pixels, depth
    |pts3d_norm - o|, weights exp(-(e/ebar)^2) of the reprojection errors.
    pts3d.npy holds ECEF tie points (the sat-bundleadjust convention),
    converted to UTM before normalization when cs == 'utm'.  Returns
    {rays (K, 8), depths (K, 2) [depth, weight], ts (K,) image index,
    kp_indices (K,) tie-point index}."""
    pts3d_ecef = np.load(os.path.join(root_dir, "pts3d.npy"))   # (P, 3)
    if cs == "utm":
        from ..geo.geodesy import ecef_to_latlon
        lat, lon, alt = ecef_to_latlon(pts3d_ecef[:, 0], pts3d_ecef[:, 1],
                                       pts3d_ecef[:, 2])
        e, n = utm_from_latlon(lat, lon)
        pts3d = np.stack([e, n, alt], -1)
    else:
        pts3d = pts3d_ecef
    try:
        kp_w = _keypoint_weights(json_files, pts3d_ecef, aoi_id,
                                 mod_alt_bound)
    except (KeyError, ValueError):
        kp_w = np.ones(pts3d.shape[0])
    rays_l, depths_l, weights_l, ts_l, idx_l = [], [], [], [], []
    for t, json_p in enumerate(json_files):
        d = read_meta_json(json_p, aoi_id, mod_alt_bound)
        if "keypoints" not in d:
            raise FileNotFoundError(f"no keypoints in {json_p}")
        kp = d["keypoints"]
        pix = np.asarray(kp["2d_coordinates"], np.float64)
        idx = np.asarray(kp.get("pts3d_indices", kp.get("pts_indices")),
                         np.int64)
        rpc = rpc_mod.rescale_rpc(rpc_mod.rpc_from_dict(d["rpc"]),
                                  1.0 / img_downscale)
        rays = get_rays_np(pix[:, 0] / img_downscale,
                           pix[:, 1] / img_downscale, rpc,
                           float(d["min_alt"]), float(d["max_alt"]), cs)
        rays = scene.normalize_rays(rays).astype(np.float32)
        p3 = scene.normalize_points(pts3d[idx]).astype(np.float32)
        rays_l.append(rays)
        depths_l.append(np.linalg.norm(p3 - rays[:, 0:3], axis=1))
        weights_l.append(kp_w[idx].astype(np.float32))
        idx_l.append(idx)
        ts_l.append(np.full(rays.shape[0], t, np.int32))
    depths = np.concatenate(depths_l, 0)
    weights = np.concatenate(weights_l, 0)
    return {"rays": np.concatenate(rays_l, 0),
            "depths": np.stack([depths, weights], 1),
            "ts": np.concatenate(ts_l, 0),
            "kp_indices": np.concatenate(idx_l, 0)}
