"""Offline dataset generation: per-image JSON metadata, footprint masks,
train/test splits, DSM crops (reference: generate_dataset.py:90-508); the
port's copy of the JAX package's dataset_gen.py, NumPy only.

The reference's pipeline is: crop DSM + image patches -> (optional) external
`sat-bundleadjust` -> per-image JSON (img/h/w/sun angles/geojson footprint/
alt bounds from the DSM/rpc + keypoints) -> footprint masks -> random
splits.  Bundle adjustment remains an external tool there (separate conda
env, setup_ba_env.sh) and here; this module consumes its outputs
(rpcs_adj/*.rpc_adj, pts3d.npy, keypoint arrays) when present and otherwise
emits JSONs with the original RPCs; run_ba returns None where
`bundle_adjust` or `rpcm` does not import, as the JAX package's does.

The mask generator tests every pixel against the footprint polygon at once
(vectorized ray casting; the reference loops cv2.pointPolygonTest over
pixels, generate_dataset.py:213-216), and writes the {json}_mask.tif masks
through utils/geotiff (one uint8 band, the pixels PIL reads from the JAX
package's masks; the JAX package saves them with PIL).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .geo import rpc as rpc_mod
from .utils.geotiff import read_geotiff, write_geotiff, GeoProfile


def image_footprint_geojson(rpc: rpc_mod.RPCModel, h: int, w: int,
                            z: float = 0.0) -> Dict:
    """Lon/lat polygon of the image corners at altitude z
    (get_image_lonlat_aoi analog)."""
    cols = np.asarray([0, w - 1, w - 1, 0], np.float64)
    rows = np.asarray([0, 0, h - 1, h - 1], np.float64)
    lon, lat = rpc_mod.localization_np(rpc, cols, rows, z)
    coords = [[float(lo), float(la)] for lo, la in zip(lon, lat)]
    coords.append(coords[0])
    center = [float(np.mean(lon)), float(np.mean(lat))]
    return {"type": "Polygon", "coordinates": [coords], "center": center}


def create_image_json(img_path: str, rpc_dict: Dict, sun_elevation: float,
                      sun_azimuth: float, out_dir: str,
                      dsm_path: Optional[str] = None,
                      min_alt: Optional[float] = None,
                      max_alt: Optional[float] = None,
                      acquisition_date: str = "20130126",
                      keypoints: Optional[Dict] = None) -> str:
    """Emit one per-image metadata JSON (generate_dataset.py:120-170)."""
    arr, _ = read_geotiff(img_path)
    _, h, w = arr.shape
    if (min_alt is None or max_alt is None) and dsm_path:
        dsm_arr, _ = read_geotiff(dsm_path)
        dsm = dsm_arr[0][np.isfinite(dsm_arr[0])]
        min_alt = int(np.round(dsm.min() - 1)) if min_alt is None else min_alt
        max_alt = int(np.round(dsm.max() + 1)) if max_alt is None else max_alt
    if min_alt is None or max_alt is None:
        raise ValueError(
            "create_image_json needs the scene altitude bounds: pass "
            "min_alt/max_alt explicitly or dsm_path to derive them")
    rpc = rpc_mod.rpc_from_dict(rpc_dict)
    d = {
        "img": os.path.basename(img_path),
        "height": int(h), "width": int(w),
        "sun_elevation": float(sun_elevation),
        "sun_azimuth": float(sun_azimuth),
        "acquisition_date": acquisition_date,
        "geojson": image_footprint_geojson(rpc, h, w,
                                           z=0.5 * (min_alt + max_alt)),
        "min_alt": float(min_alt), "max_alt": float(max_alt),
        "rpc": rpc_dict,
    }
    if keypoints is not None:
        d["keypoints"] = keypoints
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(img_path))[0] + ".json"
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
    return path


def load_sun_angle_table(path: str) -> Dict[str, Tuple[float, float]]:
    """pleiades_sun_angles.txt: rows of (img_substring, elevation, azimuth)
    (generate_dataset.py:117-141)."""
    table = {}
    rows = np.loadtxt(path, dtype=str)
    if rows.ndim == 1:
        rows = rows[None]
    for row in rows:
        table[row[0]] = (float(row[1]), float(row[2]))
    return table


def _lookup_sun_angles(table: Optional[Dict], img_id: str,
                       default=(45.0, 180.0)) -> Tuple[float, float]:
    """Sun angles for an image id: exact key first, then SUBSTRING match —
    the reference's pleiades_sun_angles.txt rows carry substrings of the
    image names (generate_dataset.py:117-141), so an exact .get() would
    silently hand every image the default geometry."""
    if not table:
        return default
    if img_id in table:
        return table[img_id]
    # LONGEST matching key wins (a short key that is a substring of a
    # longer one must not shadow it), and ambiguity is reported instead of
    # silently resolved by dict iteration order
    matches = [key for key in table if key in img_id]
    if not matches:
        return default
    best = max(matches, key=len)
    others = [k for k in matches if len(k) == len(best) and k != best]
    if others:
        print(f"[dataset_gen] WARNING: sun-angle table keys {others + [best]}"
              f" all match image '{img_id}'; using '{best}'")
    return table[best]


def _points_in_polygon(px: np.ndarray, py: np.ndarray,
                       poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd ray casting; px/py flat, poly (V, 2)."""
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(px.shape, bool)
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        cond = ((ay > py) != (by > py)) & (
            px < (bx - ax) * (py - ay) / (by - ay + 1e-30) + ax)
        inside ^= cond
    return inside


def generate_footprint_masks(json_dir: str, ref_json: str) -> List[str]:
    """{json}_mask.tif masks marking the reference (most-nadir) image's
    footprint in every other image (generate_dataset.py:176-218).

    ref_json: filename of the reference image's JSON inside json_dir.
    """
    with open(os.path.join(json_dir, ref_json)) as f:
        ref = json.load(f)
    alt = 0.5 * (float(ref["min_alt"]) + float(ref["max_alt"]))
    if "geojson" not in ref:     # derive the footprint from the RPC
        ref_rpc = rpc_mod.rpc_from_dict(ref["rpc"])
        ref["geojson"] = image_footprint_geojson(
            ref_rpc, int(ref["height"]), int(ref["width"]), z=alt)
    poly_ll = np.asarray(ref["geojson"]["coordinates"][0], np.float64)
    lon, lat = poly_ll[:, 0], poly_ll[:, 1]

    out = []
    for json_p in sorted(glob.glob(os.path.join(json_dir, "*.json"))):
        with open(json_p) as f:
            d = json.load(f)
        h, w = int(d["height"]), int(d["width"])
        rpc = rpc_mod.rpc_from_dict(d["rpc"])
        col, row = rpc_mod.projection_np(rpc, lon, lat,
                                         np.full_like(lon, alt))
        poly = np.stack([np.asarray(col), np.asarray(row)], -1)
        cols, rows = np.meshgrid(np.arange(w, dtype=np.float64),
                                 np.arange(h, dtype=np.float64))
        inside = _points_in_polygon(cols.ravel(), rows.ravel(), poly)
        mask = (inside.reshape(h, w) * 255).astype(np.uint8)
        mask_p = json_p[:-5] + "_mask.tif"
        write_geotiff(mask_p, mask)
        out.append(mask_p)
    return out


def create_train_test_splits(sample_ids: Sequence[str],
                             test_percent: float = 0.15,
                             min_test_samples: int = 2,
                             seed: Optional[int] = None):
    """Random split (generate_dataset.py:220-240)."""
    ids = list(sample_ids)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ids))
    n_test = max(min_test_samples, int(test_percent * len(ids)))
    train = [ids[i] for i in idx[:len(ids) - n_test]]
    test = [ids[i] for i in idx[len(ids) - n_test:]]
    return train, test


def write_splits(json_dir: str, train: Sequence[str], test: Sequence[str],
                 postfix: str = ".txt"):
    with open(os.path.join(json_dir, f"train{postfix}"), "w") as f:
        f.write("".join(n + "\n" for n in train))
    with open(os.path.join(json_dir, f"test{postfix}"), "w") as f:
        f.write("".join(n + "\n" for n in test))


def crop_dsm(dsm_path: str, out_path: str, ulx: float, uly: float,
             xsize: int, ysize: int, write_roi_txt: bool = True) -> str:
    """Crop a GT DSM to an AOI window + emit the {aoi}_DSM.txt ROI metadata
    (CropDSM analog, generate_dataset.py:438-481)."""
    from .geo.dsm import crop_to_roi
    arr, prof = read_geotiff(dsm_path)
    out = crop_to_roi(arr[0].astype(np.float32), prof, ulx, uly,
                      xsize, ysize)
    res = prof.xres
    new_prof = GeoProfile(width=xsize, height=ysize, ulx=ulx, uly=uly,
                          xres=res, yres=prof.yres, epsg=prof.epsg,
                          nodata=float("nan"))
    write_geotiff(out_path, out[None], new_prof)
    if write_roi_txt:
        roi_txt = os.path.splitext(out_path)[0] + ".txt"
        np.savetxt(roi_txt,
                   np.asarray([ulx, uly - ysize * prof.yres, xsize, res]))
    return out_path


def run_ba(img_dir: str, output_dir: str) -> Optional[str]:
    """Drive the external bundle-adjustment pipeline in-process with the
    reference's exact config contract (generate_dataset.py:40-86):
    feature-tracks config {FT_reset: False, FT_save: True, s2p SIFT,
    epipolar matching}, cam_model='rpc', artifacts harvested into
    <output_dir>/ba_files/ba_params (pts_ind/cam_ind/pts3d/pts2d npys +
    geotiff_paths.txt; rpcs_adj/ written by the pipeline itself).

    The `bundle_adjust` package lives in a separate conda env in the
    reference too (setup_ba_env.sh); when it (or rpcm) is not importable
    here, returns None and the caller degrades to consuming a
    pre-existing ba_output directory.
    """
    try:
        from bundle_adjust.cam_utils import SatelliteImage
        from bundle_adjust.ba_pipeline import BundleAdjustmentPipeline
        from bundle_adjust import loader
        import rpcm
    except ImportError as e:
        print(f"[dataset_gen] bundle_adjust unavailable ({e}); skipping "
              f"BA — supply ba_files/ (rpcs_adj + ba_params) from an "
              f"external sat-bundleadjust run instead")
        return None

    os.makedirs(output_dir, exist_ok=True)
    myimages = sorted(glob.glob(os.path.join(img_dir, "*.tif")))
    if not myimages:
        print(f"[dataset_gen] no .tif images under {img_dir}; skipping BA")
        return None
    # RPC source: embedded GeoTIFF tags like the reference
    # (generate_dataset.py:50), falling back to the RPC00B sidecars this
    # CLI supports (provider imagery often ships RPCs as sidecars, and
    # our own GeoTIFF codec does not embed RPC tags); either way a
    # missing RPC degrades to skipping BA instead of crashing
    myrpcs = []
    for p in myimages:
        try:
            myrpcs.append(rpcm.rpc_from_geotiff(p))
            continue
        except Exception as e:
            sidecar = find_rpc_sidecar(p)
            if sidecar is None:
                print(f"[dataset_gen] no RPC for {p} (geotiff tags: {e}; "
                      f"no sidecar); skipping BA")
                return None
        # rpcm's native dict field names match parse_rpc_file's output
        # (row_offset/col_scale/... + row_num/..., rpcm rpc_model.py)
        myrpcs.append(rpcm.RPCModel(parse_rpc_file(sidecar),
                                    dict_format="rpcm"))
    input_images = [SatelliteImage(fn, rpc)
                    for fn, rpc in zip(myimages, myrpcs)]
    ba_input_data = {
        "in_dir": img_dir,
        "out_dir": os.path.join(output_dir, "ba_files"),
        "images": input_images,
    }
    os.makedirs(ba_input_data["out_dir"], exist_ok=True)
    log_path = os.path.join(ba_input_data["out_dir"], "bundle_adjust.log")
    print(f"[dataset_gen] running bundle adjustment (log: {log_path})")
    tracks_config = {"FT_reset": False, "FT_save": True,
                     "FT_sift_detection": "s2p",
                     "FT_sift_matching": "epipolar_based"}
    ba_extra = {"cam_model": "rpc"}
    import contextlib
    with open(log_path, "w+") as log_file, \
            contextlib.redirect_stdout(log_file), \
            contextlib.redirect_stderr(log_file):
        ba_pipeline = BundleAdjustmentPipeline(
            ba_input_data, tracks_config=tracks_config,
            extra_ba_config=ba_extra)
        ba_pipeline.run()

    ba_params_dir = os.path.join(ba_pipeline.out_dir, "ba_params")
    os.makedirs(ba_params_dir, exist_ok=True)
    np.save(os.path.join(ba_params_dir, "pts_ind.npy"),
            ba_pipeline.ba_params.pts_ind)
    np.save(os.path.join(ba_params_dir, "cam_ind.npy"),
            ba_pipeline.ba_params.cam_ind)
    np.save(os.path.join(ba_params_dir, "pts3d.npy"),
            ba_pipeline.ba_params.pts3d_ba - ba_pipeline.global_transform)
    np.save(os.path.join(ba_params_dir, "pts2d.npy"),
            ba_pipeline.ba_params.pts2d)
    fnames = [ba_pipeline.images[idx].geotiff_path
              for idx in ba_pipeline.ba_params.cam_prev_indices]
    loader.save_list_of_paths(
        os.path.join(ba_params_dir, "geotiff_paths.txt"), fnames)
    print(f"[dataset_gen] BA done: {ba_input_data['out_dir']}")
    return output_dir


def apply_ba_to_dataset(root_dir: str, ba_output_dir: str) -> int:
    """Fold a finished BA run into an emitted dataset root: per-image JSON
    rpc fields replaced by rpcs_adj, keypoints attached
    ({2d_coordinates, pts3d_indices} split by cam index), and pts3d.npy
    copied next to the JSONs — the reference's create_dataset use_ba
    branch (generate_dataset.py:99-105,150-166).  Returns the number of
    JSONs updated."""
    import json as json_mod
    import shutil
    params_dir = os.path.join(ba_output_dir, "ba_files", "ba_params")
    paths_txt = os.path.join(params_dir, "geotiff_paths.txt")
    if not os.path.exists(paths_txt):
        print(f"[dataset_gen] no ba_params under {ba_output_dir}; "
              f"nothing applied")
        return 0
    with open(paths_txt) as f:
        paths = [l.strip() for l in f if l.strip()]
    # sat-bundleadjust adjusts the PAN crops; the NeRF datasets consume
    # the RGB crops — map the recorded paths like the reference before
    # basename matching (generate_dataset.py:102-104), else every real
    # BA run's keypoints would be silently dropped
    paths = [p.replace("/pan_crops/", "/crops/") for p in paths]
    paths = [p.replace("PAN.tif", "RGB.tif") for p in paths]
    basenames = [os.path.basename(p) for p in paths]
    pts_ind = np.load(os.path.join(params_dir, "pts_ind.npy"))
    cam_ind = np.load(os.path.join(params_dir, "cam_ind.npy"))
    pts2d = np.load(os.path.join(params_dir, "pts2d.npy"))
    shutil.copyfile(os.path.join(params_dir, "pts3d.npy"),
                    os.path.join(root_dir, "pts3d.npy"))
    n = 0
    for jp in sorted(glob.glob(os.path.join(root_dir, "*.json"))):
        with open(jp) as f:
            d = json_mod.load(f)
        img_id = os.path.splitext(os.path.basename(jp))[0]
        rpc_adj = adjusted_rpc_from_ba(ba_output_dir, img_id)
        if rpc_adj is not None:
            d["rpc"] = rpc_adj
        cam_idx = None
        try:
            cam_idx = basenames.index(d.get("img", img_id + ".tif"))
        except ValueError:
            try:
                cam_idx = [os.path.splitext(b)[0]
                           for b in basenames].index(img_id)
            except ValueError:
                pass
        if cam_idx is not None:
            sel = cam_ind == cam_idx
            d["keypoints"] = {"2d_coordinates": pts2d[sel].tolist(),
                              "pts3d_indices": pts_ind[sel].tolist()}
        if rpc_adj is None and cam_idx is None:
            continue          # BA knows nothing about this image
        if cam_idx is None:
            # the adjusted RPC still counts — don't silently drop it
            # (BA can prune a camera from cam_prev_indices yet emit its
            # refined RPC)
            print(f"[dataset_gen] {img_id}: rpcs_adj applied but no "
                  f"camera index in geotiff_paths.txt — keypoints not "
                  f"attached")
        with open(jp, "w") as f:
            json_mod.dump(d, f, indent=2)
        n += 1
    return n


def adjusted_rpc_from_ba(output_dir: str, img_id: str) -> Optional[Dict]:
    """Read a bundle-adjusted RPC written by the external sat-bundleadjust
    (ba_files/rpcs_adj/{img}.rpc_adj, generate_dataset.py:152-155); returns
    None when absent.  The .rpc_adj format is the classic RPC text file."""
    path = os.path.join(output_dir, "ba_files", "rpcs_adj",
                        f"{img_id}.rpc_adj")
    if not os.path.exists(path):
        return None
    return parse_rpc_file(path)


_RPC_FIELDS = {
    "LINE_OFF": "row_offset", "SAMP_OFF": "col_offset",
    "LAT_OFF": "lat_offset", "LONG_OFF": "lon_offset",
    "HEIGHT_OFF": "alt_offset",
    "LINE_SCALE": "row_scale", "SAMP_SCALE": "col_scale",
    "LAT_SCALE": "lat_scale", "LONG_SCALE": "lon_scale",
    "HEIGHT_SCALE": "alt_scale",
}


def find_rpc_sidecar(img_path: str) -> Optional[str]:
    """RPC00B text sidecar next to an image, in discovery order:
    <stem>.rpc / <stem>.RPB / <stem>_rpc.txt / <stem>.rpc_adj."""
    stem = os.path.splitext(img_path)[0]
    for cand in (stem + ".rpc", stem + ".RPB", stem + "_rpc.txt",
                 stem + ".rpc_adj"):
        if os.path.exists(cand):
            return cand
    return None


def parse_rpc_file(path: str) -> Dict:
    """Parse a classic RPC00B text file (LINE_OFF: ... / LINE_NUM_COEFF_1:)
    into the rpcm-style dict the datasets consume."""
    d: Dict = {"row_num": [0.0] * 20, "row_den": [0.0] * 20,
               "col_num": [0.0] * 20, "col_den": [0.0] * 20}
    coeff_map = {"LINE_NUM_COEFF": "row_num", "LINE_DEN_COEFF": "row_den",
                 "SAMP_NUM_COEFF": "col_num", "SAMP_DEN_COEFF": "col_den"}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            key = key.strip()
            val = val.strip().split()[0]
            if key in _RPC_FIELDS:
                d[_RPC_FIELDS[key]] = float(val)
            else:
                for pref, target in coeff_map.items():
                    if key.startswith(pref + "_"):
                        idx = int(key[len(pref) + 1:]) - 1
                        d[target][idx] = float(val)
    return d


# --------------------------------------------- image patch cropping (L9)

def lonlat_aoi_from_dsm_roi(roi_txt: str, zone: int, northern: bool = True
                            ) -> np.ndarray:
    """AOI corner lon/lats from a {aoi}_DSM.txt ROI file
    (read_lonlat_aoi, generate_dataset.py:244-270): the UTM bounding box
    (xoff, yoff_bottom, size, resolution) converted to the 4 geographic
    corners.  Returns (4, 2) [lon, lat] in ul, ur, lr, ll order."""
    from .geo.geodesy import latlon_from_utm
    roi = np.loadtxt(roi_txt)
    xoff, yoff, size, res = roi[0], roi[1], int(roi[2]), roi[3]
    e = np.asarray([xoff, xoff + size * res, xoff + size * res, xoff])
    n = np.asarray([yoff + size * res, yoff + size * res, yoff, yoff])
    lat, lon = latlon_from_utm(e, n, zone, northern=northern)
    return np.stack([np.asarray(lon), np.asarray(lat)], -1)


def scale_img(img: np.ndarray, vmin: Optional[float] = None,
              vmax: Optional[float] = None,
              per_channel: bool = False) -> np.ndarray:
    """Linear min-max scaling to [0, 255] (ScaleImg,
    generate_dataset.py:273-300): global by default, per-channel when
    per_channel (SclIndiv) is set."""
    img = np.asarray(img, np.float64)
    if per_channel:
        out = np.empty_like(img)
        for c in range(img.shape[0]):
            lo, hi = img[c].min(), img[c].max()
            out[c] = (img[c] - lo) * (255.0 / max(hi - lo, 1e-12))
        return out
    lo = img.min() if vmin is None else vmin
    hi = img.max() if vmax is None else vmax
    return (img - lo) * (255.0 / max(hi - lo, 1e-12))


def crop_image_to_aoi(img: np.ndarray, rpc_dict: Dict,
                      lonlat_corners: np.ndarray, alt: float
                      ) -> Tuple[np.ndarray, int, int]:
    """Crop (C, H, W) image to the bounding box of the AOI corners
    projected through the RPC at altitude `alt` (rpcm.utils.crop_aoi
    semantics as used at generate_dataset.py:370-375).  Returns
    (crop, x, y) pixel offsets of the crop's upper-left corner."""
    rpc = rpc_mod.rpc_from_dict(rpc_dict)
    lon = np.asarray(lonlat_corners[:, 0], np.float64)
    lat = np.asarray(lonlat_corners[:, 1], np.float64)
    col, row = rpc_mod.projection_np(rpc, lon, lat, np.full_like(lon, alt))
    col, row = np.asarray(col), np.asarray(row)
    h, w = img.shape[-2], img.shape[-1]
    x0 = max(0, int(np.floor(col.min())))
    y0 = max(0, int(np.floor(row.min())))
    x1 = min(w, int(np.ceil(col.max())) + 1)
    y1 = min(h, int(np.ceil(row.max())) + 1)
    return img[..., y0:y1, x0:x1], x0, y0


def adjust_rpc_offsets(rpc_dict: Dict, x: int, y: int) -> Dict:
    """RPC offset fixups after cropping (generate_dataset.py:375-377:
    rpc.row_offset -= y; rpc.col_offset -= x)."""
    d = dict(rpc_dict)
    d["row_offset"] = float(d["row_offset"]) - float(y)
    d["col_offset"] = float(d["col_offset"]) - float(x)
    return d


def crop_image_patches(aoi_id: str, dsm_dir: str, images: Sequence[Tuple],
                       out_dir: str, utm_zone: int, northern: bool = True,
                       sun_angles: Optional[Dict] = None,
                       uint8: bool = True, splits: bool = True,
                       seed: Optional[int] = 0) -> str:
    """CropImagePatches (generate_dataset.py:302-428) on this repo's
    formats: crop every source image to the GT-DSM AOI at the DSM's mean
    altitude, fix up the RPC offsets, write the unscaled crop plus a
    uint8 min-max-scaled copy under RGB-crops/<aoi>/scled/, copy the
    Truth DSM pair, emit per-image JSONs with the adjusted RPCs, masks,
    and train/test splits.

    images: sequence of (geotiff_path, rpc_dict).  Bundle adjustment
    stays an external tool (run_ba, see module docstring); JSONs carry
    the crop-adjusted original RPCs.
    Returns the root_dir holding the JSONs + splits."""
    import shutil
    roi_txt = os.path.join(dsm_dir, f"{aoi_id}_DSM.txt")
    dsm_tif = os.path.join(dsm_dir, f"{aoi_id}_DSM.tif")
    corners = lonlat_aoi_from_dsm_roi(roi_txt, utm_zone, northern)
    dsm_arr, _ = read_geotiff(dsm_tif)
    finite = dsm_arr[0][np.isfinite(dsm_arr[0])]
    alt_me = float(finite.mean())
    min_alt, max_alt = (int(np.round(finite.min() - 1)),
                        int(np.round(finite.max() + 1)))

    base = os.path.join(out_dir, f"dataset{aoi_id}", aoi_id)
    truth_dir = os.path.join(base, "Truth")
    crops_dir = os.path.join(base, "RGB-crops", aoi_id)
    scled_dir = os.path.join(crops_dir, "scled")
    root_dir = os.path.join(out_dir, f"dataset{aoi_id}", "root_dir", aoi_id)
    for d in (truth_dir, scled_dir, root_dir):
        os.makedirs(d, exist_ok=True)
    shutil.copyfile(roi_txt, os.path.join(truth_dir,
                                          os.path.basename(roi_txt)))
    shutil.copyfile(dsm_tif, os.path.join(truth_dir,
                                          os.path.basename(dsm_tif)))

    json_paths = []
    for img_path, rpc_dict in images:
        arr, prof = read_geotiff(img_path)
        crop, x, y = crop_image_to_aoi(arr, rpc_dict, corners, alt_me)
        rpc_adj = adjust_rpc_offsets(rpc_dict, x, y)
        name = os.path.basename(img_path)
        # shift the georeference by the crop offset (crop_dsm convention)
        new_prof = GeoProfile(width=crop.shape[-1], height=crop.shape[-2],
                              ulx=prof.ulx + x * prof.xres,
                              uly=prof.uly - y * prof.yres,
                              xres=prof.xres, yres=prof.yres,
                              epsg=prof.epsg, nodata=prof.nodata)
        write_geotiff(os.path.join(crops_dir, name),
                      crop.astype(arr.dtype), new_prof)
        scld = crop
        if uint8:
            scld = scale_img(crop).astype(np.uint8)
        scld_path = os.path.join(scled_dir, name)
        write_geotiff(scld_path, scld, new_prof)
        sun = _lookup_sun_angles(sun_angles, os.path.splitext(name)[0])
        json_paths.append(create_image_json(
            scld_path, rpc_adj, sun[0], sun[1], root_dir,
            min_alt=min_alt, max_alt=max_alt))

    if splits:
        names = [os.path.basename(p) for p in json_paths]
        train, test = create_train_test_splits(names, seed=seed)
        write_splits(root_dir, train, test)
    return root_dir
