"""Visualization helpers: the reference's TensorBoard image-stack toolkit
(train_utils.py:161-331) as NumPy functions returning (H, W, 3) uint8; the
port's copy of the JAX package's utils/viz.py, function for function.

  normal_to_rgb        <- visualize_normal: n in [-1,1] -> (n+1)/2 RGB
  accumulate_feature   <- visualize_accumulated_feature: per-sample fields
                          weighted-summed along the ray then normalized by
                          mode none / minmax / -1et1 / enhance
  colorize             <- rainbow colormap for scalar fields (depth, diff)
  depth_to_rgb, diff_to_rgb
  image_stack          <- stack panels vertically for one summary image

The JAX package colours through cv2's COLORMAP_JET and saves through PIL,
which the card's machine lacks: colorize looks the values up in JET_RGB,
cv2's JET table stored here (held bit-equal to cv2 by the tests), and
save_png writes through utils/png.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .png import write_png

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET), as
# RGB: 256 rows of 3 bytes
JET_RGB = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"), np.uint8).reshape(256, 3)


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def normal_to_rgb(normals: np.ndarray) -> np.ndarray:
    """(H, W, 3) normals in [-1, 1] -> RGB."""
    return _to_uint8((normals + 1.0) * 0.5)


def normalize_field(x: np.ndarray, mode: str = "minmax") -> np.ndarray:
    """Reference norm modes (train_utils.visualize_accumulated_feature):
    'none' (clip), 'minmax', '-1et1' (x/2+0.5), 'enhance' (2/98 percentile).
    """
    if mode == "none":
        return np.clip(x, 0.0, 1.0)
    if mode == "-1et1":
        return np.clip(x * 0.5 + 0.5, 0.0, 1.0)
    if mode == "enhance":
        lo, hi = np.nanpercentile(x, 2), np.nanpercentile(x, 98)
    else:
        lo, hi = np.nanmin(x), np.nanmax(x)
    return np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)


def colorize(x: np.ndarray, mode: str = "minmax") -> np.ndarray:
    """Scalar (H, W) -> rainbow RGB uint8 (cv2 COLORMAP_JET, the
    reference's getRainbowColor)."""
    v = normalize_field(np.nan_to_num(x), mode)
    return JET_RGB[_to_uint8(v)]


def accumulate_feature(weights: np.ndarray, feature: np.ndarray,
                       h: int, w: int, mode: str = "minmax") -> np.ndarray:
    """Per-sample feature (N, S, C) weighted along samples -> (H, W, C)
    uint8 panel."""
    acc = np.sum(weights[..., None] * feature, axis=-2)
    c = acc.shape[-1]
    img = acc.reshape(h, w, c)
    if c == 1:
        return colorize(img[..., 0], mode)
    return _to_uint8(normalize_field(img, mode))


def depth_to_rgb(depth: np.ndarray, h: int, w: int) -> np.ndarray:
    return colorize(depth.reshape(h, w), "minmax")


def diff_to_rgb(diff: np.ndarray, clip: float = 2.0) -> np.ndarray:
    """Signed diff -> blue/red diverging panel, clipped at +/- clip."""
    v = np.clip(np.nan_to_num(diff) / clip, -1.0, 1.0)
    r = np.clip(v, 0, 1)
    b = np.clip(-v, 0, 1)
    g = 1.0 - np.abs(v)
    return _to_uint8(np.stack([r, g, b], -1))


def image_stack(panels: List[np.ndarray], pad: int = 2) -> np.ndarray:
    """Stack equally-wide RGB panels vertically with a white separator
    (the reference's stack handed to add_images, main.py:457-558)."""
    w = max(p.shape[1] for p in panels)
    rows = []
    for p in panels:
        if p.ndim == 2:
            p = np.stack([p] * 3, -1)
        if p.shape[1] < w:
            p = np.pad(p, ((0, 0), (0, w - p.shape[1]), (0, 0)),
                       constant_values=255)
        rows.append(p)
        rows.append(np.full((pad, w, 3), 255, np.uint8))
    return np.concatenate(rows[:-1], 0)


def save_png(path: str, img: np.ndarray):
    """Write a uint8 panel as PNG, creating its directory (a blender
    frame's src_id holds one, e.g. "./val/r_0")."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    write_png(path, np.ascontiguousarray(img))


# (key, norm mode) of the per-ray accumulated maps rendered as panels, in
# the reference's stack order (main.py:426-558): albedo, sun visibility,
# sky color, normals (analytic / learned), roughness, RPV k/theta/rhoc,
# Hapke b/c/theta, irradiance, beta uncertainty.
PANEL_MODES = (
    ("albedo_coarse", "none"), ("sun_coarse", "none"),
    ("sky_coarse", "none"), ("normal_an_coarse", "-1et1"),
    ("normal_lr_coarse", "-1et1"), ("roughness_coarse", "minmax"),
    ("rpv_k_coarse", "minmax"), ("rpv_theta_coarse", "-1et1"),
    ("rpv_rhoc_coarse", "minmax"), ("hpk_b_coarse", "minmax"),
    ("hpk_c_coarse", "minmax"), ("hpk_theta_coarse", "minmax"),
    ("irradiance_coarse", "none"), ("beta_coarse", "minmax"),
)


def render_summary_panels(maps: Dict[str, np.ndarray], gt_rgb: np.ndarray,
                          h: int, w: int,
                          diff: Optional[np.ndarray] = None,
                          diff_nr: Optional[np.ndarray] = None,
                          visu_scale: float = 1.0) -> np.ndarray:
    """The per-image validation stack (main.py:426-558 analog): rgb / gt /
    depth plus albedo / irradiance / sun / normals / BRDF-parameter maps —
    whichever per-ray accumulated (N, C) maps the dict carries (as the
    block render returns them) — and optionally the registered DSM diff
    panels (main.py:630-636: diff clipped to +/-20 m, normal-angle diff to
    0..90 deg)."""
    # visu_scale brightens rgb / gt / albedo panels only
    # (main.py:464-470, eval.py:422-428)
    vs = float(visu_scale)
    panels = [_to_uint8(maps["rgb_coarse"].reshape(h, w, 3) * vs),
              _to_uint8(gt_rgb.reshape(h, w, 3) * vs),
              depth_to_rgb(maps["depth_coarse"], h, w)]
    for key, mode in PANEL_MODES:
        if key not in maps:
            continue
        img = np.asarray(maps[key]).reshape(h, w, -1)
        if key == "albedo_coarse":
            img = img * vs
        if img.shape[-1] == 1:
            panels.append(colorize(img[..., 0], mode))
        else:
            panels.append(_to_uint8(normalize_field(img, mode)))
    if diff is not None:
        panels.append(colorize((np.clip(diff, -20.0, 20.0) + 20.0) / 40.0,
                               "none"))
    if diff_nr is not None:
        panels.append(colorize(np.clip(diff_nr, 0.0, 90.0) / 90.0, "none"))
    return image_stack(panels)
