"""A synthetic scene in the NeRF-synthetic (lego) layout, for runs of the
blender path where the real scenes are not at hand: transforms_{train,
val,test}.json with camera_angle_x 0.6911 and poses on a sphere of radius
4 looking at the origin, and RGBA PNG frames of an analytic object on a
transparent background.

The object: a sphere of radius 1 at the origin, coloured by longitude and
latitude bands, and a smaller sphere beside it; each frame is ray-cast in
closed form, with the blender loader's camera convention (directions
[(i - w/2) / f, -(j - h/2) / f, -1] in the camera frame, no +0.5), alpha
255 where a ray hits.  Frames are written by utils/png with each row's
filter type cycling through all five, so that every type occurs in every
frame.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np

from ..utils.png import write_png

CAMERA_ANGLE_X = 0.6911
RADIUS = 4.0
# (centre, radius) of the object's spheres
SPHERES = (((0.0, 0.0, 0.0), 1.0), ((0.9, -0.6, 0.5), 0.45))


def look_at(eye: np.ndarray) -> np.ndarray:
    """The 4x4 camera-to-world pose of a camera at `eye` looking at the
    origin, +z up (blender: the camera looks along its -z axis)."""
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, eye
    return c2w


def render_frame(c2w: np.ndarray, size: int) -> np.ndarray:
    """(size, size, 4) uint8 RGBA frame of the object seen from c2w."""
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    j, i = np.meshgrid(np.arange(size, dtype=np.float64),
                       np.arange(size, dtype=np.float64), indexing="ij")
    d = np.stack([(i - size / 2) / focal, -(j - size / 2) / focal,
                  -np.ones_like(i)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    best = np.full(d.shape[:2], np.inf)
    rgb = np.zeros(d.shape)
    for k, (centre, r) in enumerate(SPHERES):
        oc = o - np.asarray(centre)
        b = d @ oc
        disc = b * b - (oc @ oc - r * r)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t > 0) & (t < best)
        p = o + t[..., None] * d - np.asarray(centre)
        n = p / r
        lon = np.arctan2(n[..., 1], n[..., 0])
        lat = np.arcsin(np.clip(n[..., 2], -1, 1))
        shade = 0.35 + 0.65 * np.clip(n @ np.asarray([0.3, -0.4, 0.87]),
                                      0, 1)
        colour = np.stack([0.5 + 0.5 * np.cos(4 * lon + k),
                           0.5 + 0.5 * np.sin(6 * lat),
                           0.5 + 0.5 * np.cos(3 * lon - 5 * lat)], -1)
        rgb = np.where(hit[..., None], colour * shade[..., None], rgb)
        best = np.where(hit, t, best)
    out = np.zeros(d.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    out[..., 3] = np.isfinite(best) * 255
    return out


def write_scene(root: str, counts: Dict[str, int] = None,
                size: int = 800) -> Dict[str, Sequence[str]]:
    """The scene's transforms and frames under `root`: counts frames per
    split (default 20 train, 2 val, 2 test; the lego scene has 100, 100 and
    200), each split's cameras at their own azimuths and elevations on the
    sphere of radius 4.  Returns each split's frame paths."""
    counts = counts or {"train": 20, "val": 2, "test": 2}
    paths, jobs = {}, []
    for s, (split, n) in enumerate(counts.items()):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames, paths[split] = [], []
        for i in range(n):
            az = 2 * np.pi * (i + 0.37 * s) / n
            el = 0.15 + 0.5 * ((i * 0.618 + 0.29 * s) % 1.0)
            eye = RADIUS * np.asarray([np.cos(el) * np.cos(az),
                                       np.cos(el) * np.sin(az), np.sin(el)])
            c2w = look_at(eye)
            rel = f"./{split}/r_{i}"
            path = os.path.join(root, rel + ".png")
            jobs.append((path, c2w, (np.arange(size) + i) % 5))
            frames.append({"file_path": rel,
                           "transform_matrix": c2w.tolist()})
            paths[split].append(path)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames},
                      f, indent=2)
    # NumPy's large array operations and zlib let go of the interpreter
    # lock: one thread a core renders and writes frames
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda job: write_png(
            job[0], render_frame(job[1], size), filters=job[2]), jobs))
    return paths
