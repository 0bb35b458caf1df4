"""Blender-synthetic (NeRF lego) dataset, --data blender: the port's copy of
the JAX package's data/blender.py (reference datasets/blender.py), which
reads and resizes its frames through PIL.  Here the frames are decoded by
utils/png (every PNG colour type, depth and Adam7, to PIL's array) and
resized by utils/resample (Pillow's LANCZOS on premultiplied RGBA, its
16-bit LANCZOS, or its NEAREST for "1" and "P" frames), and the
perturbations draw their rectangles with NumPy.

Conventions as the JAX package keeps them: focal from camera_angle_x
scaled from 800 px (focal *= w / 800, blender.py:126-128), pinhole
directions [(i - cx) / fx, -(j - cy) / fy, -1] without +0.5 centring
(blender.py:33-55), near 2 and far 6 (blender.py:135-136), the
white-background alpha blend (blender.py:169,213), optional colour and
occlusion perturbations (blender.py:82-100); the train split loads frames
t = 0..100 inclusive, 101 images, the reference's `t > 100` break
(blender.py:143-157).  Ray layout: [o(3), d(3), near, far]; ts is the image
index.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.png import decode_image
from ..utils.resample import (resize_lanczos, resize_lanczos16,
                              resize_nearest_pil)


def get_ray_directions(h: int, w: int, k: np.ndarray) -> np.ndarray:
    """(H, W, 3) camera-frame directions (blender.py:33-55)."""
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    return np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], -1)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-frame rays from camera pose (blender.py:57-80)."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), \
        rays_d.reshape(-1, 3).astype(np.float32)


def add_perturbation(img: np.ndarray, perturbation, seed: int) -> np.ndarray:
    """Colour / occlusion perturbations of a uint8 (H, W, C) frame
    (blender.py:82-100): the JAX package's PIL version on arrays.  The
    occluders are ImageDraw.rectangle's: both corners inclusive, clipped to
    the frame, opaque where the frame has alpha."""
    if "color" in perturbation:
        rs = np.random.RandomState(seed)
        arr = img / 255.0
        s = rs.uniform(0.8, 1.2, size=3)
        b = rs.uniform(-0.2, 0.2, size=3)
        arr[..., :3] = np.clip(s * arr[..., :3] + b, 0, 1)
        img = (255 * arr).astype(np.uint8)
    if "occ" in perturbation:
        img = np.array(img)
        rs = np.random.RandomState(seed)
        left = rs.randint(200, 400)
        top = rs.randint(200, 400)
        for i in range(10):
            rsi = np.random.RandomState(10 * seed + i)
            color = [int(c) for c in rsi.choice(range(256), 3)]
            if img.ndim == 3 and img.shape[-1] == 4:
                color.append(255)
            x0, x1 = left + 20 * i, left + 20 * (i + 1)
            img[top:top + 201, x0:x1 + 1] = (color if img.ndim == 3
                                             else color[0])
    return img


def _load_image(path: str, wh, perturbation=(), seed: int = 0):
    """The JAX package's _load_image on PIL's array for the frame
    (utils/png.decode_image), whatever its mode: a resize takes NEAREST
    for "1" and "P" frames, as Image.resize does, and Pillow's 16-bit
    LANCZOS for "I;16" ones; a palette frame's indices and a 16-bit
    frame's values are divided by 255 as the JAX package divides them."""
    with open(path, "rb") as f:
        img, mode = decode_image(f.read(), path)
    if perturbation and seed != 0:
        img = add_perturbation(img, perturbation, seed)
    if (img.shape[1], img.shape[0]) != tuple(wh):
        if mode in ("1", "P"):
            img = resize_nearest_pil(img, *wh)
        elif mode == "I;16":
            img = resize_lanczos16(img, *wh)
        else:
            img = resize_lanczos(img, *wh)
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.tile(arr[..., None], (1, 1, 3))
    if arr.shape[-1] == 4:
        rgb = arr[..., :3] * arr[..., 3:] + (1.0 - arr[..., 3:])  # white bg
        mask = (arr[..., 3] > 0).reshape(-1)
    else:
        rgb = arr[..., :3]
        mask = np.ones(arr.shape[0] * arr.shape[1], bool)
    return rgb.reshape(-1, 3), mask


class BlenderDataset:
    """split='train' -> flat ray store dict (`train_store`, also `store`);
    split='val'/'test' -> per-image samples via get_image(i)."""

    NEAR, FAR = 2.0, 6.0
    MAX_TRAIN_IMGS = 100

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(400, 400), perturbation: Optional[List[str]] = None):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.perturbation = perturbation or []
        json_file = f"transforms_{split.split('_')[-1]}.json"
        with open(os.path.join(root_dir, json_file)) as f:
            self.meta = json.load(f)

        w, h = self.img_wh
        focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        focal *= w / 800.0
        self.focal = focal
        self.k = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                            np.float32)
        self.directions = get_ray_directions(h, w, self.k)

        if split == "train":
            self._build_train_store()

    def _frame_rays(self, frame):
        pose = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
        rays_o, rays_d = get_rays(self.directions, pose)
        near = np.full((rays_o.shape[0], 1), self.NEAR, np.float32)
        far = np.full((rays_o.shape[0], 1), self.FAR, np.float32)
        return np.concatenate([rays_o, rays_d, near, far], axis=1)

    def _build_train_store(self):
        all_rays, all_rgbs, all_ts = [], [], []
        for t, frame in enumerate(self.meta["frames"]):
            if t > self.MAX_TRAIN_IMGS:
                break
            path = os.path.join(self.root_dir, frame["file_path"] + ".png")
            rgb, _ = _load_image(path, self.img_wh, self.perturbation, t)
            rays = self._frame_rays(frame)
            all_rays.append(rays)
            all_rgbs.append(rgb)
            all_ts.append(np.full(rays.shape[0], t, np.int32))
        self.train_store: Dict[str, np.ndarray] = {
            "rays": np.concatenate(all_rays, 0),
            "rgbs": np.concatenate(all_rgbs, 0),
            "ts": np.concatenate(all_ts, 0),
        }
        self.store = self.train_store

    def __len__(self):
        if self.split == "train":
            return self.train_store["rays"].shape[0]
        return len(self.meta["frames"])

    def get_image(self, idx: int) -> Dict[str, np.ndarray]:
        frame = self.meta["frames"][idx]
        path = os.path.join(self.root_dir, frame["file_path"] + ".png")
        rgb, mask = _load_image(path, self.img_wh)
        rays = self._frame_rays(frame)
        w, h = self.img_wh
        # "mask" is the key every metric consumer reads (Trainer.validate,
        # cli.eval), so blender PSNR is alpha-masked like the satellite path
        return {"rays": rays, "rgbs": rgb, "mask": mask,
                "ts": np.zeros(rays.shape[0], np.int32),
                "src_id": frame["file_path"], "h": h, "w": w, "idx": idx}
