"""Dataset factory (reference: datasets/__init__.py:6-31): the port's copy
of the JAX package's data/factory.py.

  sps-nerf / spsbrdf-nerf -> SatelliteDataset with dense depth
  nerf / s-nerf / sat-nerf + data='sat' -> SatelliteDataset without dense
    depth (sparse keypoint depth when ds_lambda > 0, satellite_depth.py)
  data='blender' -> BlenderDataset
"""

from __future__ import annotations

from typing import Optional

from .blender import BlenderDataset
from .satellite import SatelliteConfig, SatelliteDataset


def load_dataset(variant: str, data: str, root_dir: str, split: str = "train",
                 img_dir: Optional[str] = None, ds_lambda: float = 0.0,
                 img_downscale: float = 1.0, **sat_kwargs):
    if data == "blender":
        wh = sat_kwargs.pop("img_wh", (400, 400))
        return BlenderDataset(root_dir, split=split, img_wh=wh)
    dense = variant in ("sps-nerf", "spsbrdf-nerf")
    cfg = SatelliteConfig(
        root_dir=root_dir, img_dir=img_dir, img_downscale=img_downscale,
        load_depth=dense,
        sparse_depth=(not dense and ds_lambda > 0),
        **sat_kwargs)
    return SatelliteDataset(cfg, split=split)
