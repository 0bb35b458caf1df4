"""Dataset factory (reference: datasets/__init__.py:6-31), satellite data
only: the port's copy of the JAX package's data/factory.py.

  sps-nerf / spsbrdf-nerf -> SatelliteDataset with dense depth
  nerf / s-nerf / sat-nerf -> SatelliteDataset without dense depth (the
    sat-nerf keypoint store, ds_lambda > 0, is not ported yet)
  data='blender' -> not ported yet (its loader reads images through PIL)
"""

from __future__ import annotations

from typing import Optional

from ..models.network import not_ported
from .satellite import SatelliteConfig, SatelliteDataset


def load_dataset(variant: str, data: str, root_dir: str, split: str = "train",
                 img_dir: Optional[str] = None, ds_lambda: float = 0.0,
                 img_downscale: float = 1.0, **sat_kwargs):
    if data == "blender":
        raise not_ported("the blender dataset (data/blender.py)", 7)
    dense = variant in ("sps-nerf", "spsbrdf-nerf")
    cfg = SatelliteConfig(
        root_dir=root_dir, img_dir=img_dir, img_downscale=img_downscale,
        load_depth=dense,
        sparse_depth=(not dense and ds_lambda > 0),
        **sat_kwargs)
    return SatelliteDataset(cfg, split=split)
