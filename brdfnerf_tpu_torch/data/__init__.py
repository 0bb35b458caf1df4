"""Dataset ingestion of the port: the satellite and blender datasets, the
ray batcher and the synthetic AOI (the JAX package's data/)."""

from .batcher import RayBatcher
from .blender import BlenderDataset
from .satellite import (SatelliteConfig, SatelliteDataset, SceneLoc,
                        get_rays_np, normals_from_grid_points)
from .factory import load_dataset
from .synth_aoi import build_aoi

__all__ = ["RayBatcher", "BlenderDataset", "SatelliteConfig",
           "SatelliteDataset", "SceneLoc", "get_rays_np",
           "normals_from_grid_points", "load_dataset", "build_aoi"]
