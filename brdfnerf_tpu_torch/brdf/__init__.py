"""BRDF models of the port: RPV, Hapke and Microfacet (the JAX package's
brdf/, on torch tensors)."""

from .common import calc_angles, henyey_greenstein
from .rpv import rpv_brdf
from .hapke import hapke_brdf
from .microfacet import microfacet_brdf

__all__ = ["calc_angles", "henyey_greenstein", "rpv_brdf", "hapke_brdf",
           "microfacet_brdf"]
