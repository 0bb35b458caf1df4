"""Geodesy and the RPC camera model of the port (the JAX package's
geo/)."""

from .geodesy import (
    latlon_to_ecef,
    ecef_to_latlon,
    utm_from_latlon,
    latlon_from_utm,
    utm_zone_from_latlon,
    sun_direction,
    scaling_params,
)
from .rpc import RPCModel, rpc_from_dict

__all__ = [
    "latlon_to_ecef",
    "ecef_to_latlon",
    "utm_from_latlon",
    "latlon_from_utm",
    "utm_zone_from_latlon",
    "sun_direction",
    "scaling_params",
    "RPCModel",
    "rpc_from_dict",
]
