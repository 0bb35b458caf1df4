"""Shared BRDF geometry: angles between light / view / normal, HG phase
(BRDF/basic_func.py), with the JAX package's clamp conventions: cosines kept
inside (eps, 1 - 1e-6) and the relative-azimuth division floored, so exact
nadir gives no 0/0."""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch


@lru_cache(maxsize=None)
def _bound(v: float, dtype: torch.dtype, device: torch.device):
    # filled on the device, once per (value, dtype, device): a bound made
    # from a Python number each call would copy it from the host
    return torch.full((), v, dtype=dtype, device=device)


def clip(x, lo=None, hi=None):
    """jnp.clip(x, lo, hi): maximum with lo, then minimum with hi, the
    bounds as tensors, so an input exactly at a bound gets half the
    gradient, as under JAX (torch.clamp passes all of it)."""
    if lo is not None:
        x = torch.maximum(x, _bound(float(lo), x.dtype, x.device))
    if hi is not None:
        x = torch.minimum(x, _bound(float(hi), x.dtype, x.device))
    return x


class BRDFAngles(NamedTuple):
    ci: torch.Tensor    # cos solar zenith
    sza: torch.Tensor   # solar zenith angle
    si: torch.Tensor    # sin solar zenith
    cv: torch.Tensor    # cos view zenith
    vza: torch.Tensor   # view zenith angle
    sv: torch.Tensor    # sin view zenith
    cg: torch.Tensor    # cos phase angle
    g: torch.Tensor     # phase angle
    phi: torch.Tensor   # relative azimuth


def calc_angles(pts2l, pts2c, normal, eps: float = 1e-5) -> BRDFAngles:
    """pts2l/pts2c/normal: (N, 3) unit vectors (basic_func.py:5-31)."""
    cos_max = 1.0 - 1e-6
    ci = clip(torch.sum(pts2l * normal, -1), eps, cos_max)
    sza = torch.arccos(ci)
    si = torch.sin(sza)

    cv = clip(torch.sum(pts2c * normal, -1), eps, cos_max)
    vza = torch.arccos(cv)
    sv = torch.sin(vza)

    cg = clip(torch.sum(pts2c * pts2l, -1), -cos_max, cos_max)
    g = torch.arccos(cg)

    denom = clip(si * sv, eps)
    cp = clip((cg - ci * cv) / denom, -cos_max, cos_max)
    phi = torch.arccos(cp)
    return BRDFAngles(ci, sza, si, cv, vza, sv, cg, g, phi)


def henyey_greenstein(x, theta, eps: float = 1e-6):
    """Single-lobe HG phase (basic_func.py:33-44). x: (N,1) cos(g); theta (N,K)."""
    theta2 = theta * theta
    y = (1.0 - theta2) / (torch.pow(1.0 + 2.0 * theta * x + theta2, 1.5)
                          + eps)
    return torch.nan_to_num(y)
