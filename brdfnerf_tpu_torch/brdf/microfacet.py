"""Microfacet (GGX / Cook-Torrance style) BRDF (BRDF/microfacet.py), the
JAX package's formulation.

brdf = albedo + glossy, glossy = 0.04 * D / (4 |l.n| |v.n|): the reference
multiplies a fixed 0.04 factor and does not multiply Fresnel F into the
glossy lobe (microfacet.py:56-57); F, G and D are still computed and
returned as diagnostics.  nan_to_num guards as the reference's; clips take
JAX's gradient at an exact tie (brdf/common.clip).
"""

from __future__ import annotations

import math

import torch

from .common import clip

_PI = math.pi


def _safe_norm(x, eps: float = 1e-6):
    n = torch.sqrt(torch.sum(x * x, -1, keepdim=True))
    return x / clip(n, eps)


def _get_f(l, m, f0: float):
    """Fresnel-Schlick (microfacet.py:113-118). l, m: (N,3)."""
    cos_theta = torch.sum(l * m, -1)
    return f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5


def _get_d(m, n, alpha):
    """GGX distribution (microfacet.py:98-111). Returns (d, cos_theta_m)."""
    cos_theta_m = torch.sum(m * n, -1)
    chi = (cos_theta_m > 0).to(cos_theta_m.dtype)
    c2 = cos_theta_m ** 2
    tan2 = torch.nan_to_num((1.0 - c2) / c2)
    a = alpha[..., 0]
    denom = _PI * c2 ** 2 * (a * a + tan2) ** 2
    d = torch.nan_to_num(a * a * chi / denom)
    return d, cos_theta_m


def _get_g(v, m, n, alpha):
    """GGX geometric term (microfacet.py:74-96)."""
    cos_theta_v = torch.sum(n * v, -1)
    cos_theta = torch.sum(m * v, -1)
    div = torch.nan_to_num(cos_theta / cos_theta_v)
    chi = (div > 0).to(div.dtype)
    c2 = clip(cos_theta_v ** 2, 0.0, 1.0)
    tan2 = torch.nan_to_num(clip(torch.nan_to_num((1.0 - c2) / c2), 0.0))
    a = alpha[..., 0]
    denom = 1.0 + torch.sqrt(1.0 + a * a * tan2)
    return torch.nan_to_num(chi * 2.0 / denom)


def microfacet_brdf(pts2l, pts2c, normal, albedo, rough,
                    f0: float = 0.04, lvis: bool = False,
                    glossy_scale: float = 1.0):
    """pts2l/pts2c/normal: (N,3); albedo: (N,3); rough: (N,1).

    Returns (glossy, brdf, f, g, d, l_dot_n, v_dot_n, h, n_h), as
    Microfacet.forward (microfacet.py:20-72, L=1 squeezed).  glossy_scale
    is accepted and inert, as in the reference, which stores it
    (microfacet.py:17) and applies the fixed factor instead."""
    pts2l = _safe_norm(pts2l)
    pts2c = _safe_norm(pts2c)
    normal = _safe_norm(normal)

    h = _safe_norm(pts2l + pts2c)
    f = _get_f(pts2l, h, f0)
    alpha = rough ** 2
    d, n_h = _get_d(h, normal, alpha)
    g = _get_g(pts2c, h, normal, alpha)
    if lvis:
        g = g * _get_g(pts2l, h, normal, alpha)

    min_angle = 0.001
    l_dot_n = clip(torch.abs(torch.sum(pts2l * normal, -1)), min_angle)
    v_dot_n = clip(torch.abs(torch.sum(pts2c * normal, -1)), min_angle)
    denom = 4.0 * l_dot_n * v_dot_n
    factor = 0.04                       # fixed factor (microfacet.py:56)
    glossy = torch.nan_to_num(factor * d / denom)

    # diffuse + glossy (microfacet.py:62-69)
    brdf = albedo + glossy[:, None]
    return glossy, brdf, f, g, d, l_dot_n, v_dot_n, h, n_h
