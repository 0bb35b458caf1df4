"""Hapke photometric model (BRDF/Hapke.py), the JAX package's formulation.

Full bidirectional reflectance factor (Hapke.py:192-198):
    BRF = w/hpk_scl * (ci/(ci+cv)/cos sza) * (P*B + Hi*Hv - 1) * S
with the double-HG phase PF(b, c) (Hapke.py:93-115), the opposition surge
B(B0, h) (Hapke.py:159-162), the macroscopic-roughness effective cosines
mu0_eff / mu_eff and shadowing S(theta) (Hapke.py:6-91,164-169), and the
Ambartsumian-Chandrasekhar H function HF (Hapke.py:117-131).  The i <= e /
i > e branch pairs are selects.  shell_hapke 1/2/3 are the reference's
simplified variants (Hapke.py:183-191).

NaN replacements as the reference's check_nan: E1/E2/f/chi/eta/PF/S -> 0,
mu0_eff -> cos i, mu_eff -> cos e, HF -> 1.  Clips and floors take JAX's
gradient at an exact tie (brdf/common.clip).
"""

from __future__ import annotations

import math

import torch

from .common import calc_angles, clip, henyey_greenstein

_PI = math.pi


def _e1(x, theta, eps=1e-5):
    y = torch.exp(-(2.0 / _PI) / torch.tan(theta + eps)
                  / torch.tan(x + eps))
    return torch.nan_to_num(y)


def _e2(x, theta, eps=1e-5):
    y = torch.exp(-(1.0 / _PI) * (1.0 / torch.tan(theta + eps)) ** 2
                  * (1.0 / torch.tan(x + eps)) ** 2)
    return torch.nan_to_num(y)


def _f(phi, eps=1e-5):
    return torch.nan_to_num(torch.exp(-2.0 * torch.tan((phi + eps) / 2.0)))


def _chi(x, eps=1e-5):
    return torch.nan_to_num(
        1.0 / torch.sqrt(1.0 + _PI * torch.tan(x + eps) ** 2))


def _eta(x, theta):
    y = _chi(theta) * (torch.cos(x) + torch.sin(x) * torch.tan(theta + 1e-5)
                       * (_e2(x, theta) / (2.0 - _e1(x, theta))))
    return torch.nan_to_num(y)


def _mu0_eff(i, e, phi, theta):
    """Effective cos of incidence (Hapke.py:32-48); branches by i <= e."""
    def branch(a, b):
        y = (torch.cos(phi) * _e2(a, theta)
             + torch.sin(phi / 2.0) ** 2 * _e2(b, theta))
        y = y / (2.0 - _e1(a, theta) - phi / _PI * _e1(b, theta))
        return _chi(theta) * (torch.cos(b) + torch.sin(b) * torch.tan(theta)
                              * y)
    y = torch.where(
        i <= e, branch(e, i),
        # i > e (no cos(phi) factor on the first term)
        _chi(theta) * (torch.cos(i) + torch.sin(i) * torch.tan(theta)
                       * ((_e2(i, theta)
                           - torch.sin(phi / 2.0) ** 2 * _e2(e, theta))
                          / (2.0 - _e1(i, theta)
                             - phi / _PI * _e1(e, theta)))))
    return torch.where(torch.isnan(y), torch.cos(i), y)


def _mu_eff(i, e, phi, theta):
    """Effective cos of emission (Hapke.py:50-66)."""
    y_le = _chi(theta) * (torch.cos(e) + torch.sin(e) * torch.tan(theta)
                          * ((_e2(e, theta)
                              - torch.sin(phi / 2.0) ** 2 * _e2(i, theta))
                             / (2.0 - _e1(e, theta)
                                - phi / _PI * _e1(i, theta))))
    y_gt = _chi(theta) * (torch.cos(e) + torch.sin(e) * torch.tan(theta)
                          * ((torch.cos(phi) * _e2(i, theta)
                              + torch.sin(phi / 2.0) ** 2 * _e2(e, theta))
                             / (2.0 - _e1(i, theta)
                                - phi / _PI * _e1(e, theta))))
    y = torch.where(i <= e, y_le, y_gt)
    return torch.where(torch.isnan(y), torch.cos(e), y)


def _shadow(i, e, phi, theta):
    """Macroscopic-roughness shadowing S (Hapke.py:68-91)."""
    ci = torch.cos(i)
    cv = torch.cos(e)
    mue = _mu_eff(i, e, phi, theta)
    etai = _eta(i, theta)
    etae = _eta(e, theta)
    chit = _chi(theta)
    ff = _f(phi)
    temp = (mue / etae) * (ci / etai) * chit
    y_le = temp / (1.0 - ff + ff * chit * (ci / etai))
    y_gt = temp / (1.0 - ff + ff * chit * (cv / etae))
    return torch.nan_to_num(torch.where(i <= e, y_le, y_gt))


def _pf(x, b, c):
    """Double HG phase (Hapke.py:93-115). x: (N,1); b, c: (N,3)."""
    b2 = b * b
    bx = b * x
    y = c * (1.0 - b2) / (torch.pow(1.0 - 2.0 * bx + b2, 1.5) + 1e-6)
    y = y + (1.0 - c) * (1.0 - b2) / (torch.pow(1.0 + 2.0 * bx + b2, 1.5)
                                      + 1e-6)
    return torch.nan_to_num(y)


def _hf(x, w, eps: float = 1e-3):
    """Chandrasekhar H (Hapke 2002 approximation, Hapke.py:117-131).
    x: (N,1); w: (N,3).  x is floored at eps: the roughness-effective
    cosines can dip to ~0, where log((1+x)/x) and 1/tmp1 blow up."""
    x = clip(x, eps)
    gamma = torch.sqrt(clip(1.0 - w, 1e-6, 1.0))
    ro = (1.0 - gamma) / (1.0 + gamma)
    log = torch.log((1.0 + x) / x)
    tmp1 = 1.0 - w * x * (ro + (1.0 - 2.0 * ro * x) / 2.0 * log)
    y = 1.0 / torch.where(torch.abs(tmp1) < 1e-4,
                          torch.sign(tmp1) * 1e-4 + (tmp1 == 0) * 1e-4, tmp1)
    return torch.where(torch.isnan(y), torch.ones_like(y), y)


def hapke_brdf(pts2l, pts2c, normal, w, b=None, c=None, theta=None,
               h=None, b0=None, hpk_scl: float = 4.0, shell_hapke: int = 0):
    """Full or shell Hapke BRF (Hapke.py:139-200).

    pts2l/pts2c/normal: (N,3); w: (N,3); b, c: (N,3) or None; theta: (N,)
    or None.  Returns (brdf, P, B, Hi, Hv, S, ci, cv)."""
    a = calc_angles(pts2l, pts2c, normal)
    ci, cv = a.ci, a.cv

    if b is None:
        p = torch.ones(a.cg.shape[0], 3, dtype=a.cg.dtype,
                       device=a.cg.device)
    elif c is None:
        p = henyey_greenstein(a.cg[:, None], b)
    else:
        p = _pf(a.cg[:, None], b, c)

    if b0 is not None and h is not None:
        bk = b0 / (1.0 + 1.0 / h * torch.tan(a.g / 2.0)[:, None]) + 1.0
    else:
        bk = torch.ones_like(a.g)[:, None]

    if theta is not None:
        # the roughness-effective cosines can go slightly negative at
        # grazing geometry: floored so that H and ci/(ci+cv) stay finite
        ci = clip(_mu0_eff(a.sza, a.vza, a.phi, theta), 1e-3, 1.0)
        cv = clip(_mu_eff(a.sza, a.vza, a.phi, theta), 1e-3, 1.0)
        shad = clip(_shadow(a.sza, a.vza, a.phi, theta), 0.0, 10.0)[:, None]
    else:
        shad = torch.ones_like(a.sza)[:, None]

    hi = _hf(ci[:, None], w)
    hv = _hf(cv[:, None], w)

    if b is None:
        if shell_hapke == 2:
            brdf = w / ((ci + cv) * hpk_scl + 1e-6)[:, None]
        elif shell_hapke == 3:
            brdf = w * (hi * hv) / ((ci + cv) * hpk_scl + 1e-6)[:, None]
        else:                       # shell 1, and no phase head at shell 0
            brdf = w / hpk_scl
    else:
        tmp1 = (ci / (ci + cv) / torch.cos(a.sza))[:, None]
        tmp2 = p * bk + hi * hv - 1.0
        brdf = w / hpk_scl * tmp1 * tmp2 * shad

    return brdf, p, bk, hi, hv, shad, ci, cv
