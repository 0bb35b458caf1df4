"""Geometry diagnostics of a training ray store: the port's copy of
min_phase_angle_deg and warn_unobservable_brdf_params from the JAX
package's analysis.py (the rest of that module, the BRF probe, comes with
ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import numpy as np

from .config import ModelConfig


def min_phase_angle_deg(rays: np.ndarray, max_rays: int = 200_000) -> float:
    """Minimum sun-view phase angle (degrees) over a ray store.

    Phase angle = angle between the direction to the sensor (-rays_d; the
    stored ray direction points from the sensor DOWN toward the ground)
    and the direction to the sun (rays[:, 8:11], unit, pointing up).  The
    RPV hotspot factor H = 1 + (1-rhoc)/(1+G) and Hapke's backscatter
    asymmetry c only depart measurably from their priors near phase 0, so
    this minimum decides whether those parameters are observable at all.
    """
    rays = np.asarray(rays)
    if rays.ndim != 2 or rays.shape[1] < 11:
        return float("nan")               # no sun columns (blender data)
    if rays.shape[0] > max_rays:
        rays = rays[:: rays.shape[0] // max_rays + 1]
    v = -rays[:, 3:6]
    s = rays[:, 8:11]
    v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    s = s / np.maximum(np.linalg.norm(s, axis=1, keepdims=True), 1e-12)
    cosg = np.clip(np.sum(v * s, axis=1), -1.0, 1.0)
    return float(np.degrees(np.arccos(cosg)).min())


_WARNED_UNOBSERVABLE: set = set()


def warn_unobservable_brdf_params(rays: np.ndarray, mcfg: ModelConfig,
                                  threshold_deg: float = 10.0,
                                  once: bool = False) -> bool:
    """Print a warning when the run fits hotspot-gated BRDF parameters
    (RPV rhoc via funcH==1, Hapke c) on geometry that never samples the
    hotspot — the round-3 ground-truth inversion study (BASELINE.md
    identifiability table) measured rhoc/c unrecoverable (err ≈ 0.09+ on
    matched geometry) unless at least one view sits near phase angle 0,
    where they recover to <0.01.  Returns True when a warning fired."""
    fits_rhoc = mcfg.func_h == 1
    fits_c = bool(mcfg.hapke_c)
    if not (fits_rhoc or fits_c):
        return False
    g_min = min_phase_angle_deg(rays)
    if not np.isfinite(g_min) or g_min <= threshold_deg:
        return False
    names = " / ".join(n for n, on in
                       (("RPV rhoc", fits_rhoc), ("Hapke c", fits_c)) if on)
    # once=True: once per (geometry, params) per process — repeated
    # Trainer constructions over the same store (bench, sweeps) otherwise
    # repeat the same diagnosis in every log
    sig = (round(g_min, 1), names)
    if once:
        if sig in _WARNED_UNOBSERVABLE:
            return True
        _WARNED_UNOBSERVABLE.add(sig)
    print(f"[observability] minimum sun-view phase angle across the "
          f"training rays is {g_min:.1f} deg (> {threshold_deg:.0f} deg): "
          f"{names} is being fitted, but the hotspot these parameters "
          f"encode is never observed, so expect them to stay at their "
          f"priors (measured unrecoverable without a hotspot view, "
          f"BASELINE.md inversion study). Add a view with the sun behind "
          f"the sensor, or don't fit the parameter (funcH=2 / drop --c).",
          flush=True)
    return True
