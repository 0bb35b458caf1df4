"""Reflectance analysis (the JAX package's analysis.py): per-pixel BRF
probes over varied view directions, and geometry diagnostics of a training
ray store.

Re-designs eval.py's eval_pixel_variedvw / get_view_dirs (eval.py:300-363):
for a chosen pixel's ray, locate the surface (rendered depth), then sweep a
fan of view zenith angles in the principal plane evaluating the model's
BRDF at the surface point for each view, the reflectance-vs-angle curves
of the paper's BRDF-recovery figures.  The probes render through
make_render_step (train=False) with the run's RenderConfig, on the device
the network lives on.  Their random draws: `draws`, a function of a
render's ray count giving that render's draws (a test hands in the JAX
package's), else a generator seeded with 0 for each render, as the JAX
package renders each probe with PRNGKey(0).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig, RenderConfig

Draws = Optional[Callable[[int], Dict[str, torch.Tensor]]]


def view_dir_fan(sun_d: np.ndarray, n: int = 33,
                 max_zen_deg: float = 60.0) -> np.ndarray:
    """(n, 3) unit view directions spanning the principal plane (the plane
    containing the sun direction and zenith), from -max_zen to +max_zen
    view zenith; negative zenith = backscatter side (toward the sun)."""
    sun_az = np.arctan2(sun_d[0], sun_d[1])
    zen = np.radians(np.linspace(-max_zen_deg, max_zen_deg, n))
    az = np.where(zen < 0, sun_az, sun_az + np.pi)
    z = np.abs(zen)
    dirs = np.stack([np.sin(az) * np.sin(z), np.cos(az) * np.sin(z),
                     np.cos(z)], -1)
    return dirs.astype(np.float32)


def _probe_render(net, mcfg: ModelConfig, rcfg: RenderConfig,
                  rays: np.ndarray, draws: Draws) -> Dict[str, np.ndarray]:
    """render_rays(train=False) of a few rays (the JAX package's
    _probe_render_fn), every output as a float32 numpy array."""
    from .parallel.train_step import make_render_step
    from .render.render import RenderInputs
    device = next(net.parameters()).device
    d = draws(rays.shape[0]) if draws is not None else None
    gen = None
    if d is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    inp = RenderInputs(rays=torch.from_numpy(rays).to(device),
                       cos_irra_on=torch.tensor(False, device=device))
    res = make_render_step(mcfg, rcfg)(net, inp, draws=d, generator=gen)
    return {k: v.float().cpu().numpy() for k, v in res.items()}


def brf_probe(net, mcfg: ModelConfig, rcfg: RenderConfig,
              ray: np.ndarray, n_views: int = 33,
              max_zen_deg: float = 60.0,
              draws: Draws = None) -> Dict[str, np.ndarray]:
    """BRF of the surface under one pixel as the view direction sweeps the
    principal plane.

    ray: (11,) [o, d, near, far, sun_d] normalized ray for the probed pixel.
    Returns dict with view_zenith_deg (n,), brf (n, 3), rgb (n, 3)."""
    ray = np.asarray(ray, np.float32)
    sun_d = ray[8:11]
    views = view_dir_fan(sun_d, n_views, max_zen_deg)

    # surface point from the pixel's own ray
    res0 = _probe_render(net, mcfg, rcfg, ray[None], draws)
    depth = float(res0["depth_coarse"][0])
    surf = ray[0:3] + depth * ray[3:6]

    # synthetic rays: each ray starts above the surface at the camera
    # position along the view direction and DESCENDS through the surface
    # (rays_d = -view), so the to-camera vector pts2c = -rays_d equals the
    # intended view direction and the surface sits mid-interval
    # (matches eval.py:300-363's get_view_dirs geometry).
    far = float(ray[7])
    origins = surf[None] + views * (0.5 * far)
    rays_v = np.zeros((n_views, 11), np.float32)
    rays_v[:, 0:3] = origins
    rays_v[:, 3:6] = -views
    rays_v[:, 6] = 0.0
    rays_v[:, 7] = far
    rays_v[:, 8:11] = sun_d
    res = _probe_render(net, mcfg, rcfg, rays_v, draws)

    zen_signed = np.linspace(-max_zen_deg, max_zen_deg, n_views)
    out = {"view_zenith_deg": zen_signed, "rgb": res["rgb_coarse"]}
    if "brdf_coarse" in res:
        brdf = res["brdf_coarse"]                   # (n, ns_b, 3)
        if brdf.shape[1] > 1:
            # multi_brdf: per-sample BRDF, accumulated with the sample
            # weights to get the SURFACE reflectance
            w = res["weights_coarse"][..., None]
            out["brf"] = np.sum(w * brdf, axis=1)
        else:
            out["brf"] = brdf[:, -1, :]
    if "albedo_accu_coarse" in res:
        out["albedo"] = res["albedo_accu_coarse"]
    return out


def get_view_dirs(view_elevation_deg, view_azimuth_deg) -> np.ndarray:
    """EXACT reference view-direction construction (eval.py:300-314
    get_view_dirs): flatten the elevation/azimuth grids and map
    (el, az) -> [sin(az)cos(el), cos(az)cos(el), sin(el)] (east-north-up;
    azimuth clockwise from north).  Returns (N, 3) float32."""
    view_el = np.radians(np.asarray(view_elevation_deg, np.float64)).ravel()
    view_az = np.radians(np.asarray(view_azimuth_deg, np.float64)).ravel()
    view_d = np.stack([np.sin(view_az) * np.cos(view_el),
                       np.cos(view_az) * np.cos(view_el),
                       np.sin(view_el)], axis=-1)
    return view_d.astype(np.float32)


def weighted_sample_sum(weights: np.ndarray, samples: np.ndarray):
    """get_s (eval.py:316-318): sum over the samples axis of
    weights[..., None] * samples, the rendered (expected-over-opacity)
    value of a per-sample quantity."""
    return np.sum(np.asarray(weights)[..., None] * np.asarray(samples),
                  axis=-2)


def pixel_param_probe(net, mcfg: ModelConfig, rcfg: RenderConfig,
                      ray: np.ndarray, n_rays: int = 5,
                      draws: Draws = None) -> Dict[str, np.ndarray]:
    """Per-pixel BRDF-parameter readout (eval.py:320-363
    eval_pixel_variedvw): tile the pixel's ray n_rays times (the reference
    uses 5 to expose sampling jitter), render, and reduce each per-sample
    head with the rendering weights: rpv_k / rpv_theta / rpv_rhoc,
    L2-normalized analytic normal, albedo, plus the mean irradiance.

    Returns {name: (n_rays, 3) array} with 'mean_<name>' rows matching
    the reference's printed means, plus the raw (n_rays, n_samples, 3)
    'irradiance' tensor and its all-axis 'mean_irradiance' scalar (the
    mean PrintMMM reports at eval.py:357)."""
    ray = np.asarray(ray, np.float32)
    rays = np.tile(ray[None], (n_rays, 1))
    res = _probe_render(net, mcfg, rcfg, rays, draws)
    typ = "fine" if "rgb_fine" in res else "coarse"
    w = res[f"weights_{typ}"]
    out: Dict[str, np.ndarray] = {}
    for name in ("rpv_k", "rpv_theta", "rpv_rhoc", "hpk_b", "hpk_c",
                 "hpk_theta", "roughness", "albedo"):
        if f"{name}_{typ}" in res:
            out[name] = weighted_sample_sum(w, res[f"{name}_{typ}"])
    if f"normal_an_{typ}" in res:
        n = weighted_sample_sum(w, res[f"normal_an_{typ}"])
        out["normal"] = n / np.maximum(
            np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    for name, v in list(out.items()):
        # the reference prints ALL-axis scalar means for the scalar-valued
        # heads (torch.mean(rpv_k_s), eval.py:353-355) but per-channel
        # dim=0 means for normal/albedo (eval.py:356-357)
        out[f"mean_{name}"] = (np.mean(v, axis=0)
                               if name in ("normal", "albedo")
                               else np.mean(v))
    if f"irradiance_{typ}" in res:
        # PrintMMM stats of the raw (n_rays, n_samples, 3) irradiance
        # tensor (eval.py:357): the tensor, and its mean over ALL axes
        irr = res[f"irradiance_{typ}"]
        out["irradiance"] = irr
        out["mean_irradiance"] = np.mean(irr)
    return out


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
