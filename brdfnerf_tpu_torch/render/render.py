"""render_rays: the render orchestrator (counterpart of the JAX package's
render/render.py).  Pipeline per variant:

  nerf        : stratified -> classic inference
  s-nerf      : stratified -> shadow inference (+ solar-correction pass)
  sat-nerf    : stratified -> shadow inference (+ solar-correction pass)
  sps-nerf    : shadow pass -> guided samples around its depth -> merge
                sort -> shadow inference (+ solar-correction pass)
  spsbrdf-nerf: sigma-only pass -> guided samples -> merge sort
                -> [analytic sun-visibility march] -> spsbrdf inference
                (+ the learned sun's solar-correction pass)

The solar-correction passes run in training only, with sun_v='learned'
(their sole consumer is the sc loss).  With n_importance > 0 and a fine
network (models.network.Params), a fine pass follows: inverse-CDF samples
on the coarse weights, merged with the coarse samples, through the
variant's inference on the fine network (no sun march), its keys suffixed
_fine.  With a t table and the rays' `ts`, the rays' transient embeddings
feed the beta head.

Random draws: the JAX package splits one PRNG key per render call; here
each draw is a tensor, taken from `draws` when given (a test hands in the
JAX package's draws) or else from `generator`, in this order:

  draws["z"]       (N, n_samples)  stratified jitter
  draws["noise_probe"] (N, S)      N(0, 1) density noise of the probe pass
                                   (sps-nerf's first shadow pass,
                                   spsbrdf-nerf's sigma pass)
  draws["guided"]  (N, guided)     inverse-CDF draws of the guided band
                                   (sps-nerf, spsbrdf-nerf)
  draws["guided_gt"] (N, guided)   the same for the GT-depth band (train)
  draws["sun"]     (N, n_sun)      stratified jitter of the sun march
                                   (spsbrdf-nerf)
  draws["noise_sun"] (N, n_sun)    density noise of the sun march
  draws["noise"]   (N, S)          density noise of the main pass
  draws["noise_sc"] (N, S)         ... of the solar-correction pass (train)
  draws["pdf"]     (N, n_importance) the fine samples' inverse-CDF draws
                                   (perturb > 0)
  draws["noise_fine"] (N, S_fine)  density noise of the fine pass
The noise draws are taken only with noise_std > 0.  batch_draws makes
every draw of one render ahead, in this order, from one generator (what
the render would take from that generator), so that a data-parallel step
can hand each rank its rows of the global batch's draws.

The guided band's near/far and the sun march's scale read the batch's
first ray (the reference's ray 0); RenderInputs.ray0, when given, stands
for it: a rank of a data-parallel step passes the global batch's first
ray.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import ModelConfig, RenderConfig
from ..models.network import as_params
from ..ops.sampling import (guided_samples, linspace, sample_pdf,
                            stratified_z_vals)
from .inference import (inference_classic, inference_shadow,
                        inference_spsbrdf, sigma_pass, solar_correction_pass)


class RenderInputs(NamedTuple):
    """Per-batch inputs. rays: (N, 8) or (N, 11), [o(3), d(3), near, far,
    (sun_d(3))] (datasets/satellite.py:170-177)."""
    rays: torch.Tensor
    ts: Optional[torch.Tensor] = None
    valid_depth: Optional[torch.Tensor] = None
    target_depths: Optional[torch.Tensor] = None   # (N, 2) [depth, weight]
    target_std: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    cos_irra_on: Optional[torch.Tensor] = None     # bool scalar
    ray0: Optional[torch.Tensor] = None            # (1, 8|11): ray 0


def _noise(rcfg: RenderConfig, draws: Dict, name: str, like, generator):
    """The N(0, 1) density-noise draws `name` of a pass whose z samples are
    `like`: draws[name], else from `generator`; None with noise_std 0."""
    if rcfg.noise_std <= 0:
        return None
    if name in draws:
        v = draws[name]
        if tuple(v.shape) != tuple(like.shape):
            raise ValueError(f"draws[{name!r}] of shape {tuple(v.shape)}, "
                             f"need {tuple(like.shape)}")
        return v.to(device=like.device, dtype=like.dtype)
    if generator is None:
        raise ValueError(f"density noise needs draws[{name!r}] or a "
                         "generator")
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _resample_axis1(a, m: int):
    """Linear index-resampling of (N, n) -> (N, m) along axis 1 (identity
    when n == m): maps the sun-march transparency onto the merged sample
    axis."""
    n = int(a.shape[1])
    if n == m:
        return a
    pos = linspace(0.0, n - 1.0, m, like=a)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, 0, n - 1)
    w = (pos - lo.to(a.dtype))[None, :]
    return a[:, lo] * (1.0 - w) + a[:, hi] * w


def _guided(prev_result, rcfg: RenderConfig, near, far, train: bool,
            inp: RenderInputs, u=None, u_gt=None, generator=None):
    """Guided z samples around the probe's depth, detached like the
    reference's .detach() (rendering.py:212,262).  near/far are ray 0's,
    as in the reference (render.py:155): the batch's first ray, or
    inp.ray0."""
    target_depth = (inp.target_depths[:, 0]
                    if inp.target_depths is not None else None)
    if inp.ray0 is not None:
        near, far = inp.ray0[:, 6:7], inp.ray0[:, 7:8]
    z2 = guided_samples(
        prev_result["depth"], prev_result["weights"], prev_result["z_vals"],
        rcfg.effective_guided, near[0, 0], far[0, 0], train=train,
        valid_depth=inp.valid_depth if train else None,
        target_depth=target_depth, target_std=inp.target_std,
        d_range=(0.0001 if rcfg.guided_samples == 2 else rcfg.std_range),
        perturb=rcfg.perturb, u=u, u_gt=u_gt, generator=generator)
    z2 = torch.sort(z2, -1).values
    if rcfg.effective_guided == 1 and rcfg.guided_samples == 2:
        z2 = torch.mean(z2, 1, keepdim=True)    # rendering.py:264-265
    return z2.detach()


def _render_spsbrdf(net, mcfg, rcfg, inp, rays_o, rays_d, near, far, sun_d,
                    t_emb, z_vals, train: bool, draws: Dict,
                    generator) -> Dict:
    if rcfg.guided_samples <= 0:
        result = inference_spsbrdf(
            net, mcfg, rcfg, rays_o, rays_d, z_vals, sun_d, t_emb=t_emb,
            cos_irra_on=inp.cos_irra_on, rows=inp.rows, cols=inp.cols,
            noise=_noise(rcfg, draws, "noise", z_vals, generator))
        return _spsbrdf_sc(result, net, mcfg, rcfg, rays_o, sun_d, z_vals,
                           train, draws, generator)

    # phase 1: sigma only (rendering.py:232)
    res1 = sigma_pass(net, mcfg, rcfg, rays_o, rays_d, z_vals,
                      noise=_noise(rcfg, draws, "noise_probe", z_vals,
                                   generator))

    # guided merge (rendering.py:261-273)
    z2 = _guided(res1, rcfg, near, far, train, inp, u=draws.get("guided"),
                 u_gt=draws.get("guided_gt"), generator=generator)
    if rcfg.gsam_only:
        z_unsort = z_final = z2
    else:
        z_unsort = torch.cat([z_vals, z2], -1)
        z_final = torch.sort(z_unsort, -1).values

    # analytic sun-visibility march from the probe's surface toward the
    # sun (rendering.py:244-259); its transparency is resampled onto the
    # final sample axis.  The march scale uses ray 0 (render.py:206-208).
    sun_vis = sun_weights = None
    if mcfg.sun_v == "analystic" and (rcfg.apply_brdf
                                      or rcfg.force_sun_march):
        depth1 = res1["depth"]
        pt_surf = rays_o + rays_d * depth1[:, None]
        _, d0, s0 = ((rays_o, rays_d, sun_d) if inp.ray0 is None
                     else _ray_geometry(rcfg, inp.ray0))
        scale = torch.where(torch.abs(s0[0, 2]) > 1e-5,
                            torch.abs(d0[0, 2] / s0[0, 2]),
                            torch.ones_like(s0[0, 2]))
        far_sun = depth1[:, None] * scale
        n_sun = rcfg.sun_march_count(int(z_final.shape[1]))
        z_sun = stratified_z_vals(n_sun, far_sun * 0.01, far_sun,
                                  perturb=rcfg.perturb, u=draws.get("sun"),
                                  generator=generator)
        res_sun = sigma_pass(net, mcfg, rcfg, pt_surf, sun_d, z_sun,
                             noise=_noise(rcfg, draws, "noise_sun", z_sun,
                                          generator))
        trans = _resample_axis1(res_sun["transparency"],
                                int(z_final.shape[1]))
        sun_vis = trans[..., None].detach()
        sun_weights = res_sun["weights"].detach()

    # phase 2: full inference on the merged samples
    result = inference_spsbrdf(
        net, mcfg, rcfg, rays_o, rays_d, z_final, sun_d, t_emb=t_emb,
        sun_vis=sun_vis, sun_weights=sun_weights,
        cos_irra_on=inp.cos_irra_on, rows=inp.rows, cols=inp.cols,
        noise=_noise(rcfg, draws, "noise", z_final, generator))
    result["z_vals_unsort"] = z_unsort
    return _spsbrdf_sc(result, net, mcfg, rcfg, rays_o, sun_d, z_final,
                       train, draws, generator)


def _solar_correction(net, mcfg, rcfg, rays_o, sun_d, z_vals, t_emb,
                      draws: Dict, generator) -> Dict:
    """s-nerf's solar-correction pass: the shadow inference along the sun
    direction, whose transparency, weights and sun visibility feed the sc
    loss terms (rendering.py:194-204,218-224; metrics.py:30-37)."""
    if mcfg.sun_v != "learned":
        return {}
    res = inference_shadow(net, mcfg, rcfg, rays_o, sun_d, z_vals, sun_d,
                           t_emb=t_emb,
                           noise=_noise(rcfg, draws, "noise_sc", z_vals,
                                        generator))
    return {"weights_sc": res["weights"],
            "transparency_sc": res["transparency"], "sun_sc": res["sun"]}


def _spsbrdf_sc(result: Dict, net, mcfg, rcfg, rays_o, sun_d, z_vals,
                train: bool, draws: Dict, generator) -> Dict:
    """The spsbrdf solar-correction keys when sun_v is learned, from a
    sigma + learned-sun_v march along sun rays (solar_correction_pass)."""
    if mcfg.sun_v != "learned" or not train:
        return result
    sc = solar_correction_pass(net, mcfg, rcfg, rays_o, sun_d, z_vals,
                               noise=_noise(rcfg, draws, "noise_sc", z_vals,
                                            generator))
    result["weights_sc"] = sc["weights"]
    result["transparency_sc"] = sc["transparency"]
    result["sun_sc"] = sc["sun"]
    return result


def _ray_geometry(rcfg: RenderConfig, rays):
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    sun_d = (rays[:, 8:11] if (rcfg.use_sat_sun and rays.shape[1] >= 11)
             else torch.ones_like(rays_o))
    return rays_o, rays_d, sun_d


def _render_one(net, mcfg: ModelConfig, rcfg: RenderConfig,
                inp: RenderInputs, t_emb, train: bool, draws: Dict,
                generator) -> Dict:
    rays = inp.rays
    rays_o, rays_d, sun_d = _ray_geometry(rcfg, rays)
    near, far = rays[:, 6:7], rays[:, 7:8]
    # the reference jitters stratified samples at eval too (get_z_vals,
    # rendering.py:149-166)
    z_vals = stratified_z_vals(rcfg.n_samples, near, far, rcfg.use_disp,
                               rcfg.perturb, u=draws.get("z"),
                               generator=generator)
    variant = mcfg.variant
    if variant == "nerf":
        return inference_classic(net, mcfg, rcfg, rays_o, rays_d, z_vals,
                                 noise=_noise(rcfg, draws, "noise", z_vals,
                                              generator))
    if variant in ("s-nerf", "sat-nerf", "sps-nerf"):
        guided = variant == "sps-nerf" and rcfg.guided_samples > 0
        result = inference_shadow(
            net, mcfg, rcfg, rays_o, rays_d, z_vals, sun_d, t_emb=t_emb,
            noise=_noise(rcfg, draws, "noise_probe" if guided else "noise",
                         z_vals, generator))
        if guided:
            z2 = _guided(result, rcfg, near, far, train, inp,
                         u=draws.get("guided"), u_gt=draws.get("guided_gt"),
                         generator=generator)
            z_unsort = torch.cat([z_vals, z2], -1)
            z_vals = torch.sort(z_unsort, -1).values
            result = inference_shadow(
                net, mcfg, rcfg, rays_o, rays_d, z_vals, sun_d, t_emb=t_emb,
                noise=_noise(rcfg, draws, "noise", z_vals, generator))
            result["z_vals_unsort"] = z_unsort
        if train:
            result.update(_solar_correction(net, mcfg, rcfg, rays_o, sun_d,
                                            z_vals, t_emb, draws, generator))
        return result
    if variant == "spsbrdf-nerf":
        return _render_spsbrdf(net, mcfg, rcfg, inp, rays_o, rays_d, near,
                               far, sun_d, t_emb, z_vals, train, draws,
                               generator)
    raise ValueError(f"model {variant} is not valid")


def _render_fine(fine, mcfg: ModelConfig, rcfg: RenderConfig,
                 inp: RenderInputs, res_c: Dict, t_emb, draws: Dict,
                 generator) -> Dict:
    """The fine pass (rendering.py:294-332): n_importance inverse-CDF
    samples on the coarse weights' interior bins, detached and merged with
    the coarse samples, through the variant's inference on the fine
    network, with no sun march."""
    z_vals = res_c["z_vals"]
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_new = sample_pdf(z_mid, res_c["weights"][:, 1:-1], rcfg.n_importance,
                       det=(rcfg.perturb == 0), u=draws.get("pdf"),
                       generator=generator).detach()
    z_all = torch.sort(torch.cat([z_vals, z_new], -1), -1).values
    rays_o, rays_d, sun_d = _ray_geometry(rcfg, inp.rays)
    noise = _noise(rcfg, draws, "noise_fine", z_all, generator)
    if mcfg.variant == "nerf":
        return inference_classic(fine, mcfg, rcfg, rays_o, rays_d, z_all,
                                 noise=noise)
    if mcfg.variant in ("s-nerf", "sat-nerf", "sps-nerf"):
        return inference_shadow(fine, mcfg, rcfg, rays_o, rays_d, z_all,
                                sun_d, t_emb=t_emb, noise=noise)
    return inference_spsbrdf(fine, mcfg, rcfg, rays_o, rays_d, z_all, sun_d,
                             t_emb=t_emb, cos_irra_on=inp.cos_irra_on,
                             noise=noise)


def chunk_draws(mcfg: ModelConfig, rcfg: RenderConfig, n_rays: int,
                device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The draws that render_rays(train=False) takes from a generator seeded
    with `seed` for a batch of n_rays, made ahead in the order and shapes it
    consumes them (the module's list; the fine pass's where
    rcfg.n_importance > 0), so a caller can hand one batch's draws to many
    batches."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return batch_draws(mcfg, rcfg, n_rays, device, gen)


def batch_draws(mcfg: ModelConfig, rcfg: RenderConfig, n_rays: int, device,
                generator: torch.Generator, train: bool = False,
                gt_band: bool = False) -> Dict[str, torch.Tensor]:
    """Every draw render_rays(train=train) takes from `generator` for a
    batch of n_rays, in its order and shapes: the render handed these
    draws renders what it renders drawing from the generator.  gt_band:
    the batch has valid_depth (a train render then draws the GT-depth
    band's uniforms after the guided band's)."""
    draws: Dict[str, torch.Tensor] = {}
    noisy = rcfg.noise_std > 0
    learned_sc = train and mcfg.sun_v == "learned"

    def take(name: str, width: int, normal: bool = False):
        draw = torch.randn if normal else torch.rand
        draws[name] = draw((n_rays, width), generator=generator,
                           dtype=torch.float32, device=device)

    if rcfg.perturb > 0:
        take("z", rcfg.n_samples)
    n_main = rcfg.n_samples
    guided = (rcfg.guided_samples > 0
              and mcfg.variant in ("sps-nerf", "spsbrdf-nerf"))
    if guided:
        if noisy:
            take("noise_probe", rcfg.n_samples, normal=True)
        if rcfg.perturb != 0.0:
            take("guided", rcfg.effective_guided)
            if train and gt_band:
                take("guided_gt", rcfg.effective_guided)
        n_main = (rcfg.total_samples if mcfg.variant == "spsbrdf-nerf"
                  else rcfg.n_samples + rcfg.effective_guided)
        march = (mcfg.variant == "spsbrdf-nerf" and mcfg.sun_v == "analystic"
                 and (rcfg.apply_brdf or rcfg.force_sun_march))
        if march:
            n_sun = rcfg.sun_march_count(n_main)
            if rcfg.perturb > 0:
                take("sun", n_sun)
            if noisy:
                take("noise_sun", n_sun, normal=True)
    if noisy:
        take("noise", n_main, normal=True)
        # the solar-correction pass on the main samples (train, learned
        # sun: spsbrdf's sigma + sun march, the other variants' shadow
        # pass); vanilla NeRF has none
        if learned_sc and mcfg.variant != "nerf":
            take("noise_sc", n_main, normal=True)
    if rcfg.n_importance > 0:
        if rcfg.perturb != 0:
            take("pdf", rcfg.n_importance)
        if noisy:
            take("noise_fine", n_main + rcfg.n_importance, normal=True)
    return draws


def render_rays(params, mcfg: ModelConfig, rcfg: RenderConfig,
                inp: RenderInputs, train: bool = False,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """Render a batch of rays.  params: a models.network.Params (coarse,
    [fine], [t]) or a bare Network (the coarse network alone).  Returns a
    dict with keys suffixed _coarse, and _fine when n_importance > 0 and
    there is a fine network (rendering.py:289-291,331-332)."""
    params = as_params(params)
    coarse, fine, t_table = params.coarse, params.fine, params.t
    draws = draws or {}
    # the rays' transient embeddings (render.py:53-56)
    t_emb = (t_table[inp.ts.long()]
             if t_table is not None and inp.ts is not None else None)
    res = _render_one(coarse, mcfg, rcfg, inp, t_emb, train, draws,
                      generator)
    out = {f"{k}_coarse": v for k, v in res.items()}
    if rcfg.n_importance > 0 and fine is not None:
        res_f = _render_fine(fine, mcfg, rcfg, inp, res, t_emb, draws,
                             generator)
        out.update({f"{k}_fine": v for k, v in res_f.items()})
    return out
