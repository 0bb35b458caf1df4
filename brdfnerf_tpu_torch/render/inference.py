"""Volume-rendering inference over one set of z samples (counterpart of the
JAX package's render/inference.py): nerf's classic inference, the shadow
inference of s-nerf / sat-nerf / sps-nerf, the sigma-only pass, the
solar-correction pass along sun rays and the spsbrdf inference with the
RPV, Hapke and Microfacet BRDFs, per ray or per sample (multi_brdf).  The
variants other than spsbrdf run no fused kernel, as in the JAX package
(apply_network, analytic_normals), and neither does spsbrdf's main pass
with normal_at_surface (one analytic normal a ray, by autograd).

`noise`: the N(0, 1) draws of a pass's density noise, (N_rays, N_samples),
used when rcfg.noise_std > 0 (ops/compositing.composite).  `t_emb`: the
rays' transient embeddings (N_rays, tau), which the beta head takes."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import ModelConfig, RenderConfig
from ..models.network import (analytic_normals, apply_network,
                              apply_network_with_normals, sigma_and_sun_v)
from ..ops.compositing import composite, l2_normalize
from ..brdf.common import clip
from ..brdf.hapke import hapke_brdf
from ..brdf.microfacet import microfacet_brdf
from ..brdf.rpv import rpv_brdf


def _flat_points(rays_o, rays_d, z_vals):
    """(N,3),(N,3),(N,S) -> points (N,S,3)."""
    return rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]


def _expand(v, n_samples):
    """Per-ray (N,C) -> per-sample flat (N*S, C)."""
    if v is None:
        return None
    return torch.repeat_interleave(v, n_samples, dim=0)


def inference_classic(net, mcfg: ModelConfig, rcfg: RenderConfig, rays_o,
                      rays_d, z_vals, noise=None) -> Dict:
    """Vanilla NeRF (models/nerf.py:72-147): rgb_padding and plain
    compositing."""
    n_rays, n_samples = z_vals.shape
    xyz = _flat_points(rays_o, rays_d, z_vals).reshape(-1, 3)
    out = apply_network(net, mcfg, xyz, dirs=_expand(rays_d, n_samples))
    rgbs = out["rgb"].reshape(n_rays, n_samples, 3)
    # nerf.py:273-274
    rgbs = rgbs * (1 + 2 * mcfg.rgb_padding) - mcfg.rgb_padding
    sigmas = out["sigma"].reshape(n_rays, n_samples)
    alphas, transparency, weights, depth = composite(
        z_vals, sigmas, rcfg.noise_std, noise)
    result = {"rgb": torch.sum(weights[..., None] * rgbs, -2),
              "depth": depth, "weights": weights, "z_vals": z_vals,
              "sigmas": sigmas[..., None], "alphas": alphas,
              "transparency": transparency}
    if mcfg.normal in ("analystic", "analystic_learned"):
        result["normal_an"] = analytic_normals(net, mcfg, xyz).reshape(
            n_rays, n_samples, 3)
    return result


def inference_shadow(net, mcfg: ModelConfig, rcfg: RenderConfig, rays_o,
                     rays_d, z_vals, sun_d, t_emb=None, noise=None) -> Dict:
    """s-nerf / sat-nerf / sps-nerf inference (snerf.py:4-75,
    satnerf.py:5-100): irradiance = sun_v + (1 - sun_v) * sky (s-nerf
    eq. 2); the beta head's output with t_emb."""
    n_rays, n_samples = z_vals.shape
    xyz = _flat_points(rays_o, rays_d, z_vals).reshape(-1, 3)
    out = apply_network(net, mcfg, xyz, sun_d=_expand(sun_d, n_samples),
                        t_emb=_expand(t_emb, n_samples))
    rgbs = out["rgb"].reshape(n_rays, n_samples, 3)
    sigmas = out["sigma"].reshape(n_rays, n_samples)
    sun_v = out["sun_v"].reshape(n_rays, n_samples, 1)
    sky = out["sky"].reshape(n_rays, n_samples, 3)
    alphas, transparency, weights, depth = composite(
        z_vals, sigmas, rcfg.noise_std, noise)
    irradiance = sun_v + (1.0 - sun_v) * sky
    rgb = clip(torch.sum(weights[..., None] * rgbs * irradiance, -2),
               0.0, 1.0)
    result = {"rgb": rgb, "depth": depth, "weights": weights,
              "transparency": transparency, "albedo": rgbs, "sun": sun_v,
              "sky": sky, "sigmas": sigmas[..., None], "alphas": alphas,
              "z_vals": z_vals}
    if mcfg.beta and "beta" in out:
        result["beta"] = out["beta"].reshape(n_rays, n_samples, 1)
    if mcfg.normal in ("analystic", "analystic_learned"):
        result["normal_an"] = analytic_normals(net, mcfg, xyz).reshape(
            n_rays, n_samples, 3)
    return result


def sigma_pass(net, mcfg: ModelConfig, rcfg: RenderConfig, rays_o, rays_d,
               z_vals, noise=None) -> Dict:
    """sigma_only=True pass (spsbrdfnerf.py:127-136).  With
    rcfg.use_pallas the trunk runs through the fused trunk-sigma kernel;
    every consumer of this pass detaches it."""
    n_rays, n_samples = z_vals.shape
    xyz = _flat_points(rays_o, rays_d, z_vals).reshape(-1, 3)
    from ..ops.fused_mlp import kernel_supports
    if rcfg.use_pallas and kernel_supports(mcfg):
        from ..models.network import refuse_kernels
        from ..ops.fused_mlp import fused_sigma_fn
        refuse_kernels(net)
        with torch.no_grad():
            sigmas = fused_sigma_fn(net, mcfg, xyz.detach())
        sigmas = sigmas.reshape(n_rays, n_samples)
    else:
        from ..models.network import sigma_fn
        sigmas = sigma_fn(net, mcfg, xyz).reshape(n_rays, n_samples)
    alphas, transparency, weights, depth = composite(
        z_vals, sigmas, rcfg.noise_std, noise)
    return {"sigmas": sigmas[..., None], "depth": depth, "alphas": alphas,
            "weights": weights, "transparency": transparency,
            "z_vals": z_vals}


def solar_correction_pass(net, mcfg: ModelConfig, rcfg: RenderConfig,
                          rays_o, sun_d, z_vals, noise=None) -> Dict:
    """The solar-correction pass of spsbrdf-nerf with sun_v='learned':
    march along sun rays from each ray origin (xyz = o + sun_d * z, the
    s-nerf convention, rendering.py:199-204,219-224), composite sigma for
    transparency and weights, and query the learned sun visibility at each
    point: the reference's intended rendering.py:278-284, whose
    inference_sun is undefined."""
    n_rays, n_samples = z_vals.shape
    xyz = _flat_points(rays_o, sun_d, z_vals).reshape(-1, 3)
    sigma, sun_v = sigma_and_sun_v(net, mcfg, xyz,
                                   _expand(sun_d, n_samples))
    _, transparency, weights, _ = composite(
        z_vals, sigma.reshape(n_rays, n_samples), rcfg.noise_std, noise)
    return {"sun": sun_v.reshape(n_rays, n_samples, 1), "weights": weights,
            "transparency": transparency}


def inference_spsbrdf(net, mcfg: ModelConfig, rcfg: RenderConfig,
                      rays_o, rays_d, z_vals, sun_d, t_emb=None,
                      sun_vis: Optional[torch.Tensor] = None,
                      sun_weights: Optional[torch.Tensor] = None,
                      cos_irra_on=None, rows=None, cols=None,
                      noise=None) -> Dict:
    """Full SpSBRDF inference (spsbrdfnerf.py:71-416).

    sun_vis: optional (N_rays, N_samples, 1) analytic sun visibility from
    the sun-march pass; cos_irra_on: bool selecting the |cos(up, sun)|
    irradiance (spsbrdfnerf.py:259-264).  With rcfg.normal_at_surface the
    main pass takes no normals (apply_network: no K2/K3) and one analytic
    normal a ray, at o + d * depth, stands for every sample's.  With
    mcfg.multi_brdf the BRDF shades every sample and the weights composite
    the shaded samples."""
    n_rays, n_samples = z_vals.shape
    xyz = _flat_points(rays_o, rays_d, z_vals).reshape(-1, 3)
    dirs_flat = _expand(rays_d, n_samples) if mcfg.input_sizes[1] > 0 else None
    sun_flat = _expand(sun_d, n_samples)
    t_flat = _expand(t_emb, n_samples)

    apply_brdf = rcfg.apply_brdf
    nr_lr = mcfg.normal in ("analystic_learned", "learned")
    nr_an = mcfg.normal in ("analystic", "analystic_learned")
    at_surface = nr_an and rcfg.normal_at_surface
    if nr_an and not at_surface:
        out = apply_network_with_normals(
            net, mcfg, xyz, dirs=dirs_flat, sun_d=sun_flat, t_emb=t_flat,
            apply_brdf=apply_brdf, apply_theta=rcfg.apply_theta,
            nr_lr=nr_lr, fused_trunk=rcfg.fused_trunk)
    else:
        out = apply_network(
            net, mcfg, xyz, dirs=dirs_flat, sun_d=sun_flat, t_emb=t_flat,
            apply_brdf=apply_brdf, apply_theta=rcfg.apply_theta,
            nr_lr=nr_lr)

    albedo = out["rgb"].reshape(n_rays, n_samples, 3)
    sigmas = out["sigma"].reshape(n_rays, n_samples)

    # single-sample rays have unit weights (spsbrdfnerf.py:192-194)
    if n_samples == 1:
        weights = torch.ones_like(z_vals)
        transparency = torch.ones_like(z_vals)
        alphas = torch.ones_like(z_vals)
        depth = torch.sum(weights * z_vals, -1)
    else:
        alphas, transparency, weights, depth = composite(
            z_vals, sigmas, rcfg.noise_std, noise)

    albedo_accu = clip(torch.sum(weights[..., None] * albedo, -2), 0.0, 1.0)
    result: Dict = {"sigmas": sigmas[..., None], "albedo": albedo,
                    "albedo_accu": albedo_accu, "depth": depth,
                    "alphas": alphas, "weights": weights,
                    "transparency": transparency, "z_vals": z_vals}

    # sun visibility: learned head or analytic march (spsbrdfnerf.py:143-152)
    sun_v = None
    if mcfg.sun_v == "learned" and "sun_v" in out:
        sun_v = out["sun_v"].reshape(n_rays, n_samples, 1)
    elif mcfg.sun_v == "analystic" and sun_vis is not None:
        sun_v = sun_vis
    if sun_v is not None:
        result["sun"] = sun_v
        if sun_weights is not None:
            result["weights_sc"] = sun_weights
    if mcfg.indirect_light and "sky" in out:
        result["sky"] = out["sky"].reshape(n_rays, n_samples, 3)
    if mcfg.beta and "beta" in out:
        result["beta"] = out["beta"].reshape(n_rays, n_samples, 1)

    normal = None
    if nr_an:
        if at_surface:
            x_surf = rays_o + rays_d * depth[:, None]
            normal = analytic_normals(net, mcfg, x_surf)[:, None, :].expand(
                n_rays, n_samples, 3)
        else:
            normal = out["normal_an"].reshape(n_rays, n_samples, 3)
        result["normal_an"] = normal
    if nr_lr and "normal_lr" in out:
        normal = out["normal_lr"].reshape(n_rays, n_samples, 3)
        result["normal_lr"] = normal    # preferred for BRDF (spsbrdfnerf.py:234-239)

    normal_s = None
    if normal is not None:
        normal_s = l2_normalize(torch.sum(weights[..., None] * normal, -2))
        nr_vw = torch.sum(normal_s * -rays_d, -1)
        nr_sun = torch.sum(normal_s * sun_d, -1)
        result["nr_vw"] = nr_vw.reshape(n_rays, 1, 1)
        result["nr_sun"] = nr_sun.reshape(n_rays, 1, 1)
        result["hpk_scl"] = 1.0 / (mcfg.hpk_scl
                                   * (result["nr_vw"] + result["nr_sun"]))

    # irradiance (spsbrdfnerf.py:259-268)
    irradiance = torch.ones_like(albedo)
    if sun_v is not None:
        irradiance = sun_v.repeat(1, 1, 3)
        if mcfg.indirect_light and "sky" in result:
            irradiance = sun_v + (1.0 - sun_v) * result["sky"]   # s-nerf eq. 2
    if normal is not None and cos_irra_on is not None:
        # fixed upward normal, not the learned one (spsbrdfnerf.py:261-262)
        irr_cos = torch.ones_like(albedo) * torch.abs(sun_d[:, None, 2:3])
        irradiance = torch.where(torch.as_tensor(cos_irra_on,
                                                 device=albedo.device),
                                 irr_cos, irradiance)

    albedo_p = albedo * (1 + 2 * mcfg.rgb_padding) - mcfg.rgb_padding
    result["rgb"] = clip(
        torch.sum(weights[..., None] * albedo_p * irradiance, -2), 0.0, 1.0)
    result["irradiance"] = irradiance
    albedo_s = torch.sum(weights[..., None] * albedo_p, -2)

    # a Hapke shell shades stage 1 too (brdf_active, inference.py:268)
    if apply_brdf or (mcfg.uses_hapke and mcfg.shell_hapke > 0):
        if normal is None:
            raise ValueError(
                "apply_brdf requires a normal mode ('analystic', 'learned' "
                "or 'analystic_learned'), got normal='none': the BRDF "
                "geometry terms need surface normals (spsbrdfnerf.py:234-239)")

        multi = mcfg.multi_brdf
        ns_b = n_samples if multi else 1

        def accum(v):   # per-sample (N,S,C) -> weighted sum (N,C)
            return torch.sum(weights[..., None] * v, -2)

        def per(v):     # the BRDF's input of a per-sample (N,S,C) field
            return v.reshape(-1, v.shape[-1]) if multi else accum(v)

        if multi:
            pts2l, pts2c = sun_flat, -_expand(rays_d, n_samples)
            nrm, alb = normal.reshape(-1, 3), albedo.reshape(-1, 3)
        else:
            pts2l, pts2c, nrm, alb = sun_d, -rays_d, normal_s, albedo_s

        brdf = None
        if mcfg.roughness and apply_brdf:
            rough = out["roughness"].reshape(n_rays, n_samples, 1)
            result["roughness"] = rough
            glossy, brdf, f, g, d, ldn, vdn, h, n_h = microfacet_brdf(
                pts2l, pts2c, nrm, alb, per(rough),
                f0=mcfg.fresnel_f0, glossy_scale=mcfg.glossy_scale)
            result.update(
                glossy=glossy.reshape(n_rays, ns_b, 1),
                brdf=brdf.reshape(n_rays, ns_b, 3),
                f=f.reshape(n_rays, ns_b, 1), g=g.reshape(n_rays, ns_b, 1),
                d=d.reshape(n_rays, ns_b, 1),
                l_dot_n=ldn.reshape(n_rays, ns_b, 1),
                v_dot_n=vdn.reshape(n_rays, ns_b, 1),
                halfvec=h.reshape(n_rays, ns_b, 3),
                n_h=n_h.reshape(n_rays, ns_b, 1))
        elif mcfg.rpv and apply_brdf:
            def per_head(name):
                return per(out[name].reshape(n_rays, n_samples, 3))
            k = per_head("rpv_k") if mcfg.func_m else None
            th = per_head("rpv_theta") if mcfg.func_f else None
            if mcfg.func_h == 2:
                rc = alb                        # spsbrdfnerf.py:306,317
            elif mcfg.func_h:
                rc = per_head("rpv_rhoc")
            else:
                rc = None
            brdf, m1, f, g, h, ci, cv = rpv_brdf(pts2l, pts2c, nrm, alb, k,
                                                 th, rc)
            # every factor of brdf = w * M1 * F * H plus the hotspot
            # distance G, beyond the reference's stored keys
            result.update(
                brdf=brdf.reshape(n_rays, ns_b, 3),
                rpv_M1=m1.reshape(n_rays, ns_b, -1),
                rpv_F=f.reshape(n_rays, ns_b, -1),
                rpv_G=g.reshape(n_rays, ns_b, -1),
                rpv_H=h.reshape(n_rays, ns_b, -1),
                rpv_ci=ci.reshape(n_rays, ns_b, 1),
                rpv_cv=cv.reshape(n_rays, ns_b, 1))
            for name in ("rpv_k", "rpv_theta", "rpv_rhoc"):
                if name in out:
                    result[name] = out[name].reshape(n_rays, n_samples, 3)
        elif mcfg.uses_hapke:
            b = c = theta = None
            if apply_brdf and mcfg.hapke_b:
                result["hpk_b"] = out["hpk_b"].reshape(n_rays, n_samples, 3)
                b = per(result["hpk_b"])
            if apply_brdf and mcfg.hapke_c:
                result["hpk_c"] = out["hpk_c"].reshape(n_rays, n_samples, 3)
                c = per(result["hpk_c"])
            if rcfg.apply_theta and mcfg.hapke_theta and "hpk_theta" in out:
                ht = out["hpk_theta"].reshape(n_rays, n_samples, 1)
                result["hpk_theta"] = ht
                theta = (ht.reshape(-1) if multi
                         else torch.sum(weights * ht[..., 0], -1))
            brdf, p, bk, hi, hv, shad, ci, cv = hapke_brdf(
                pts2l, pts2c, nrm, alb, b, c, theta,
                hpk_scl=mcfg.hpk_scl, shell_hapke=mcfg.shell_hapke)
            result.update(
                brdf=brdf.reshape(n_rays, ns_b, 3),
                hpk_P=p.reshape(n_rays, ns_b, 3),
                hpk_Hi=hi.reshape(n_rays, ns_b, 3),
                hpk_Hv=hi.reshape(n_rays, ns_b, 3),  # (sic) spsbrdfnerf.py:387
                hpk_ci=ci.reshape(n_rays, ns_b, 1),
                hpk_cv=cv.reshape(n_rays, ns_b, 1),
                hpk_ShadFunc=shad.reshape(n_rays, ns_b, 1))
        if brdf is not None:
            if multi:
                brdf3 = brdf.reshape(n_rays, n_samples, 3)
                brdf3 = brdf3 * (1 + 2 * mcfg.rgb_padding) - mcfg.rgb_padding
                rgb = torch.sum(weights[..., None] * brdf3 * irradiance, -2)
            else:
                rgb = irradiance[:, -1, :] * brdf.reshape(n_rays, 3)
            result["rgb"] = clip(rgb, 0.0, 1.0)

    result["rays_d"] = (-rays_d).reshape(n_rays, 1, 3)
    result["sun_d"] = sun_d.reshape(n_rays, 1, 3)

    if rows is not None and cols is not None:
        # debug reference sphere (spsbrdfnerf.py:404-412)
        ref = torch.ones(n_rays, 1, 3, dtype=albedo.dtype,
                         device=albedo.device)
        ref[:, :, 0] = cols.reshape(n_rays, 1)
        ref[:, :, 1] = -rows.reshape(n_rays, 1)
        ref[:, :, 2] = torch.sqrt(
            torch.abs(1 - rows * rows - cols * cols)).reshape(n_rays, 1)
        result["ref_sphere"] = ref
    return result
