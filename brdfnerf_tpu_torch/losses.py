"""Loss suite (counterpart of the JAX package's losses.py; reference:
metrics.py:11-290, main.py:194-353 gating).

All losses are pure functions over the render-result dict (keys suffixed
_coarse/_fine) and return (scalar, dict of terms).  The data-dependent
subset selection (valid-depth filtering, metrics.py:103-140) is a mask, and
the kept-fraction rescaling is reproduced with mask sums, as in the JAX
package.  The reference's quirks that the JAX package documents are kept:
normal_reg_loss sums over the flattened rays x samples axis, and
normal_loss's 'an_lr' term is mean(w) * mean(|diff|).

On a data-parallel mesh of several data ranks (parallel/mesh.Mesh,
`mesh`; under tensor parallelism its data axis, the ranks of a model
group computing the same shares), each rank holds an equal block of the
global batch, and every function
returns this rank's share of the global loss: the shares sum to the loss
the JAX package computes over the global batch, and so do their gradients,
which the step all-reduces.  A plain mean becomes the rank's sum over the
global count (_mean); a sum stays the rank's own; the counts and factors
that are not plain means (the depth loss's kept-ray test, the normal
loss's valid count, the 'an_lr' product of two means) are all-reduced
without a gradient first.  The metrics (_global_mean, perc) are the
global values on every rank.  With no mesh, or a mesh of one rank, every
formula is the single-device one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .ops.compositing import depth_std, depth_var


def _typs(results: Dict):
    return ["coarse", "fine"] if "rgb_fine" in results else ["coarse"]


def _world(mesh) -> int:
    return 1 if mesh is None else int(mesh.n_data)


def _mean(x, mesh=None):
    """torch.mean(x); on a mesh of several ranks, this rank's share of the
    mean over the global batch (the ranks' blocks are equal), whose sum
    over the ranks is that mean."""
    if _world(mesh) == 1:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * mesh.n_data)


def _global_sum(x, mesh=None):
    """x summed over the ranks, without a gradient (x on one rank)."""
    if _world(mesh) == 1:
        return x
    return mesh.sum(x.detach())


def _global_mean(x, mesh=None):
    """The mean of x over the global batch, on every rank (a metric)."""
    if _world(mesh) == 1:
        return torch.mean(x)
    return mesh.sum(_mean(x.detach(), mesh))


def nerf_loss(results: Dict, targets, mesh=None
              ) -> Tuple[torch.Tensor, Dict]:
    """Plain MSE color loss (metrics.py:11-22)."""
    d = {f"{typ}_color": _mean((results[f"rgb_{typ}"] - targets) ** 2, mesh)
         for typ in _typs(results)}
    return sum(d.values()), d


def _solar_correction_terms(d: Dict, results: Dict, typ: str,
                            lambda_sc: float, mesh=None) -> Dict:
    """s-nerf solar correction terms 2-3 (metrics.py:30-37)."""
    sun_sc = results[f"sun_sc_{typ}"].squeeze()
    t_sc = results[f"transparency_sc_{typ}"].detach()
    w_sc = results[f"weights_sc_{typ}"].detach()
    term2 = torch.sum((t_sc - sun_sc) ** 2, -1)
    term3 = 1.0 - torch.sum(w_sc * sun_sc, -1)
    d[f"{typ}_sc_term2"] = lambda_sc / 3.0 * _mean(term2, mesh)
    d[f"{typ}_sc_term3"] = lambda_sc / 3.0 * _mean(term3, mesh)
    return d


def snerf_loss(results: Dict, targets, lambda_sc: float = 0.05,
               lambda_rgb: float = 1.0, mesh=None
               ) -> Tuple[torch.Tensor, Dict]:
    """MSE + solar correction (metrics.py:39-61); the sc terms apply per
    typ where the render produced them, and lambda_rgb scales every term,
    sc included (metrics.py:57-58)."""
    d = {}
    for typ in _typs(results):
        d[f"{typ}_color"] = _mean((results[f"rgb_{typ}"] - targets) ** 2,
                                  mesh)
        if lambda_sc > 0 and f"sun_sc_{typ}" in results:
            d = _solar_correction_terms(d, results, typ, lambda_sc, mesh)
    d = {k: lambda_rgb * v for k, v in d.items()}
    return sum(d.values()), d


def satnerf_loss(results: Dict, targets, lambda_sc: float = 0.0,
                 beta_min: float = 0.05, mesh=None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Beta-uncertainty color loss (metrics.py:24-28,63-80); each typ uses
    its own beta head output, as in the JAX package."""
    d = {}
    for typ in _typs(results):
        beta_raw = results.get(f"beta_{typ}", results["beta_coarse"])
        beta = torch.sum(results[f"weights_{typ}"][..., None] * beta_raw,
                         -2) + beta_min
        d[f"{typ}_color"] = _mean(
            (results[f"rgb_{typ}"] - targets) ** 2 / (2 * beta ** 2), mesh)
        # the constant is shared out over the ranks with the mean
        d[f"{typ}_logbeta"] = (3 / _world(mesh)
                               + _mean(torch.log(beta), mesh)) / 2
        if lambda_sc > 0 and f"sun_sc_{typ}" in results:
            d = _solar_correction_terms(d, results, typ, lambda_sc, mesh)
    return sum(d.values()), d


def depth_loss(results: Dict, target_depth, target_weight=None,
               valid_depth=None, target_std=None, lambda_ds: float = 1.0,
               gnll: bool = False, usealldepth: bool = True,
               subset: bool = True, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Depth supervision (metrics.py:82-161).  subset=True (sps/spsbrdf):
    valid-depth rays only, and with usealldepth=False only those "not in
    the expected distribution"; weighted MSE (or GNLL) scaled by the kept
    fraction: the kept rays' sum over the global batch size, zero where
    the global batch keeps no ray."""
    d = {}
    for typ in _typs(results):
        pred_depth = results[f"depth_{typ}"]
        if not subset:
            d[f"{typ}_ds"] = _mean((pred_depth - target_depth) ** 2, mesh)
            continue
        z_vals = results[f"z_vals_{typ}"]
        pred_weight = results[f"weights_{typ}"]
        pred_std = depth_std(z_vals, pred_depth, pred_weight)
        keep = (torch.ones_like(pred_depth) if valid_depth is None
                else (valid_depth > 0).to(pred_depth.dtype))
        if not usealldepth:
            not_expected = torch.logical_or(
                (torch.abs(pred_depth - target_depth) - target_std) > 0.0,
                target_std < pred_std)
            keep = keep * not_expected.to(keep.dtype)
        tw = (torch.ones_like(pred_depth) if target_weight is None
              else target_weight)
        if gnll:
            var = torch.clamp(pred_std ** 2, min=1e-6)
            per_ray = 0.5 * (torch.log(var)
                             + (pred_depth - target_depth) ** 2 / var)
        else:
            per_ray = tw * (pred_depth - target_depth) ** 2
        denom = float(pred_depth.shape[0] * _world(mesh))
        loss = torch.sum(per_ray * keep) / denom
        d[f"{typ}_ds"] = torch.where(_global_sum(torch.sum(keep), mesh) > 0,
                                     loss, torch.zeros_like(loss))
    d = {k: (lambda_ds / 3.0) * v for k, v in d.items()}
    return sum(d.values()), d


def normal_reg_loss(results: Dict, lambda_nr_reg: float = 0.1,
                    keyword: str = "normal_an", mesh=None):
    """Penalise backward-facing normals (metrics.py:179-216).  Returns
    (loss, dict, percent bad).  The sum runs over the flattened
    rays x samples axis (metrics.py:200), so the term scales with the
    batch (on a mesh, the rank's sum is its share)."""
    d = {}
    perc = torch.zeros(())
    for typ in _typs(results):
        normal = results[f"{keyword}_{typ}"].reshape(-1, 3)
        weights = results[f"weights_{typ}"].reshape(-1)
        view_dir = results[f"rays_d_{typ}"].reshape(-1, 3)
        view = torch.repeat_interleave(
            view_dir, normal.shape[0] // view_dir.shape[0], dim=0)
        n_dot_v = torch.sum(normal * view, -1)
        perc = 100.0 * _global_mean((n_dot_v < 0).float(), mesh)
        d[f"{typ}_nr_reg_{keyword[-2:]}"] = torch.sum(
            weights * torch.clamp(n_dot_v, max=0.0) ** 2, -1)
    d = {k: lambda_nr_reg * torch.mean(v) for k, v in d.items()}
    return sum(d.values()), d, perc


def normal_loss(weights, normal_gt, normal_pred,
                lambda_nr_spv: float = 0.001, target_weight=None,
                valid_depth=None, keyword: str = "an_lr", mesh=None):
    """Normal supervision (metrics.py:218-261).  'an_lr': mean(w) times
    the global mean |diff| (metrics.py:254's l1_loss collapses first);
    otherwise the L1 between the GT normal and the weight-accumulated one on
    the valid-depth subset, weighted by target_weight.

    On a mesh of several ranks the product of two means is split so that
    the shares and their gradients sum to the global ones:
    share = mw_r * L1 + MW * l1_r - MW * L1 / W, with mw_r and l1_r the
    rank's shares of the means and MW, L1 the global means, all-reduced
    without a gradient."""
    d = {}
    typ = "coarse"
    if keyword == "an_lr" and _world(mesh) > 1:
        l1_r = _mean(torch.abs(normal_gt - normal_pred), mesh)
        mw_r = _mean(weights, mesh)
        l1_g, mw_g = _global_sum(l1_r, mesh), _global_sum(mw_r, mesh)
        d[f"{typ}_nrspv_{keyword}"] = (mw_r * l1_g + mw_g * l1_r
                                       - mw_g * l1_g / mesh.n_data)
    elif keyword == "an_lr":
        l1 = torch.mean(torch.abs(normal_gt - normal_pred))
        d[f"{typ}_nrspv_{keyword}"] = weights.reshape(-1) * l1
    else:
        pred_s = torch.sum(weights[..., None] * normal_pred, -2)
        n = pred_s.shape[0]
        valid = (torch.ones(n, dtype=pred_s.dtype, device=pred_s.device)
                 if valid_depth is None
                 else (valid_depth > 0).to(pred_s.dtype))
        tw = (torch.ones(n, dtype=pred_s.dtype, device=pred_s.device)
              if target_weight is None else target_weight)
        diff = torch.abs(tw[:, None] * normal_gt - tw[:, None] * pred_s)
        num = torch.clamp(_global_sum(torch.sum(valid), mesh), min=1.0)
        d[f"{typ}_nrspv_{keyword}"] = (
            torch.sum(diff * valid[:, None]) / (num * 3.0))
    d = {k: lambda_nr_spv * torch.mean(v) for k, v in d.items()}
    return sum(d.values()), d


def hard_surface_loss(results: Dict, lambda_hs: float = 0.5, mesh=None):
    """Mean weighted depth variance (metrics.py:263-290)."""
    d = {f"{typ}_hs_reg": depth_var(results[f"z_vals_{typ}"],
                                    results[f"depth_{typ}"],
                                    results[f"weights_{typ}"])
         for typ in _typs(results)}
    d = {k: lambda_hs * _mean(v, mesh) for k, v in d.items()}
    return sum(d.values()), d


def load_loss(variant: str, beta: bool, sc_lambda: float,
              lambda_rgb: float, mesh=None):
    """Loss factory (metrics.py:163-177).  Returns f(results, targets)."""
    if variant == "nerf":
        return lambda r, t: nerf_loss(r, t, mesh=mesh)
    if variant == "s-nerf":
        return lambda r, t: snerf_loss(r, t, lambda_sc=sc_lambda, mesh=mesh)
    if variant in ("sat-nerf", "sps-nerf"):
        if beta:
            return lambda r, t: satnerf_loss(r, t, lambda_sc=sc_lambda,
                                             mesh=mesh)
        return lambda r, t: snerf_loss(r, t, lambda_sc=sc_lambda, mesh=mesh)
    if variant == "spsbrdf-nerf":
        return lambda r, t: snerf_loss(r, t, lambda_sc=sc_lambda,
                                       lambda_rgb=lambda_rgb, mesh=mesh)
    raise ValueError(f"model {variant} is not valid")
