"""The rays on which chip_smoke.py's whole-step check holds the kernels to
their twins: chip_smoke.ill_conditioned on hand-made rays, and
chip_smoke.ill_conditioned_rays reading, from a small flagship-head
network's render, the cosines that RPV clamps (CPU, the port alone)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from brdfnerf_tpu_torch import config as tconfig
from brdfnerf_tpu_torch.models.network import init_network
from brdfnerf_tpu_torch.parallel.train_step import TrainGates
from brdfnerf_tpu_torch.render import render as trender

from torch_port_common import FLAGSHIP_HEADS, SMALL, make_store


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_rays", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _two_samples(ratio):
    """Two samples of weight 0.5 whose unit normals sum to length
    `ratio` (1: they agree; small: they cancel)."""
    b = float(np.sqrt(1.0 - ratio * ratio))
    normals = torch.tensor([[[ratio, b, 0.0], [ratio, -b, 0.0]]])
    return torch.full((1, 2), 0.5), normals


# (the samples' summed normal's length, cos i, cos v, ill-conditioned);
# err = 2^-8 / length, the band err / 0.1 above -err
CASES = [
    (1.0, 0.5, 0.6, False),       # well inside both cosines
    (1.0, 0.02, 0.5, True),       # cos i under err / 0.1 = 0.039
    (1.0, 0.05, 0.5, False),      # cos i above it
    (1.0, 0.3, 0.03, True),       # cos v under it
    (1.0, -0.3, 0.01, False),     # cos i held at the clamp: M1 ~ flat
    (1.0, -0.0226, 0.27, False),  # held: -0.0226 < -err = -0.0039
    (0.06, -0.0226, 0.27, True),  # cancelling normals: err = 0.065
    (1.0, 0.002, -0.002, True),   # both within err of the clamp
]


@pytest.mark.parametrize("ratio,ci,cv,want", CASES)
def test_ill_conditioned_criterion(ratio, ci, cv, want):
    cs = _chip_smoke()
    w, n = _two_samples(ratio)
    got = cs.ill_conditioned(w, n, torch.tensor([ci]), torch.tensor([cv]),
                             0.1)
    assert got.dtype == torch.bool and got.shape == (1,)
    assert bool(got[0]) is want


def test_ill_conditioned_rays_reads_the_cosines_rpv_clamps():
    """On a small flagship-head network's training render, the mask is the
    criterion on the render's weights, normals and nr_sun / nr_vw, and
    those are the cosines of the summed normal that RPV clamps (its ci /
    cv where they lie inside the clamp)."""
    cs = _chip_smoke()
    mcfg = tconfig.ModelConfig(**SMALL, **FLAGSHIP_HEADS,
                               compute_dtype="float32")
    rcfg = tconfig.RenderConfig(n_samples=8, guided_samples=8,
                                apply_brdf=True, use_pallas=True,
                                fused_trunk=True)
    net = init_network(mcfg, torch.Generator().manual_seed(0), device="cpu")
    n_rays = 32
    s = {k: torch.as_tensor(v) for k, v in make_store(n_rays, 4).items()}
    rng = torch.Generator().manual_seed(5)
    guided = (n_rays, rcfg.effective_guided)
    draws = {"z": torch.rand(n_rays, rcfg.n_samples, generator=rng),
             "guided": torch.rand(guided, generator=rng),
             "guided_gt": torch.rand(guided, generator=rng),
             "sun": torch.rand(n_rays, rcfg.sun_march_count(
                 rcfg.n_samples + rcfg.effective_guided), generator=rng)}
    gates = TrainGates(cos_irra_on=False, ds_on=True, nrrg_on=True,
                       beta_warmup=False, hs_on=True)
    got = cs.ill_conditioned_rays(net, mcfg, rcfg, s, draws, gates, 0.1)
    assert got.dtype == torch.bool and got.shape == (n_rays,)

    res = trender.render_rays(
        net, mcfg, rcfg, trender.RenderInputs(
            rays=s["rays"], ts=s["ts"], valid_depth=s["valid_depth"],
            target_depths=s["depths"], target_std=s["depth_std"],
            cos_irra_on=False), train=True, draws=draws)
    w, n = res["weights_coarse"], res["normal_an_coarse"]
    ci = res["nr_sun_coarse"].flatten()
    cv = res["nr_vw_coarse"].flatten()
    assert torch.equal(got, cs.ill_conditioned(w, n, ci, cv, 0.1))
    summed = torch.sum(w[..., None] * n, -2)
    unit = summed / summed.norm(dim=-1, keepdim=True)
    sun_d = s["rays"][:, 8:11]
    view = -s["rays"][:, 3:6]
    torch.testing.assert_close(ci, torch.sum(unit * sun_d, -1),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(cv, torch.sum(unit * view, -1),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(
        res["rpv_ci_coarse"].flatten(), ci.clamp(1e-5, 1 - 1e-6),
        atol=0, rtol=0)
    torch.testing.assert_close(
        res["rpv_cv_coarse"].flatten(), cv.clamp(1e-5, 1 - 1e-6),
        atol=0, rtol=0)


@pytest.mark.parametrize("shift,ok", [(0.0, True), (0.005, True),
                                      (0.05, False), (-0.05, False)])
def test_dbsig_bound_fails_a_five_percent_error(shift, ok):
    """chip_smoke.dbsig_held, the bf16 checks' bound on the sigma head's
    bias gradient: 1e-2 of its terms' L2 norm (f32_check.dbsig_scale), the
    twin's own K3 on a small bfloat16_all trunk.  A dbsig moved by 5% of
    that norm fails it, by 0.5% passes."""
    from brdfnerf_tpu_torch.ops import fused_mlp as tk1
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2
    from brdfnerf_tpu_torch.tools.f32_check import dbsig_scale
    cfg = tconfig.ModelConfig(**SMALL, compute_dtype="bfloat16_all")
    net = init_network(cfg, torch.Generator().manual_seed(0), device="cpu")
    packed = tk1.pack_trunk_weights(net, cfg, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    x = torch.zeros(128, 128)
    x[:, :60] = torch.rand(128, 60, generator=g) * 2 - 1
    _, _, _, zs, us = tk2._trunk_fwd_grad_plain(packed, cfg, x, True)
    cs = torch.randn(128, generator=g)
    cf = (torch.randn(128, 64, generator=g) * 0.1).to(torch.bfloat16)
    cg = torch.zeros(128, 128)
    cg[:, :60] = torch.randn(128, 60, generator=g)
    ref = tk2._trunk_bwd_plain(packed, cfg, x, cs, cf, cg, zs, us)[8]
    scale = dbsig_scale(packed, cfg, cs, cg, zs)
    assert scale > 0.0
    got = ref + shift * scale
    cs_mod = _chip_smoke()
    if ok:
        assert cs_mod.dbsig_held("K3", got, ref, scale) <= 1e-2
    else:
        with pytest.raises(AssertionError):
            cs_mod.dbsig_held("K3", got, ref, scale)


FAMILY_FIELDS = {
    "rpv": (dict(func_m=True, func_f=True, func_h=1), False),
    "hapke": (dict(hapke_b=True, hapke_c=True, hapke_theta=True,
                   hpk_scl=1.0), True),
    "hapke shell 3, stage 1": (dict(hapke_b=True, hapke_c=True,
                                    shell_hapke=3), None),
    "microfacet": (dict(roughness=True), False),
}


def _family_render(heads):
    """A hand-made training render of two rays with a nadir normal (two
    samples each with the same unit normal): one whose sun grazes it
    (cos i = 2e-3), one with the sun 60 degrees and the view 30 degrees
    from it, on one side (away from Microfacet's specular lobe, whose
    gradient a turn of the normal by 2^-8 moves by ~20% at the lobe)."""
    up = [0.0, 0.0, 1.0]
    sun = torch.tensor([[(1.0 - 4e-6) ** 0.5, 0.0, 2e-3],
                        [0.866, 0.0, 0.5]])
    sun = sun / sun.norm(dim=-1, keepdim=True)
    view = torch.tensor([[0.05, 0.02, 1.0], [0.5, 0.0, 0.866]])
    view = view / view.norm(dim=-1, keepdim=True)
    res = {"weights_coarse": torch.full((2, 2), 0.5),
           "normal_an_coarse": torch.tensor([[up, up], [up, up]]),
           "albedo_coarse": torch.full((2, 2, 3), 0.5),
           "sun_d_coarse": sun[:, None], "rays_d_coarse": view[:, None],
           "irradiance_coarse": torch.abs(sun[:, None, 2:3]).expand(
               2, 2, 3)}
    if heads:
        res.update({"hpk_b_coarse": torch.full((2, 2, 3), 0.4),
                    "hpk_c_coarse": torch.full((2, 2, 3), 0.6),
                    "hpk_theta_coarse": torch.full((2, 2, 1), 0.2),
                    "roughness_coarse": torch.full((2, 2, 1), 0.5),
                    "rpv_k_coarse": torch.full((2, 2, 3), 0.8),
                    "rpv_theta_coarse": torch.full((2, 2, 3), -0.2),
                    "rpv_rhoc_coarse": torch.full((2, 2, 3), 0.5)})
    return res, torch.full((2, 3), 0.3)


@pytest.mark.parametrize("family,normal_err,bound,want", [
    (f, 2.0 ** -8, 0.1, [True, False]) for f in FAMILY_FIELDS] + [
    # the float32 contract: RPV's and Microfacet's 1 / cos still set the
    # grazing ray aside; Hapke's roughness-effective cosines, floored at
    # 1e-3, leave its gradient determined to 1e-2
    ("rpv", 2.0 ** -14, 0.01, [True, False]),
    ("microfacet", 2.0 ** -14, 0.01, [True, False]),
    ("hapke", 2.0 ** -14, 0.01, [False, False])])
def test_brdf_criterion_sets_a_grazing_ray_aside(family, normal_err,
                                                 bound, want):
    """chip_smoke.brdf_ill_conditioned, the families' set-aside criterion
    (read by autograd from the BRDF the family shades with): at the bf16
    contract's normal error and bound the ray whose sun grazes its nadir
    normal is set aside and the nadir ray seen and lit off the normal is
    kept, for RPV, Hapke (stage 2, and a shell in stage 1) and
    Microfacet."""
    cs = _chip_smoke()
    fields, theta = FAMILY_FIELDS[family]
    mcfg = tconfig.ModelConfig(**SMALL, normal="analystic", **fields)
    rcfg = tconfig.RenderConfig(apply_brdf=theta is not None,
                                apply_theta=bool(theta))
    res, rgbs = _family_render(heads=theta is not None)
    got = cs.brdf_ill_conditioned(res, rgbs, mcfg, rcfg, bound, normal_err)
    assert got.dtype == torch.bool and got.tolist() == want


def test_brdf_criterion_reads_a_family_render():
    """brdf_ill_conditioned_rays on a small Hapke network's training
    render (fused twins): a mask over the batch; a turn of no size sets
    nothing aside."""
    cs = _chip_smoke()
    fields, _ = FAMILY_FIELDS["hapke"]
    mcfg = tconfig.ModelConfig(**SMALL, normal="analystic",
                               sun_v="analystic", **fields)
    rcfg = tconfig.RenderConfig(n_samples=8, guided_samples=8,
                                apply_brdf=True, apply_theta=True,
                                use_pallas=True, fused_trunk=True)
    net = init_network(mcfg, torch.Generator().manual_seed(0), device="cpu")
    n_rays = 32
    s = {k: torch.as_tensor(v) for k, v in make_store(n_rays, 4).items()}
    rng = torch.Generator().manual_seed(5)
    guided = (n_rays, rcfg.effective_guided)
    draws = {"z": torch.rand(n_rays, rcfg.n_samples, generator=rng),
             "guided": torch.rand(guided, generator=rng),
             "guided_gt": torch.rand(guided, generator=rng),
             "sun": torch.rand(n_rays, rcfg.sun_march_count(16),
                               generator=rng)}
    gates = TrainGates(cos_irra_on=False, ds_on=True, nrrg_on=True,
                       beta_warmup=False, hs_on=True)
    got = cs.brdf_ill_conditioned_rays(net, mcfg, rcfg, s, draws, gates,
                                       0.1)
    assert got.dtype == torch.bool and got.shape == (n_rays,)
    none = cs.brdf_ill_conditioned_rays(net, mcfg, rcfg, s, draws, gates,
                                        0.1, normal_err=0.0)
    assert not none.any()


def test_ill_conditioned_rays_with_a_fine_network():
    """With a fine network (n_importance > 0), the rays either pass leaves
    undetermined: the criterion on the coarse pass's weights, normals and
    cosines or on the fine pass's."""
    from brdfnerf_tpu_torch.models.network import init_params
    cs = _chip_smoke()
    mcfg = tconfig.ModelConfig(**SMALL, **FLAGSHIP_HEADS,
                               compute_dtype="float32")
    rcfg = tconfig.RenderConfig(n_samples=8, guided_samples=8,
                                n_importance=8, apply_brdf=True,
                                use_pallas=True, fused_trunk=True)
    params = init_params(mcfg, torch.Generator().manual_seed(0), 8,
                         device="cpu")
    n_rays = 32
    s = {k: torch.as_tensor(v) for k, v in make_store(n_rays, 4).items()}
    rng = torch.Generator().manual_seed(5)
    draws = {k: torch.rand(n_rays, 8, generator=rng)
             for k in ("z", "guided", "guided_gt", "sun", "pdf")}
    gates = TrainGates(cos_irra_on=False, ds_on=True, nrrg_on=True,
                       beta_warmup=False, hs_on=True)
    got = cs.ill_conditioned_rays(params, mcfg, rcfg, s, draws, gates, 0.1)
    res = trender.render_rays(
        params, mcfg, rcfg, trender.RenderInputs(
            rays=s["rays"], ts=s["ts"], valid_depth=s["valid_depth"],
            target_depths=s["depths"], target_std=s["depth_std"],
            cos_irra_on=False), train=True, draws=draws)
    each = [cs.ill_conditioned(
        res[f"weights_{t}"], res[f"normal_an_{t}"],
        res[f"nr_sun_{t}"].flatten(), res[f"nr_vw_{t}"].flatten(), 0.1)
        for t in ("coarse", "fine")]
    assert torch.equal(got, each[0] | each[1])


@pytest.mark.parametrize("terms,want", [
    ([("coarse", 3.0), ("coarse", 4.0)],
     {"coarse.sigma_from_xyz.0.b": 5.0}),
    ([("fine", 3.0), ("coarse", 4.0), ("fine", 4.0)],
     {"coarse.sigma_from_xyz.0.b": 4.0, "fine.sigma_from_xyz.0.b": 5.0})])
def test_sigma_bias_scales_per_network(terms, want):
    """The sigma head's bias gradient's terms' norm, each network's over
    its own backward calls (named where they are recorded)."""
    cs = _chip_smoke()
    got = cs.sigma_bias_scales(terms)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_all"])
def test_pack_owners_names_the_network_of_a_pack(dtype):
    """The step check names each backward call's network by the storage of
    the packed first trunk bias: the parameter's own, at every dtype."""
    from brdfnerf_tpu_torch.models.network import init_params
    from brdfnerf_tpu_torch.ops.fused_trunk_vjp import (_pack_params,
                                                        trunk_params)
    cs = _chip_smoke()
    mcfg = tconfig.ModelConfig(**SMALL, **FLAGSHIP_HEADS,
                               compute_dtype=dtype)
    params = init_params(mcfg, torch.Generator().manual_seed(0), 8,
                         device="cpu")
    owners = cs.pack_owners(params)
    for name in ("coarse", "fine"):
        packed = _pack_params(mcfg, trunk_params(getattr(params, name)))
        assert owners[packed["b0"].data_ptr()] == name


def test_fixed_fine_gives_every_render_the_same_fine_samples():
    """Inside fixed_fine the fine pass merges the given samples (rows of
    the batch) with the coarse ones, whatever the network; outside,
    sample_pdf draws its own."""
    from brdfnerf_tpu_torch.models.network import init_params
    cs = _chip_smoke()
    mcfg = tconfig.ModelConfig(**SMALL, **FLAGSHIP_HEADS,
                               compute_dtype="float32")
    rcfg = tconfig.RenderConfig(n_samples=8, guided_samples=8,
                                n_importance=8, apply_brdf=True)
    n_rays = 16
    s = {k: torch.as_tensor(v) for k, v in make_store(n_rays, 4).items()}
    rng = torch.Generator().manual_seed(5)
    draws = {k: torch.rand(n_rays, 8, generator=rng)
             for k in ("z", "guided", "sun", "pdf")}
    fine_z = torch.sort(torch.rand(n_rays, 8, generator=rng), -1).values
    rows = np.arange(3, 11)

    def zs(seed):
        params = init_params(mcfg, torch.Generator().manual_seed(seed), 8,
                             device="cpu")
        inp = trender.RenderInputs(rays=s["rays"][rows],
                                   cos_irra_on=False)
        with torch.no_grad():
            res = trender.render_rays(
                params, mcfg, rcfg, inp, train=True,
                draws={k: v[rows] for k, v in draws.items()})
        return res["z_vals_coarse"], res["z_vals_fine"]

    for seed in (0, 1):
        with cs.fixed_fine(fine_z, rows):
            z_c, z_f = zs(seed)
        want = torch.sort(torch.cat([z_c, fine_z[rows]], -1), -1).values
        assert torch.equal(z_f, want), seed
        z_c, z_f = zs(seed)
        assert not torch.isin(fine_z[rows], z_f).any(), seed
