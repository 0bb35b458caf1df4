"""The Hapke and Microfacet BRDF families on the spsbrdf-nerf kernel path,
against the JAX package on the CPU, at 4 x 64 with the JAX package's
weights (params_from_flat): the heads (the fused trunk's twin and
autograd), inference_spsbrdf, compute_losses for stage 2 (fused and
unfused) and for a Hapke shell in stage 1, and three fused train steps
(the CLIs' Hapke handoff: tests/test_torch_port_families_cli.py).  On the
card (marked cuda), a family's step launches
K1 2 / K2 1 / K3 1 and its request K1 2 / K2 1 a chunk, K4/K5 none with
BRDFNERF_FUSED_HEADS set.

The families change only the heads (network._heads_from_feats) and the
per-ray BRDF (inference_spsbrdf); the trunk is K1's and K2/K3's, whose
twins run here against the Pallas kernels in interpret mode.

Tolerances: heads and inference_spsbrdf on the same samples to 1e-5 of
1 + |ref| (the twins' and Pallas's summation orders); the loss to 1e-5
relative, the terms to rtol 5e-4 (the normal regulariser sums squares of
n.v near 0: 1.2e-5 apart on this batch at every family); every
parameter's gradient to 5e-4 in relative L2, and element by element to
5e-4 of the tensor's largest magnitude (rtol 2e-3): the trunk's and sigma
head's gradients pass through the normals' second order, where the
siren's first layer (w0 = 30) spreads the summation orders' ulps over the
elements (up to 2.2e-4 in relative L2, unfused alike; the heads' within
2e-4), and Microfacet's 1 / cos^4 amplifies them most (one element of the
first layer's bias 2.6e-4 of its tensor's largest magnitude apart);
perturb=0, so no sample moves; the steps as
tests/test_torch_port_train.py's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.models import network as jnet
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.render import inference as jinf

from brdfnerf_tpu_torch.models import network as tnet
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.render import inference as tinf

from test_torch_port_train import GATES, train_configs
from torch_port_common import (SMALL, a, close, grads_close, jax_batch,
                               make_rays, make_store, model_configs,
                               networks, render_configs, render_draws, t,
                               three_fused_steps_match, torch_batch)

N_RAYS = 16
HEADS = dict(normal="analystic", sun_v="analystic")
FAMILIES = {
    # (model fields, apply_brdf, apply_theta)
    "hapke b c theta": (dict(hapke_b=True, hapke_c=True, hapke_theta=True,
                             hpk_scl=1.0), True, True),
    "hapke b c": (dict(hapke_b=True, hapke_c=True, hapke_theta=True),
                  True, False),
    "hapke shell 3, stage 1": (dict(hapke_b=True, hapke_c=True,
                                    hapke_theta=True, shell_hapke=3),
                               False, False),
    "microfacet": (dict(roughness=True), True, False),
}


def setup(name, fused=True, **rkw):
    fields, brdf, theta = FAMILIES[name]
    jm, tm = model_configs(**SMALL, **HEADS, **fields,
                           compute_dtype="float32")
    jr, tr = render_configs(**dict(dict(
        n_samples=8, guided_samples=8, apply_brdf=brdf, apply_theta=theta,
        use_pallas=fused, fused_trunk=fused), **rkw))
    params, net = networks(jm, tm)
    return jm, tm, jr, tr, params, net


def held(got, ref, what, tol=1e-5):
    g, r = a(got), a(ref)
    assert g.shape == r.shape, what
    assert np.all(np.abs(g - r) <= tol * (1.0 + np.abs(r))), (
        what, float(np.max(np.abs(g - r))))


@pytest.mark.parametrize("name,fused", [(n, True) for n in FAMILIES]
                         + [("hapke b c theta", False)])
def test_heads_match_jax(name, fused):
    """apply_network_with_normals: sigma, the normals and every head (the
    Hapke heads through the merged matmul pair, theta's [0, 30 deg] scale
    and tile3; the roughness head), through the fused trunk's twin or
    autograd."""
    jm, tm, jr, tr, params, net = setup(name)
    xyz = np.random.RandomState(1).uniform(-1, 1, (96, 3)).astype(
        np.float32)
    sun = np.tile(np.asarray([[0.3, 0.2, 0.93]], np.float32), (96, 1))
    kw = dict(apply_brdf=jr.apply_brdf or name.endswith("stage 1"),
              apply_theta=jr.apply_theta, fused_trunk=fused)
    ref = jnet.apply_network_with_normals(params, jm, jnp.asarray(xyz),
                                          sun_d=jnp.asarray(sun), **kw)
    with torch.no_grad():
        got = tnet.apply_network_with_normals(net, tm, t(xyz), sun_d=t(sun),
                                              **kw)
    assert set(got) == set(ref)
    want = {"hpk_b", "hpk_c"} if name.startswith("hapke") else {"roughness"}
    if jr.apply_theta:
        want.add("hpk_theta")
    assert want <= set(got), sorted(got)
    for k in ref:
        held(got[k], ref[k], k)
    if "hpk_theta" in got:
        assert float(got["hpk_theta"].max()) <= np.pi / 6


@pytest.mark.parametrize("name", list(FAMILIES))
def test_inference_spsbrdf_matches_jax(name):
    """inference_spsbrdf on the same samples: the family's per-ray BRDF
    keys (Hapke's hpk_P/Hi/Hv/ci/cv/ShadFunc, hpk_Hv holding Hi as the
    reference stores it; Microfacet's glossy/f/g/d/..), and the rgb the
    BRDF shades, a Hapke shell in stage 1 included."""
    jm, tm, jr, tr, params, net = setup(name)
    rays = make_rays(N_RAYS, seed=4)
    z = np.sort(np.random.RandomState(6).uniform(0.05, 2.0, (N_RAYS, 12)),
                -1).astype(np.float32)
    o, d, sun = rays[:, 0:3], rays[:, 3:6], rays[:, 8:11]
    ref = jinf.inference_spsbrdf(params, jm, jr, *map(jnp.asarray,
                                                      (o, d, z, sun)),
                                 cos_irra_on=jnp.asarray(False))
    with torch.no_grad():
        got = tinf.inference_spsbrdf(net, tm, tr, *map(t, (o, d, z, sun)),
                                     cos_irra_on=torch.tensor(False))
    assert set(got) == set(ref)
    assert "brdf" in got
    if name.startswith("hapke"):
        assert torch.equal(got["hpk_Hv"], got["hpk_Hi"])
    for k in ref:
        held(got[k], ref[k], k)


@pytest.mark.parametrize("name,fused", [
    ("hapke b c theta", True), ("hapke b c theta", False),
    ("microfacet", True), ("microfacet", False),
    ("hapke shell 3, stage 1", True)])
def test_compute_losses_match_jax(name, fused):
    """Stage 2 of each family, fused and unfused, and a Hapke shell in
    stage 1: the loss, every term and every parameter's gradient against
    jax.value_and_grad of the JAX package's compute_losses; the BRDFs'
    cotangents reach the trunk through the features and the normals (K3's
    twin when fused)."""
    jm, tm, jr, tr, params, net = setup(name, fused=fused, perturb=0.0)
    jt, tt = train_configs()
    s = make_store(N_RAYS, seed=5)
    key = jax.random.PRNGKey(9)
    jg = jts.TrainGates(**{k: jnp.asarray(v) for k, v in GATES.items()})
    (l_ref, (terms_ref, aux_ref)), g_ref = jax.value_and_grad(
        lambda p: jts.compute_losses(p, jm, jr, jt, jax_batch(s), key, jg),
        has_aux=True)({"coarse": params})
    loss, (terms, aux) = tts.compute_losses(
        net, tm, tr, tt, torch_batch(s), tts.TrainGates(**GATES),
        draws=render_draws(key, jr, N_RAYS, jr.sun_march_count(16)))
    loss.backward()
    close(loss, l_ref, atol=0.0, rtol=1e-5, what="loss")
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        close(terms[k], terms_ref[k], atol=1e-7, rtol=5e-4, what=k)
    for k in aux_ref:
        close(aux[k], aux_ref[k], atol=1e-6, rtol=1e-5, what=k)
    grads_close(net, g_ref, name, atol_frac=5e-4, rtol=2e-3, rel_l2=5e-4)


def test_three_fused_steps_match_jax():
    """make_fused_train_step on the Hapke heads with theta, three steps
    from the JAX state each (three_fused_steps_match)."""
    jm, tm, jr, tr, _, _ = setup("hapke b c theta", perturb=0.0)
    jt, tt = train_configs(batch_size=N_RAYS)
    three_fused_steps_match(jm, tm, jr, tr, jt, tt, N_RAYS,
                            ("loss", "psnr", "perc_bad_nr", "depth_std_mean"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hapke b c theta", "microfacet"])
def test_family_launches_on_the_card(name, monkeypatch):
    """At the flagship width, a family's stage-2 step launches K1 2 / K2 1
    / K3 1 and a render chunk K1 2 / K2 1; with BRDFNERF_FUSED_HEADS set
    K4 and K5 launch 0 (they take the RPV(111) heads alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch import config as tconfig
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.render import render as trender
    fields, brdf, theta = FAMILIES[name]
    tm = tconfig.ModelConfig(variant="spsbrdf-nerf", siren=True,
                             mapping=True, compute_dtype="bfloat16_all",
                             **HEADS, **fields)
    tr = tconfig.RenderConfig(n_samples=64, guided_samples=64,
                              apply_brdf=brdf, apply_theta=theta,
                              use_pallas=True, fused_trunk=True)
    _, tt = train_configs(batch_size=256)
    kernels = (k1.TRUNK_SIGMA, k2.TRUNK_FWD_GRAD, k2.TRUNK_BWD,
               k4.TRUNK_HEADS_FWD, k4.TRUNK_HEADS_BWD)
    store = {k: v.cuda() for k, v in torch_batch(make_store(256)).items()}
    for heads in (False, True):
        if heads:
            monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
        state, opt = tts.create_train_state(tm, tt, 1, device="cuda")
        step = tts.make_fused_train_step(
            tm, tr, tt, opt, tts.GateSchedule(1e18, 1e18, -1.0, 1, 0))
        for k in kernels:
            k.launches = 0
        state, m = step(state, store, torch.arange(256, device="cuda"), 0)
        assert np.isfinite(float(m["loss"]))
        assert [k.launches for k in kernels] == [2, 1, 1, 0, 0]
        for k in kernels:
            k.launches = 0
        with torch.no_grad():
            res = trender.render_rays(
                state.params, tm, tr, trender.RenderInputs(
                    rays=store["rays"], cos_irra_on=torch.tensor(
                        False, device="cuda")),
                generator=torch.Generator(device="cuda").manual_seed(0))
        assert torch.isfinite(res["rgb_coarse"]).all()
        assert [k.launches for k in kernels] == [2, 1, 0, 0, 0]
