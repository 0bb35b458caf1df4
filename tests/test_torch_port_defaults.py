"""The variants at their own defaults, against the JAX package on the CPU:
the fine model (n_importance > 0), the beta head with the transient
t-embedding, normal_at_surface, multi_brdf (RPV, Microfacet, Hapke) and the
density noise.  Weights come across through the flat npz layout (the JAX
package's create_train_state, coarse + fine + t), the draws are the JAX
package's (jax_draws: its PRNG keys' uniforms and normals under the port's
names), and spsbrdf-nerf's fused kernels run as their twins here (the JAX
side runs its Pallas kernels in interpret mode).

Tolerances: renders where no density places a sample (nerf, sat-nerf, the
fine pass of nerf at perturb 0) to 1e-5 (of 1 + |ref|, per element); where
a guided band or the fine pass's inverse CDF places samples on the coarse
weights, an ulp of a weight moves a sample and the siren trunk amplifies
it on isolated rays, so those renders are held as
tests/test_torch_port_serve.py holds them (close_slice: mean 1e-3, p99
1e-2 of each ray's largest error); the losses and terms to rtol 5e-4,
the gradients to rtol 5e-4 (atol 5e-5 of the tensor's largest
magnitude); the three steps as tests/test_torch_port_train.py's."""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.models import network as jnet
from brdfnerf_tpu.ops import compositing as jcomp
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.render import render as jrender
from brdfnerf_tpu.utils import checkpoint as jckpt

from brdfnerf_tpu_torch.models import network as tnet
from brdfnerf_tpu_torch.ops import compositing as tcomp
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.render import render as trender
from brdfnerf_tpu_torch.utils import checkpoint as tckpt

from test_torch_port_serve import close_slice
from test_torch_port_train import GATES, train_configs
from torch_port_common import (a, close, make_store, model_configs,
                               render_configs, t, three_fused_steps_match)

N_RAYS = 48
TRUNK = dict(layers=4, feat=64, skips=(2,), mapping=True)
SPSBRDF = dict(variant="spsbrdf-nerf", siren=True, normal="analystic",
               sun_v="analystic", func_m=True, func_f=True, func_h=1)
SHADOW = dict(siren=True, sun_v="learned", indirect_light=True)
FUSED = dict(n_samples=8, guided_samples=8, apply_brdf=True,
             use_pallas=True, fused_trunk=True)
# name: (model fields, render fields, exact: no density places a sample)
CASES = {
    "nerf fine": (dict(variant="nerf", siren=False),
                  dict(n_samples=8, n_importance=8, perturb=0.0), True),
    "spsbrdf fine": (SPSBRDF, dict(FUSED, n_importance=8), False),
    "sat-nerf beta": (dict(SHADOW, variant="sat-nerf", beta=True),
                      dict(n_samples=8), True),
    "sps-nerf beta": (dict(SHADOW, variant="sps-nerf", beta=True),
                      dict(n_samples=8, guided_samples=8), False),
    "spsbrdf beta": (dict(SPSBRDF, beta=True), FUSED, False),
    "spsbrdf normal_at_surface": (SPSBRDF,
                                  dict(FUSED, normal_at_surface=True),
                                  False),
    "multi_brdf rpv": (dict(SPSBRDF, multi_brdf=True), FUSED, False),
    "multi_brdf microfacet": (dict(SPSBRDF, func_m=False, func_f=False,
                                   func_h=0, roughness=True,
                                   multi_brdf=True), FUSED, False),
    "multi_brdf hapke": (dict(SPSBRDF, func_m=False, func_f=False,
                              func_h=0, hapke_b=True, hapke_c=True,
                              hapke_theta=True, multi_brdf=True),
                         dict(FUSED, apply_theta=True), False),
    "nerf noise": (dict(variant="nerf", siren=False),
                   dict(n_samples=8, noise_std=1.0), True),
    "spsbrdf noise": (SPSBRDF, dict(FUSED, noise_std=1.0), False),
}
# hpk_scl = 1 / (nr_vw + nr_sun) is unbounded where the summed normal is
# perpendicular to the bisector of view and sun; it is held through its
# reciprocal
SINGULAR = {"hpk_scl_coarse", "hpk_scl_fine"}


def jax_draws(key, jm, jr, n, kp_n=None):
    """The draws the JAX package's render_rays takes from `key` for n rays
    (render.py:221-288, sampling.py, compositing.py:28-30), under the
    port's names (render/render.py): the stratified jitter, the guided
    bands, the sun march, the fine pass's inverse-CDF uniforms and every
    pass's N(0, 1) density noise.  kp_n: also the keypoint render's
    (draws['kp']), which takes the same key (train_step.py:158)."""
    k_coarse, k_fine, k_pdf = jax.random.split(key, 3)
    keys = jax.random.split(k_coarse, 8)
    k1, k2 = jax.random.split(keys[3])
    v, eg = jm.variant, jr.effective_guided
    guided = jr.guided_samples > 0 and v in ("sps-nerf", "spsbrdf-nerf")
    n_main = jr.n_samples
    if guided:
        n_main = (jr.total_samples if v == "spsbrdf-nerf"
                  else jr.n_samples + eg)
    n_sun = jr.sun_march_count(n_main)

    def u(k, w):
        return t(jax.random.uniform(k, (n, w)))

    def g(k, w):
        return t(jax.random.normal(k, (n, w)))

    d = {"z": u(keys[0], jr.n_samples), "guided": u(k1, eg),
         "guided_gt": u(k2, eg), "sun": u(keys[5], n_sun)}
    if jr.n_importance > 0:
        d["pdf"] = u(k_pdf, jr.n_importance)
        d["noise_fine"] = g(k_fine, n_main + jr.n_importance)
    if v == "spsbrdf-nerf":
        if guided:
            d.update(noise_probe=g(keys[1], jr.n_samples),
                     noise_sun=g(keys[6], n_sun), noise=g(keys[4], n_main))
        else:
            d["noise"] = g(keys[1], n_main)
        d["noise_sc"] = g(keys[7], n_main)
    elif v == "sps-nerf" and guided:
        d.update(noise_probe=g(keys[1], jr.n_samples),
                 noise=g(keys[4], n_main), noise_sc=g(keys[2], n_main))
    else:
        d.update(noise=g(keys[1], n_main), noise_sc=g(keys[2], n_main))
    if kp_n is not None:
        d["kp"] = jax_draws(key, jm, jr, kp_n)
    return d


def both_params(jm, tm, n_importance=0, seed=0, jt=None):
    """The JAX package's create_train_state params (coarse, [fine], [t])
    and the port's Params holding the same values."""
    jt = jt or train_configs()[0]
    jstate, _ = jts.create_train_state(jax.random.PRNGKey(seed), jm, jt, 1,
                                       n_importance=n_importance)
    return jstate.params, tckpt.params_from_flat(
        jckpt._flatten(jstate.params), tm, device="cpu")


def setup(name, **rkw):
    mkw, base, exact = CASES[name]
    jm, tm = model_configs(**TRUNK, **mkw, compute_dtype="float32")
    jr, tr = render_configs(**dict(base, **rkw))
    params, tp = both_params(jm, tm, jr.n_importance)
    return jm, tm, jr, tr, params, tp, exact


def store_with_ts(n, seed):
    s = make_store(n, seed=seed)
    s["ts"] = (np.arange(n) % 7).astype(np.int32)
    return s


def _inputs(mod, s, conv):
    return mod.RenderInputs(
        rays=conv(s["rays"]), ts=conv(s["ts"]),
        valid_depth=conv(s["valid_depth"]),
        target_depths=conv(s["depths"]), target_std=conv(s["depth_std"]),
        cos_irra_on=conv(np.asarray(False)))


def jax_render(params, jm, jr, s, key, train, jit=False):
    """The JAX package's render_rays on store `s`; jit: jitted as its
    render step is (eager, its fine pass takes ~10 s on the CPU)."""
    def fn(p, inp, k):
        return jrender.render_rays(p, jm, jr, inp, k, train=train)
    return (jax.jit(fn) if jit else fn)(
        params, _inputs(jrender, s, jnp.asarray), key)


def jax_loss_grads(params, jm, jr, jt, batch, key, gates):
    """jax.value_and_grad of the JAX package's compute_losses, jitted, as a
    function of (params, batch)."""
    jg = jts.TrainGates(**{k: jnp.asarray(v) for k, v in gates.items()})
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jts.compute_losses(p, jm, jr, jt, b, key, jg),
        has_aux=True))
    return lambda p, b: fn(p, {k: jnp.asarray(v) for k, v in b.items()})


# the fine pass's samples lie on the coarse weights' inverse CDF, which an
# ulp of a weight moves where the CDF steps, and the fine pass's normals
# (the siren trunk's density gradient) amplify a moved sample: measured on
# spsbrdf's fine keys, mean 1.7e-3 and p99 1.4e-2 of each ray's largest
# error (normal_an_fine, rpv_G_fine; the JAX package's own jitted and
# eager renders differ by half of that), so they are held at 5e-3 / 5e-2
FINE_SLICE = dict(mean=5e-3, p99=5e-2)


def hold(got, ref, n, exact):
    """Every key of the JAX package's render, of its shape: to 1e-5 where
    `exact`, else by close_slice (the _fine keys at FINE_SLICE)."""
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k in ref:
        g, r = a(got[k]), a(ref[k])
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if k in SINGULAR:
            g, r = 1.0 / g, 1.0 / r
        if exact:
            assert np.all(np.abs(g - r) <= 1e-5 * (1.0 + np.abs(r))), (
                k, float(np.max(np.abs(g - r))))
        else:
            close_slice(g, r, n, k,
                        **(FINE_SLICE if k.endswith("_fine") else {}))


# ----------------------------------------------------------- the pieces

def test_beta_head_and_t_embedding():
    """init_t_embedding draws (vocab, tau) N(0, 1) from the generator; the
    beta head on concat(features, t) through apply_network against the JAX
    package's at 1e-5 (after the fused trunk's features: the spsbrdf
    renders below)."""
    emb = tnet.init_t_embedding(30, 4, torch.Generator().manual_seed(0),
                                device="cpu")
    assert emb.shape == (30, 4) and abs(float(emb.std()) - 1.0) < 0.3
    again = tnet.init_t_embedding(30, 4, torch.Generator().manual_seed(0),
                                  device="cpu")
    assert torch.equal(emb, again)
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    sun = np.tile([[0.3, 0.2, 0.93]], (64, 1)).astype(np.float32)
    temb = rng.normal(size=(64, 4)).astype(np.float32)
    jm, tm, _, _, params, tp, _ = setup("sat-nerf beta")
    ref = jnet.apply_network(params["coarse"], jm, jnp.asarray(xyz),
                             sun_d=jnp.asarray(sun), t_emb=jnp.asarray(temb))
    with torch.no_grad():
        got = tnet.apply_network(tp.coarse, tm, t(xyz), sun_d=t(sun),
                                 t_emb=t(temb))
        none = tnet.apply_network(tp.coarse, tm, t(xyz), sun_d=t(sun))
    assert "beta" in got and "beta" not in none and set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], atol=1e-5, rtol=1e-5, what=k)


def test_create_train_state_with_fine_and_t():
    """create_train_state's Params (coarse, fine, t) has the JAX package's
    flat keys and shapes; drawn in the order coarse, fine, t (its coarse
    network is the one a fine-less, beta-less state draws, a Params of the
    coarse network alone, as a bare Network stands for); the JAX state
    through `flat` holds its values exactly, and they go back bit-equal,
    through the npz both ways."""
    jm, tm = model_configs(**TRUNK, **SHADOW, variant="sat-nerf", beta=True)
    jt, tt = train_configs()
    jstate, _ = jts.create_train_state(jax.random.PRNGKey(0), jm, jt, 1,
                                       n_importance=8)
    jflat = jckpt._flatten(jstate.params)
    state, opt = tts.create_train_state(tm, tt, 1, seed=3, n_importance=8,
                                        device="cpu")
    assert isinstance(state.params, tnet.Params)
    got = tckpt.params_to_flat(state.params)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in jflat.items()}
    assert got["t"].shape == (30, 4)
    bare, _ = tts.create_train_state(dc.replace(tm, beta=False), tt, 1,
                                     seed=3, device="cpu")
    assert isinstance(bare.params, tnet.Params)
    assert bare.params.fine is None and bare.params.t is None
    # a bare Network stands for the coarse network alone
    alone = tckpt.params_to_flat(bare.params.coarse)
    assert alone.keys() == tckpt.params_to_flat(bare.params).keys()
    for k, v in alone.items():
        if "beta_from_xyz" not in k:
            assert np.array_equal(got[k], v), k
    assert len(opt.init(state.params).param_groups[0]["params"]) == len(got)

    carried, _ = tts.create_train_state(tm, tt, 1, flat=jflat,
                                        n_importance=8, device="cpu")
    back = tckpt.params_to_flat(carried.params)
    assert set(back) == set(jflat)
    for k in jflat:
        assert np.array_equal(back[k], jflat[k]), k
    with pytest.raises(ValueError, match="missing"):
        tts.create_train_state(tm, tt, 1, flat={
            k: v for k, v in jflat.items() if k != "t"}, n_importance=8,
            device="cpu")


def test_checkpoints_with_fine_and_t_both_ways(tmp_path):
    """A JAX checkpoint of coarse + fine + t restores into the port's
    Params, and the port's checkpoint into the JAX package's template, bit
    for bit; the optimizer state too, in the JAX package's leaf order."""
    jm, tm = model_configs(**TRUNK, **SHADOW, variant="sat-nerf", beta=True)
    jt, tt = train_configs()
    jstate, _ = jts.create_train_state(jax.random.PRNGKey(1), jm, jt, 1,
                                       n_importance=8)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j.npz"), jstate.params)
    state, opt = tts.create_train_state(tm, tt, 1, n_importance=8,
                                        device="cpu")
    tckpt.restore_params(state.params, jpath)
    flat = tckpt.params_to_flat(state.params)
    for k, v in jckpt.load_flat(jpath).items():
        if not k.startswith("__"):
            assert np.array_equal(flat[k], v), k
    tpath = tckpt.save_checkpoint(str(tmp_path / "t.npz"),
                                  state.params)
    back = jckpt.restore_params(jstate.params, tpath)
    for k, v in jckpt._flatten(back).items():
        assert np.array_equal(v, flat[k]), k
    # Adam's moments of coarse, fine and t in the JAX leaf order
    jopt_path = jckpt.save_opt_state(str(tmp_path / "j.opt.npz"),
                                     jstate.opt_state)
    assert tckpt.restore_opt_state(state.params, state.opt_state,
                                   jopt_path) == 0
    tckpt.save_opt_state(str(tmp_path / "t.opt.npz"), state.params,
                         state.opt_state, count=0)
    jckpt.restore_opt_state(jstate.opt_state, str(tmp_path / "t.opt.npz"))


def test_composite_with_fed_noise():
    """composite with sigma + noise_std * the fed N(0, 1) draws against the
    JAX package's composite on its key's normals."""
    rng = np.random.RandomState(0)
    z = np.sort(rng.uniform(0, 2, (16, 12)), -1).astype(np.float32)
    sig = rng.uniform(0, 3, (16, 12)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jcomp.composite(jnp.asarray(z), jnp.asarray(sig), 0.7, key)
    noise = t(jax.random.normal(key, (16, 12)))
    got = tcomp.composite(t(z), t(sig), 0.7, noise)
    for g, r in zip(got, ref):
        close(g, r, atol=1e-6, rtol=1e-6)
    plain = tcomp.composite(t(z), t(sig))
    assert not torch.equal(plain[2], got[2])
    assert all(torch.equal(p, q) for p, q in zip(
        plain, tcomp.composite(t(z), t(sig), 0.0, noise)))


def test_composite_cumprod_gradient_is_torch_s():
    """composite's transparency (a cumulative product of factors of at
    least 1e-10) takes the gradient torch.cumprod's backward gives, bit
    for bit, without its check for zeros (which waits on the device)."""
    rng = np.random.RandomState(1)
    z = t(np.sort(rng.uniform(0, 2, (16, 12)), -1).astype(np.float32))
    sig0 = rng.uniform(0, 30, (16, 12)).astype(np.float32)
    cot = t(rng.normal(size=(16, 12)).astype(np.float32))
    grads = []
    for cumprod in (tcomp._CumprodNonzero.apply,
                    lambda x: torch.cumprod(x, -1)):
        sig = t(sig0).requires_grad_(True)
        deltas = torch.cat([z[:, 1:] - z[:, :-1],
                            torch.full_like(z[:, :1], 1e10)], -1)
        alphas = 1.0 - torch.exp(-deltas * torch.relu(sig))
        shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                             1.0 - alphas + 1e-10], -1)
        (cumprod(shifted)[:, :-1] * cot).sum().backward()
        grads.append(sig.grad)
    assert torch.equal(grads[0], grads[1])
    assert torch.all(tcomp.composite(z, t(sig0))[1] > 0)


# ----------------------------------------------------------- the renders

RENDERED = [n for n in CASES if "fine" not in n]


@pytest.mark.parametrize("name", RENDERED)
def test_render_rays_matches_jax(name):
    """render_rays at train time, key by key, on the JAX package's draws:
    beta where the t table is, the per-sample BRDF keys of multi_brdf, the
    noise of every pass (the fine model: test_torch_port_defaults_fine.py)."""
    jm, tm, jr, tr, params, tp, exact = setup(name)
    s = store_with_ts(N_RAYS, seed=2)
    key = jax.random.PRNGKey(3)
    ref = jax_render(params, jm, jr, s, key, True)
    got = trender.render_rays(tp, tm, tr, _inputs(trender, s, t),
                              train=True,
                              draws=jax_draws(key, jm, jr, N_RAYS))
    hold(got, ref, N_RAYS, exact)
    assert ("beta_coarse" in got) == jm.beta
    if jm.multi_brdf:
        assert got["brdf_coarse"].shape == (N_RAYS, jr.total_samples, 3)


# ------------------------------------------------------------ the losses

def hold_losses(loss, terms, aux, l_ref, terms_ref, aux_ref):
    close(loss, l_ref, atol=0.0, rtol=5e-4, what="loss")
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        close(terms[k], terms_ref[k], atol=1e-7, rtol=5e-4, what=k)
    for k in aux_ref:
        close(aux[k], aux_ref[k], atol=1e-6, rtol=5e-4, what=k)


def _rel(x, y):
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))


def hold_grads(tp, g_ref, what, g_ulp=None):
    """Every parameter's gradient (coarse, fine, t) against the JAX grads
    tree: to rtol 5e-4 and 5e-5 of the tensor's largest magnitude; or,
    given g_ulp (the JAX package's grads with the rays' origins moved by
    one ulp), a leaf that this ulp moves by more than 5e-4 in relative L2
    within that move of its own, in relative L2 (each other leaf as
    without g_ulp)."""
    flat = jckpt._flatten(g_ref)
    named = tckpt.named_flat(tp)
    assert set(named) == set(flat)
    ulp = {} if g_ulp is None else jckpt._flatten(g_ulp)
    for k, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = a(g.t() if k.endswith("/w") else g)
        bound = _rel(ulp[k], flat[k]) if k in ulp else 0.0
        if bound > 5e-4:
            assert _rel(g, flat[k]) <= bound, (what, k, _rel(g, flat[k]),
                                               bound)
        else:
            scale = max(float(np.max(np.abs(flat[k]))), 1e-6)
            close(g, flat[k], atol=5e-5 * scale, rtol=5e-4,
                  what=f"{what} {k}")


def one_ulp(s):
    """The store with its rays' origins moved by one ulp."""
    s = dict(s, rays=s["rays"].copy())
    s["rays"][:, 0:3] = np.nextafter(s["rays"][:, 0:3], np.float32(9))
    return s


def losses_match(name, gates, ill_conditioned=False, **rkw):
    """compute_losses against the JAX package's on 16 rays at perturb=0:
    hold_losses, and hold_grads (ill_conditioned: in relative L2 within
    what one ulp of the rays moves the JAX package's own gradients)."""
    jm, tm, jr, tr, params, tp, _ = setup(name, perturb=0.0, **rkw)
    jt, tt = train_configs(sc_lambda=0.05, nr_reg_an_lambda=0.0,
                           hs_lambda=0.0)
    s = store_with_ts(16, seed=5)
    key = jax.random.PRNGKey(9)
    fn = jax_loss_grads(params, jm, jr, jt, s, key, gates)
    (l_ref, (terms_ref, aux_ref)), g_ref = fn(params, s)
    g_ulp = fn(params, one_ulp(s))[1] if ill_conditioned else None
    loss, (terms, aux) = tts.compute_losses(
        tp, tm, tr, tt, {k: t(v) for k, v in s.items()},
        tts.TrainGates(**gates), draws=jax_draws(key, jm, jr, 16))
    loss.backward()
    hold_losses(loss, terms, aux, l_ref, terms_ref, aux_ref)
    hold_grads(tp, g_ref, name, g_ulp)


@pytest.mark.parametrize("name,warmup", [("sps-nerf beta", False),
                                         ("sps-nerf beta", True),
                                         ("spsbrdf beta", False)])
def test_compute_losses_match_jax(name, warmup):
    """compute_losses with the t table: the loss, every term and every
    parameter's gradient, t's included, against jax.value_and_grad of the
    JAX package's; the beta warmup takes the s-nerf loss in place of the
    beta loss.  spsbrdf's gradient is ill-conditioned at an ulp (RPV's, on
    rays where the summed normal grazes the sun or the view; one ulp of the
    rays' origins moves the JAX package's own by up to 1.8e-2 in relative
    L2 at these weights, the port's lies at most 0.12 of each leaf's move
    from it), so it is held by hold_grads' ulp rule, leaf by leaf."""
    losses_match(name, dict(GATES, beta_warmup=warmup),
                 ill_conditioned=name.startswith("spsbrdf"))


def test_three_fused_steps_match_jax():
    """make_fused_train_step with the t table (sps-nerf, beta), three steps
    against the JAX package's, each from the JAX state, t's moments
    included (three_steps_match)."""
    three_steps_match("sps-nerf beta")


def three_steps_match(name):
    """torch_port_common.three_fused_steps_match on the case's configs, the
    store's rays with their image indices and the draws of jax_draws."""
    jm, tm, jr, tr, _, _, _ = setup(name, perturb=0.0)
    jt, tt = train_configs(batch_size=16, sc_lambda=0.05,
                           nr_reg_an_lambda=0.0, hs_lambda=0.0)
    three_fused_steps_match(jm, tm, jr, tr, jt, tt, 16,
                            store=store_with_ts(48, seed=11),
                            draws_of=lambda key: jax_draws(key, jm, jr, 16))


# ------------------------------------------------------------- the gates

@pytest.mark.parametrize("multi", [False, True])
def test_heads_gate_agrees_with_jax_on_multi_brdf(multi):
    """The port's heads_kernel_supports says what the JAX package's says
    (pallas_trunk_heads.py:73-102), which does not read multi_brdf: a
    multi_brdf RPV(111) model takes K4/K5 as the per-ray one does; a
    t-embedding, a fine-less or fine network alike, refuses them."""
    from brdfnerf_tpu.ops import pallas_trunk_heads as jheads
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as theads
    for beta in (False, True):
        jm, tm = model_configs(**TRUNK, **SPSBRDF,
                               multi_brdf=multi, beta=beta)
        params, tp = both_params(jm, tm, n_importance=8)
        temb = np.zeros((4, 4), np.float32) if beta else None
        for net_key in ("coarse", "fine"):
            want = jheads.heads_kernel_supports(
                jm, params[net_key], t_emb=temb, apply_brdf=True)
            got = theads.heads_kernel_supports(
                tm, getattr(tp, net_key), t_emb=temb, apply_brdf=True)
            assert got == want == (not beta), (multi, beta, net_key)


@pytest.mark.parametrize("extra,heads,want,absent", [
    (["--n_importance", "64"], False,
     ["K1 (the sigma-only passes)", "K2 + K3 twice a step: on the coarse "
      "and on the fine network"], []),
    (["--n_importance", "64"], True,
     ["K2 + K3 twice a step", "K4 + K5 in their place"], []),
    (["--beta"], True, ["K2 + K3 (the differentiated", "K4/K5 refuse a "
                        "t-embedding (--beta), so the heads stay on K2 + "
                        "K3"], ["K4 + K5 in their place"]),
    (["--normal_at_surface"], True,
     ["K1 (the sigma-only passes)", "no K2/K3: --normal_at_surface"],
     ["K2 + K3 (", "K4 + K5 in"]),
    (["--model", "sat-nerf", "--beta"], True,
     ["none: the sat-nerf variant"], ["K1"]),
    (["--model", "sps-nerf", "--beta"], False,
     ["none: the sps-nerf variant"], ["K1"])])
def test_kernels_line_names_the_new_paths(monkeypatch, extra, heads, want,
                                          absent):
    """The `[kernels]` line of a run on the card: the fine network's second
    K2/K3 (K4/K5 with the switch), beta's K4/K5 refusal, normal_at_surface
    without K2/K3, sat-nerf / sps-nerf with beta on none."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    if heads:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
         "analystic", "--funcM", "1", "--funcF", "1", "--funcH", "1",
         "--brdf_on", "0.5", "--compute_dtype", "bfloat16_all"] + extra))
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    line = kernels_line(opts.to_run_config(args, device=cuda), cuda)
    for w in want:
        assert w in line, (w, line)
    for w in absent:
        assert w not in line, (w, line)
