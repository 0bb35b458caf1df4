"""The port's training slice against the JAX package: the train=True render,
compute_losses (loss, terms and every parameter's gradient), three steps of
make_fused_train_step, the optimizer's schedule, the gates and the batchers'
index sequences.  Plus the two repairs of slice 1 (the GT-depth band's
draws, and to_run_config's device) and the no-fallback rules of training.

Inputs come from numpy seeds, weights from the JAX package's init carried
through the npz layout, and the port takes the JAX package's uniform draws
(render_draws).  Everything is f32 on the CPU; the fused path runs the
kernels' plain twins against the Pallas kernels in interpret mode.

Tolerances:
  * the train=True render: close_slice of tests/test_torch_port_serve.py
    (mean 1e-3, p99 1e-2 of the per-ray max |d| / (1 + |ref|)), for the
    same reason: an ulp of a sample depth moves the siren trunk.
  * compute_losses: the loss and every term to 1e-5 relative; the gradients
    to tests/test_pallas.py's bounds, atol 2e-4 * scale and rtol 2e-3.
  * three train steps, each from the JAX state: the parameters to rtol
    5e-4, atol 5e-4 * scale, and the metrics to rtol 5e-4, the bounds of
    tests/test_tensor_parallel.py, except that at most 0.1% of a tensor's
    elements may instead differ by up to 2 * lr: a gradient element near
    zero takes its sign from the summation order, and Adam turns either
    sign into a step of about lr (measured: 1 to 2 elements of 4,096 in a
    trunk layer's weight per step).
"""

import dataclasses as dc

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu import config as jconfig
from brdfnerf_tpu.data import batcher as jbatch
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.render import render as jrender
from brdfnerf_tpu.utils.checkpoint import _flatten as jflatten

from brdfnerf_tpu_torch import config as tconfig
from brdfnerf_tpu_torch.data import batcher as tbatch
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.render import render as trender
from brdfnerf_tpu_torch.utils.checkpoint import params_to_flat

from test_torch_port_serve import close_slice
from torch_port_common import (SMALL, FLAGSHIP_HEADS, a, close, jax_batch,
                               make_store, model_configs, networks,
                               render_configs, render_draws, t, torch_batch)

N_RAYS = 24
GATES = dict(cos_irra_on=False, ds_on=True, nrrg_on=True, beta_warmup=False,
             hs_on=True)


def train_configs(**kw):
    """The flagship's loss weights (__graft_entry__._flagship_configs)."""
    kw = dict(dict(lr=5e-4, batch_size=N_RAYS, ds_lambda=10.0,
                   nr_reg_an_lambda=0.1, hs_lambda=0.5), **kw)
    return jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)


def setup(apply_brdf=True, fused=True, layers=4, skips=(2,), **rkw):
    jm, tm = model_configs(**dict(SMALL, layers=layers, skips=skips),
                           **FLAGSHIP_HEADS, compute_dtype="float32")
    kw = dict(dict(n_samples=8, guided_samples=8, apply_brdf=apply_brdf,
                   use_pallas=fused, fused_trunk=fused), **rkw)
    jr, tr = render_configs(**kw)
    params, net = networks(jm, tm)
    return jm, tm, jr, tr, params, net


def draws_for(key, jr, n=N_RAYS):
    return render_draws(key, jr, n, jr.sun_march_count(16))


# ------------------------------------------------------------- repairs

@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_train_render_takes_the_gt_band_draws(perturb):
    """render_rays(train=True) key by key against the JAX package on its
    draws, GT-depth band included (nonzero depth_std, mixed valid_depth):
    the band's draws reach the sampler through draws['guided_gt']."""
    jm, tm, jr, tr, params, net = setup(perturb=perturb)
    s = make_store(N_RAYS, seed=2)
    key = jax.random.PRNGKey(3)
    ref = jrender.render_rays(
        {"coarse": params}, jm, jr, jrender.RenderInputs(
            rays=jnp.asarray(s["rays"]),
            valid_depth=jnp.asarray(s["valid_depth"]),
            target_depths=jnp.asarray(s["depths"]),
            target_std=jnp.asarray(s["depth_std"]),
            cos_irra_on=jnp.asarray(False)), key, train=True)
    got = trender.render_rays(
        net, tm, tr, trender.RenderInputs(
            rays=t(s["rays"]), valid_depth=t(s["valid_depth"]),
            target_depths=t(s["depths"]), target_std=t(s["depth_std"]),
            cos_irra_on=torch.tensor(False)),
        train=True, draws=draws_for(key, jr))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        close_slice(got[k], ref[k], N_RAYS, k)


def test_to_run_config_resolves_its_device(monkeypatch):
    """to_run_config without a device runs on CUDA, and raises without it;
    it never hands back a config with the kernels quietly off."""
    from brdfnerf_tpu_torch.cli import opts
    argv = ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
            "analystic", "--compute_dtype", "bfloat16_all"]
    args = opts.postprocess(opts.train_parser().parse_args(argv))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        opts.to_run_config(args)
    r = opts.to_run_config(args, device="cpu").render
    assert (r.use_pallas, r.fused_trunk) == (False, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    r = opts.to_run_config(args).render
    assert (r.use_pallas, r.fused_trunk) == (True, True)


# ------------------------------------------------------- compute_losses

def _grads_close(got_net, g_ref, what):
    """Every parameter's gradient of the port's Network against the JAX
    grads pytree ({'coarse': {...}}); returns the count checked."""
    flat = jflatten(g_ref)
    n = 0
    for name, p in got_net.named_parameters():
        key = "coarse/" + name.replace(".", "/")
        ref = flat[key]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if name.endswith(".w"):
            g = g.t()
        scale = max(float(np.max(np.abs(ref))), 1e-3)
        close(g, ref, atol=2e-4 * scale, rtol=2e-3, what=f"{what} {key}")
        n += 1
    assert n == len(flat)
    return n


@pytest.mark.parametrize("apply_brdf,fused", [(True, True), (True, False),
                                              (False, True),
                                              (False, False)])
def test_compute_losses_match_jax(apply_brdf, fused):
    """Stage 2 (apply_brdf) and stage 1, through the fused trunk's twins
    (TrunkCore: K2's and K3's) and through autograd: the loss, every term
    and every parameter's gradient against jax.value_and_grad of the JAX
    package's compute_losses, on one batch, gates and draws."""
    jm, tm, jr, tr, params, net = setup(apply_brdf=apply_brdf, fused=fused)
    jt, tt = train_configs()
    s = make_store(N_RAYS, seed=5)
    key = jax.random.PRNGKey(9)
    jg = jts.TrainGates(**{k: jnp.asarray(v) for k, v in GATES.items()})
    (l_ref, (terms_ref, aux_ref)), g_ref = jax.value_and_grad(
        lambda p: jts.compute_losses(p, jm, jr, jt, jax_batch(s), key, jg),
        has_aux=True)({"coarse": params})
    loss, (terms, aux) = tts.compute_losses(
        net, tm, tr, tt, torch_batch(s), tts.TrainGates(**GATES),
        draws=draws_for(key, jr))
    loss.backward()
    close(loss, l_ref, atol=0.0, rtol=1e-5, what="loss")
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        close(terms[k], terms_ref[k], atol=1e-7, rtol=1e-5, what=k)
    assert set(aux) == set(aux_ref)
    for k in aux_ref:
        close(aux[k], aux_ref[k], atol=1e-6, rtol=1e-5, what=k)
    _grads_close(net, g_ref, "grad")


def test_gates_off_drop_their_terms():
    """A gate that is off removes its term from the loss, and the term is
    still reported, as jnp.where does in the JAX package."""
    jm, tm, jr, tr, params, net = setup()
    _, tt = train_configs()
    s = torch_batch(make_store(N_RAYS, seed=5))
    draws = draws_for(jax.random.PRNGKey(9), jr)
    off = dict(GATES, ds_on=False, nrrg_on=False, hs_on=False)
    with torch.no_grad():
        l_on, (terms, _) = tts.compute_losses(net, tm, tr, tt, s,
                                              tts.TrainGates(**GATES), draws)
        l_off, (terms_off, _) = tts.compute_losses(
            net, tm, tr, tt, s, tts.TrainGates(**off), draws)
    assert set(terms_off) == set(terms)
    close(l_off, terms["coarse_color"], atol=0.0, rtol=1e-6)
    extra = sum(terms[k] for k in terms if k != "coarse_color")
    close(l_on, l_off + extra, atol=0.0, rtol=1e-5)


# ------------------------------------------------------ the train step

def _carry_jax_state(state, jstate):
    """Set the port's parameters and Adam moments to the JAX state's, so
    that both steps start from the same point (the coarse network's, and
    the fine network's and the t table's of a Params)."""
    from brdfnerf_tpu_torch.utils.checkpoint import named_flat
    adam = jstate.opt_state[0]
    trees = {k: jflatten(v) for k, v in (("p", jstate.params),
                                         ("mu", adam.mu), ("nu", adam.nu))}
    count = int(adam.count)
    with torch.no_grad():
        for key, p in named_flat(state.params).items():
            def get(tree):
                v = t(trees[tree][key])
                return v.t().contiguous() if key.endswith("/w") else v
            p.copy_(get("p"))
            if count:
                state.opt_state.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": get("mu"), "exp_avg_sq": get("nu")}


def test_three_fused_steps_match_jax():
    """make_fused_train_step: three steps on one store and index sequence,
    each on the draws of the JAX step's fold_in(base_key, step) key, against
    the JAX package's fused step.  Each step starts from the JAX state
    (parameters and Adam moments): a gradient element whose size is within
    the tolerance of zero may take either sign, Adam turns either sign into
    a step of about lr, and a free-running pair of trajectories drifts apart
    by far more than the tolerance within two steps (measured: 7 such
    elements in step 0 move step 1's loss by 0.8%).  perturb=0: with the
    jitter on, an ulp moves a sample across a bin of the guided sampler on
    some ray, which moves a trunk layer's update by up to 5% (relative L2)
    between the JAX package's own jitted and eager runs."""
    jm, tm, jr, tr, _, _ = setup(perturb=0.0)
    jt, tt = train_configs()
    store = make_store(64, seed=11)
    spe = 2
    sched = dict(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                 steps_per_epoch=1, first_beta_epoch=0)
    jstate, jopt = jts.create_train_state(jax.random.PRNGKey(0), jm, jt,
                                          steps_per_epoch=spe)
    jstep = jts.make_fused_train_step(jm, jr, jt, jopt,
                                      jts.GateSchedule(**sched))
    state, opt = tts.create_train_state(
        tm, tt, spe, flat=jflatten({"coarse": jstate.params["coarse"]}),
        device="cpu")
    step = tts.make_fused_train_step(tm, tr, tt, opt,
                                     tts.GateSchedule(**sched))
    jb = jbatch.DeviceRayBatcher(store, N_RAYS, seed=3)
    tb = tbatch.DeviceRayBatcher(store, N_RAYS, seed=3, device="cpu")
    base_key = jax.random.PRNGKey(1)
    for i in range(3):
        idx = tb.next_index_tensor()
        jidx = jb.next_indices().astype(np.int32)
        assert np.array_equal(idx.numpy(), jidx)
        draws = draws_for(jax.random.fold_in(base_key, i), jr)
        _carry_jax_state(state, jstate)
        jstate, jm_ = jstep(jstate, jb.store, jnp.asarray(jidx), base_key)
        state, m = step(state, tb.store, idx, 0, draws=draws)
        assert state.step == i + 1 == int(jstate.step)
        for k in ("loss", "psnr", "perc_bad_nr", "depth_std_mean"):
            close(m[k], jm_[k], atol=1e-6, rtol=5e-4, what=f"step {i} {k}")
        flat = jflatten(jstate.params)
        for name, p in state.params.named_parameters():
            ref = flat[name.replace(".", "/")]
            got = a(p.t() if name.endswith(".w") else p)
            d = np.abs(got - ref)
            scale = max(float(np.abs(ref).max()), 1e-3)
            flipped = d > 5e-4 * scale + 5e-4 * np.abs(ref)
            assert flipped.mean() <= 1e-3, (i, name, flipped.sum())
            assert d.max() <= 2 * tt.lr, (i, name, d.max())


def test_fused_step_draws_follow_seed_and_step():
    """Without draws, a step's draws come from (seed, step): the same pair
    gives the same step, another seed another one."""
    _, tm, _, tr, _, net = setup()
    _, tt = train_configs()
    store = torch_batch(make_store(N_RAYS, seed=4))
    sched = tts.GateSchedule(1e18, 1e18, -1.0, 1, 0)
    idx = torch.arange(N_RAYS, dtype=torch.int32)
    flat = params_to_flat(net)

    def one(seed):
        state, opt = tts.create_train_state(tm, tt, 1, flat=flat,
                                            device="cpu")
        step = tts.make_fused_train_step(tm, tr, tt, opt, sched)
        return float(step(state, store, idx, seed)[1]["loss"])

    assert one(0) == one(0) != one(1)


# ------------------------------------------------ schedules, gates, data

@pytest.mark.parametrize("warm", [0, -1, -2, 5])
def test_lr_schedule_matches_optax(warm):
    jt, tt = train_configs(lr_warmup_steps=warm)
    spe = 4
    _, jsched = jts.make_optimizer(jt, spe)
    _, sched = tts.make_optimizer(tt, spe)
    got = [sched(k) for k in range(3 * spe + max(warm, 0) + 2 * spe)]
    ref = [float(jsched(k)) for k in range(len(got))]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0.0)


def test_adam_updates_match_optax():
    """Optimizer.step against optax.adam with the same schedule, on a
    parameter the loss reaches and one it does not (zero grad): three
    updates across an lr drop."""
    jt, tt = train_configs(lr_gamma=0.5)
    opt_j, _ = jts.make_optimizer(jt, 1)
    opt_t, _ = tts.make_optimizer(tt, 1)
    rng = np.random.RandomState(0)
    p0 = rng.normal(size=(2, 5)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(3)]
    jp = {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}
    js = opt_j.init(jp)
    mod = torch.nn.Module()
    mod.a = torch.nn.Parameter(t(p0[0]))
    mod.b = torch.nn.Parameter(t(p0[1]))
    ts_ = opt_t.init(mod)
    for k, g in enumerate(grads):
        gj = {"a": jnp.asarray(g), "b": jnp.zeros(5)}
        up, js = opt_j.update(gj, js, jp)
        jp = optax.apply_updates(jp, up)
        ts_.zero_grad(set_to_none=True)
        mod.a.grad = t(g)
        if k == 0:      # a zero grad on the first step, then none
            mod.b.grad = torch.zeros(5)
        opt_t.step(ts_, k)
        close(mod.a, jp["a"], atol=1e-7, rtol=1e-6, what=f"a {k}")
        close(mod.b, jp["b"], atol=1e-7, rtol=1e-6, what=f"b {k}")


def test_gates_from_step_match_jax():
    s = dict(t_cos_irra=7.5, t_ds_drop=12.0, t_nrrg=3.0, steps_per_epoch=4,
             first_beta_epoch=2)
    for step in range(20):
        ref = jts.gates_from_step(jnp.asarray(step, jnp.int32),
                                  jts.GateSchedule(**s))
        got = tts.gates_from_step(step, tts.GateSchedule(**s))
        assert tuple(got) == tuple(bool(v) for v in ref), step


def test_batchers_draw_the_jax_index_sequence():
    """For one seed, both packages' batchers draw the same indices, across
    epoch boundaries (37 rays, batch 8: a reshuffle every 4 steps), and the
    device batcher's gather is the host one's."""
    store = {"x": np.arange(37 * 2, dtype=np.float32).reshape(37, 2),
             "i": np.arange(37, dtype=np.int32)}
    ref = jbatch.RayBatcher(store, 8, seed=7)
    host = tbatch.RayBatcher(store, 8, seed=7)
    dev = tbatch.DeviceRayBatcher(store, 8, seed=7, device="cpu")
    assert host.steps_per_epoch == ref.steps_per_epoch == 4
    for _ in range(10):
        r = ref.next_indices()
        assert np.array_equal(host.next_indices(), r)
        b = dev.next_batch()
        assert np.array_equal(b["i"].numpy(), r)
        assert np.array_equal(b["x"].numpy(), store["x"][r])


# --------------------------------------------------------- no fallback

def test_training_entry_points_never_fall_back(monkeypatch):
    _, tm, _, tr, _, _ = setup()
    _, tt = train_configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tts.create_train_state(tm, tt, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.DeviceRayBatcher(make_store(8), 4)
    _, opt = tts.create_train_state(tm, tt, 1, device="cpu")
    sched = tts.GateSchedule(1e18, 1e18, -1.0, 1, 0)
    # a mesh is taken (data and tensor parallelism); a sharded store
    # needs one, and a tensor-parallel state layout must be its mesh's
    with pytest.raises(ValueError, match="requires a mesh"):
        tts.make_fused_train_step(tm, tr, tt, opt, sched, store_sharded=True)
    for make in (tts.make_fused_train_step, tts.make_scan_train_step):
        with pytest.raises(ValueError, match="layout of the step's mesh"):
            make(tm, tr, tt, opt, sched, mesh=object(),
                 state_shardings=object())
    # density noise draws from the step's generator, or from the draws it
    # is handed; never from torch's global generator
    noisy = dc.replace(tr, noise_std=1.0)
    state, _ = tts.create_train_state(tm, tt, 1, device="cpu")
    with pytest.raises(ValueError, match="noise"):
        tts.compute_losses(state.params, tm, noisy, tt,
                           torch_batch(make_store(8)),
                           tts.TrainGates(**GATES))
