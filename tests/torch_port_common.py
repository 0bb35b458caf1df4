"""Shared set-up of the port's parity tests: the same configuration built
for both packages, and the JAX package's initial weights carried into the
port through the npz layout."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu import config as jcfg_mod
from brdfnerf_tpu.models.network import init_network as jax_init_network
from brdfnerf_tpu.utils.checkpoint import _flatten as jax_flatten

from brdfnerf_tpu_torch import config as tcfg_mod
from brdfnerf_tpu_torch.utils.checkpoint import params_from_flat

# one intra-op thread a test process: the suite runs several processes on
# the machine's cores (pytest-xdist), and each one's torch pool sized to
# every core oversubscribes them, which slowed a 9 s test to 392 s
torch.set_num_threads(1)

# a small trunk with the reference architecture's shape: one skip, inside
SMALL = dict(variant="spsbrdf-nerf", siren=True, mapping=True, layers=4,
             feat=64, skips=(2,))
# the flagship heads: RPV(111), analytic normals and sun visibility
FLAGSHIP_HEADS = dict(normal="analystic", sun_v="analystic", func_m=True,
                      func_f=True, func_h=1, dim_rpv=1)


def model_configs(**kw):
    """(JAX ModelConfig, port ModelConfig) from the same fields."""
    return jcfg_mod.ModelConfig(**kw), tcfg_mod.ModelConfig(**kw)


def render_configs(**kw):
    return jcfg_mod.RenderConfig(**kw), tcfg_mod.RenderConfig(**kw)


def networks(jcfg, tcfg, seed: int = 0):
    """JAX params from the JAX package's init, and the port's Network
    holding the same values (through the flat npz layout)."""
    params = jax_init_network(jax.random.PRNGKey(seed), jcfg)
    flat = jax_flatten({"coarse": params})
    return params, params_from_flat(flat, tcfg, device="cpu").coarse


def t(x):
    """numpy / JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def a(x):
    """torch tensor / JAX array -> float64 numpy (bf16 upcast first)."""
    if torch.is_tensor(x):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def make_rays(n: int, seed: int = 0, far: float = 2.0):
    """Satellite-style rays [o(3) d(3) near far sun(3)] (as
    __graft_entry__._make_batch)."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = np.tile(np.asarray([[0.05, 0.02, -1.0]], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = np.tile(np.asarray([[0.3, 0.2, 0.93]], np.float32), (n, 1))
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.zeros((n, 1), np.float32),
                           np.full((n, 1), far, np.float32), sun], 1)


def make_store(n: int, seed: int = 0):
    """A ray store in __graft_entry__._make_batch's layout, with the GT
    depth's std nonzero on part of the rays and valid_depth mixed."""
    rng = np.random.RandomState(seed)
    rays = make_rays(n, seed=seed + 1)
    return {
        "rays": rays,
        "rgbs": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "ts": np.zeros((n,), np.int32),
        "depths": np.stack([rng.uniform(0.5, 1.5, n), np.ones(n)],
                           1).astype(np.float32),
        "valid_depth": (rng.uniform(0, 1, n) > 0.5).astype(np.int32),
        "depth_std": np.where(rng.uniform(0, 1, n) > 0.3,
                              rng.uniform(0.02, 0.1, n), 0.0).astype(
                                  np.float32),
        "normals": np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32),
                           (n, 1)),
        "valid_normal": np.ones((n,), np.float32),
    }


def jax_batch(s):
    """A store or batch of numpy arrays as JAX arrays."""
    return {k: jnp.asarray(v) for k, v in s.items()}


def torch_batch(s):
    """The same as CPU torch tensors."""
    return {k: t(v) for k, v in s.items()}


def render_draws(key, rcfg, n_rays: int, n_sun: int):
    """The uniform draws the JAX package's render_rays takes from `key`
    (render.py:256 / :71, sampling.py:191-198), under the port's names:
    the guided band's draws for the predicted depth and, at train time, for
    the GT depth."""
    k_coarse = jax.random.split(key, 3)[0]
    keys = jax.random.split(k_coarse, 8)
    k1, k2 = jax.random.split(keys[3])
    guided = (n_rays, rcfg.effective_guided)
    return {
        "z": t(jax.random.uniform(keys[0], (n_rays, rcfg.n_samples))),
        "guided": t(jax.random.uniform(k1, guided)),
        "guided_gt": t(jax.random.uniform(k2, guided)),
        "sun": t(jax.random.uniform(keys[5], (n_rays, n_sun))),
    }


def close(got, ref, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(a(got), a(ref), atol=atol, rtol=rtol,
                               err_msg=what)


def grads_close(net, g_ref, what, atol_frac, rtol, rel_l2=None):
    """Every parameter's gradient of the port's Network (after backward)
    against the JAX grads pytree ({'coarse': {...}}): element by element to
    atol_frac of the tensor's largest magnitude and rtol, and with rel_l2
    in relative L2 too."""
    flat = jax_flatten(g_ref)
    for name, p in net.named_parameters():
        key = "coarse/" + name.replace(".", "/")
        ref = flat[key]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if name.endswith(".w"):
            g = g.t()
        if rel_l2 is not None:
            rel = np.linalg.norm(a(g) - ref) / max(np.linalg.norm(ref),
                                                   1e-30)
            assert rel <= rel_l2, (what, key, rel)
        scale = max(float(np.max(np.abs(ref))), 1e-6)
        close(g, ref, atol=atol_frac * scale, rtol=rtol,
              what=f"{what} {key}")
    assert len(flat) == len(list(net.parameters()))


def three_fused_steps_match(jm, tm, jr, tr, jt, tt, n_rays,
                            metrics=("loss", "psnr", "depth_std_mean"),
                            store=None, draws_of=None):
    """make_fused_train_step against the JAX package's, three steps on one
    store (make_store(48) unless given) and index sequence, each from the
    JAX state (parameters and Adam moments; the fine network's and the t
    table's too where jr.n_importance > 0 and jm.beta) and on the draws of
    the JAX step's key (render_draws, or draws_of(key)), held as
    tests/test_torch_port_train.py holds the flagship's: the metrics to
    rtol 5e-4, the parameters to 5e-4 of scale and of themselves but for
    at most 0.1% of a tensor's elements, which may differ by up to 2 * lr
    (a gradient element near zero takes its sign from the summation order,
    and Adam turns either sign into a step of about lr)."""
    from brdfnerf_tpu.data import batcher as jbatch
    from brdfnerf_tpu.parallel import train_step as jts
    from brdfnerf_tpu_torch.data import batcher as tbatch
    from brdfnerf_tpu_torch.parallel import train_step as tts
    from brdfnerf_tpu_torch.utils.checkpoint import named_flat
    from test_torch_port_train import _carry_jax_state
    store = make_store(48, seed=11) if store is None else store
    if draws_of is None:
        def draws_of(key):
            return render_draws(key, jr, n_rays, jr.sun_march_count(16))
    sched = dict(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                 steps_per_epoch=1, first_beta_epoch=0)
    jstate, jopt = jts.create_train_state(jax.random.PRNGKey(0), jm, jt,
                                          steps_per_epoch=3,
                                          n_importance=jr.n_importance)
    jstep = jts.make_fused_train_step(jm, jr, jt, jopt,
                                      jts.GateSchedule(**sched))
    state, opt = tts.create_train_state(
        tm, tt, 3, flat=jax_flatten(jstate.params),
        n_importance=tr.n_importance, device="cpu")
    step = tts.make_fused_train_step(tm, tr, tt, opt,
                                     tts.GateSchedule(**sched))
    jb = jbatch.DeviceRayBatcher(store, n_rays, seed=3)
    tb = tbatch.DeviceRayBatcher(store, n_rays, seed=3, device="cpu")
    base_key = jax.random.PRNGKey(1)
    for i in range(3):
        idx = tb.next_index_tensor()
        jidx = jb.next_indices().astype(np.int32)
        draws = draws_of(jax.random.fold_in(base_key, i))
        _carry_jax_state(state, jstate)
        jstate, jm_ = jstep(jstate, jb.store, jnp.asarray(jidx), base_key)
        state, m = step(state, tb.store, idx, 0, draws=draws)
        for k in metrics:
            close(m[k], jm_[k], atol=1e-6, rtol=5e-4, what=f"step {i} {k}")
        flat = jax_flatten(jstate.params)
        for pname, p in named_flat(state.params).items():
            ref = flat[pname]
            got = a(p.t() if pname.endswith("/w") else p)
            d = np.abs(got - ref)
            scale = max(float(np.abs(ref).max()), 1e-3)
            flipped = d > 5e-4 * scale + 5e-4 * np.abs(ref)
            assert flipped.mean() <= 1e-3, (i, pname, flipped.sum())
            assert d.max() <= 2 * tt.lr, (i, pname, d.max())
