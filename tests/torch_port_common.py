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
    return params, params_from_flat(flat, tcfg, device="cpu")


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
