"""The port's Hapke and Microfacet BRDFs against the JAX package's on the
same f32 inputs (CPU): random geometry and the edge geometries where the
clips meet their bounds (grazing incidence, a nadir normal, zero albedo,
the sun along the view).

Tolerances: every returned value at 1e-5 relative (plus 1e-7 of the
output's largest magnitude, for values that cancel to ~0); the gradients
of every output with respect to every input at rtol 5e-4 where both
packages' are finite, with the same entries non-finite in both.  The
transcendentals (tan, arccos, exp) differ in the last place between XLA's
and PyTorch's CPU code, which Hapke's exp(-2/pi cot(theta) cot(x)) and
Microfacet's 1 / cos^4 amplify near grazing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.brdf.hapke import hapke_brdf as jhapke
from brdfnerf_tpu.brdf.microfacet import microfacet_brdf as jmicro

from brdfnerf_tpu_torch.brdf.common import clip
from brdfnerf_tpu_torch.brdf.hapke import hapke_brdf as thapke
from brdfnerf_tpu_torch.brdf.microfacet import microfacet_brdf as tmicro

import torch_port_common  # noqa: F401  (one torch thread a process)

N_RANDOM = 48


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def geometry(seed=0):
    """(pts2l, pts2c, normal) rows: N_RANDOM random ones, then the edge
    rows (named in the returned list)."""
    rng = np.random.RandomState(seed)
    up = np.asarray([0.0, 0.0, 1.0])
    l = _unit(rng.normal(0, 0.4, (N_RANDOM, 3)) + up)
    v = _unit(rng.normal(0, 0.4, (N_RANDOM, 3)) + up)
    n = _unit(rng.normal(0, 0.25, (N_RANDOM, 3)) + up)
    edges = []
    # grazing incidence: l.n = 5e-4, exactly 0 and slightly negative, and
    # exactly at the H function's floor (1e-3) and calc_angles' (1e-5),
    # where a tie's half gradient reaches pts2l
    for cos_i in (5e-4, 0.0, -2e-4, 1e-3, 1e-5):
        s = np.sqrt(1.0 - cos_i ** 2)
        edges.append(("grazing %g" % cos_i, [s, 0.0, cos_i], [0.2, 0.1, 0.97],
                      [0.0, 0.0, 1.0]))
    # a nadir normal seen from nadir and from the side
    edges.append(("nadir normal, nadir view", [0.3, 0.2, 0.93], up, up))
    edges.append(("nadir normal", [0.3, 0.2, 0.93], [-0.1, 0.3, 0.95], up))
    # the sun along the view (hotspot), tilted and at nadir
    edges.append(("sun = view", [0.2, -0.1, 0.97], [0.2, -0.1, 0.97],
                  [0.05, 0.02, 1.0]))
    edges.append(("sun = view = normal", up, up, up))
    names = [e[0] for e in edges]
    el, ev, en = (_unit(np.asarray([e[k] for e in edges], np.float64))
                  for k in (1, 2, 3))
    return (np.concatenate([l, el]), np.concatenate([v, ev]),
            np.concatenate([n, en]), names)


def params(n_rows, seed=1):
    rng = np.random.RandomState(seed)
    f = np.float32
    w = rng.uniform(0.05, 0.95, (n_rows, 3)).astype(f)
    w[-3] = 0.0                       # zero albedo (a ray of zero weight)
    w[-2, 0] = 0.0
    b = rng.uniform(0.05, 0.95, (n_rows, 3)).astype(f)
    c = rng.uniform(0.05, 0.95, (n_rows, 3)).astype(f)
    theta = rng.uniform(0.02, 0.5, (n_rows,)).astype(f)
    rough = rng.uniform(0.1, 0.9, (n_rows, 1)).astype(f)
    return dict(w=w, b=b, c=c, theta=theta, rough=rough)


def compare(jfn, tfn, inputs, names, what, floor=5e-5, fallback=True):
    """Values of every output at 1e-5 relative, then the input gradients
    of each output against fixed random cotangents: at rtol 5e-4 (and
    `floor` of the pair's largest entry, for entries that cancel to ~0:
    the grazing rows' gradients are 1e5 times the others') where both
    packages' are finite, the non-finite entries the same in both.  An
    entry that misses is allowed only where f32 does not determine it:
    JAX's own f32 gradient misses its float64 value by more than the same
    bound, and the port's then lies no further from the float64 value than
    4 times the larger of JAX's distance and the bound (`fallback`; not at
    a tie, which float64 does not reproduce)."""
    j_in = [jnp.asarray(x) for x in inputs]
    t_in = [torch.from_numpy(x.copy()).requires_grad_(True) for x in inputs]
    j_out = jfn(*j_in)
    t_out = tfn(*t_in)
    assert len(j_out) == len(t_out)
    rng = np.random.RandomState(5)
    for k, (jo, to) in enumerate(zip(j_out, t_out)):
        jo = np.asarray(jo, np.float64)
        to_np = to.detach().numpy().astype(np.float64)
        assert to_np.shape == jo.shape, (what, k)
        scale = np.nanmax(np.abs(jo)) if np.isfinite(jo).any() else 1.0
        np.testing.assert_allclose(to_np, jo, rtol=1e-5, atol=1e-7 * scale,
                                   err_msg=f"{what}: output {k}")
        if not to.requires_grad:
            continue
        cot = rng.uniform(0.5, 1.5, jo.shape).astype(np.float32)
        # output k alone: zero cotangents on the others would meet their
        # infinite partials at grazing (0 * inf) in JAX's backward
        _, vjp = jax.vjp(lambda *x, k=k: jfn(*x)[k], *j_in)
        j_g = vjp(jnp.asarray(cot))
        with jax.enable_x64(True):
            _, vjp64 = jax.vjp(lambda *x, k=k: jfn(*x)[k],
                               *[jnp.asarray(x, jnp.float64) for x in inputs])
            g64 = [np.asarray(g) for g in vjp64(jnp.asarray(cot,
                                                           jnp.float64))]
        t_g = torch.autograd.grad(to, t_in, torch.from_numpy(cot),
                                  retain_graph=True, allow_unused=True)
        for i, (jg, tg) in enumerate(zip(j_g, t_g)):
            jg = np.asarray(jg, np.float64)
            tg = (np.zeros_like(jg) if tg is None
                  else tg.numpy().astype(np.float64))
            fin_j, fin_t = np.isfinite(jg), np.isfinite(tg)
            bad = np.flatnonzero((fin_j != fin_t).reshape(jg.shape[0], -1)
                                 .any(-1))
            assert not len(bad), (what, k, i, [
                names[r - N_RANDOM] if r >= N_RANDOM else r for r in bad])
            both = fin_j & fin_t
            gscale = np.abs(jg[both]).max() if both.any() else 1.0
            tol = 5e-4 * np.abs(jg) + floor * gscale
            miss = both & ~(np.abs(tg - jg) <= tol)
            if not miss.any():
                continue
            assert fallback, (f"{what}: d output {k} / d input {i}",
                              tg[miss], jg[miss])
            tol64 = 5e-4 * np.abs(g64[i]) + floor * gscale
            e_j = np.abs(jg - g64[i])
            e_t = np.abs(tg - g64[i])
            held = miss & ~((e_j > tol64)
                            & (e_t <= 4 * np.maximum(e_j, tol64)))
            rows = np.flatnonzero(held.reshape(jg.shape[0], -1).any(-1))
            assert not len(rows), (
                f"{what}: d output {k} / d input {i}", [
                    names[r - N_RANDOM] if r >= N_RANDOM else r
                    for r in rows], tg[held], jg[held], g64[i][held])


HAPKE_CASES = [  # (shell_hapke, b, c, theta)
    (0, False, False, False), (1, False, False, False),
    (2, False, False, False), (3, False, False, False),
    (3, False, False, True), (0, True, False, False),
    (0, True, True, False), (0, True, True, True), (2, True, True, True)]


@pytest.mark.parametrize("shell,use_b,use_c,use_theta", HAPKE_CASES)
def test_hapke_matches_jax(shell, use_b, use_c, use_theta):
    l, v, n, names = geometry()
    p = params(len(l))
    inputs = [l, v, n, p["w"]]
    keys = ["w"] + [k for k, on in (("b", use_b), ("c", use_c),
                                    ("theta", use_theta)) if on]
    inputs = [l, v, n] + [p[k] for k in keys]

    def call(fn):
        def f(l_, v_, n_, *rest):
            kw = dict(zip(keys, rest))
            return tuple(fn(l_, v_, n_, kw.pop("w"), hpk_scl=4.0,
                            shell_hapke=shell, **kw))
        return f

    compare(call(jhapke), call(thapke), inputs, names,
            f"hapke shell {shell} {keys}")


@pytest.mark.parametrize("lvis,f0", [(False, 0.04), (True, 0.1)])
def test_microfacet_matches_jax(lvis, f0):
    l, v, n, names = geometry(seed=2)
    p = params(len(l), seed=3)

    def call(fn):
        def f(l_, v_, n_, w_, r_):
            return tuple(fn(l_, v_, n_, w_, r_, f0=f0, lvis=lvis))
        return f

    compare(call(jmicro), call(tmicro), [l, v, n, p["w"], p["rough"]],
            names, f"microfacet lvis={lvis}")


TIES = ["grazing 0.001", "grazing 1e-05", "nadir normal, nadir view",
        "sun = view = normal"]


@pytest.mark.parametrize("family", ["hapke shell 3", "hapke b c",
                                    "microfacet"])
def test_gradients_at_the_ties(family):
    """The rows where a clip or floor meets its bound exactly (the H
    function's 1e-3 floor and calc_angles' 1e-5, Microfacet's cosine
    clips at a nadir normal), held on their own scale (1e-5 of their
    largest entry), so that a tie's half gradient shows."""
    l, v, n, names = geometry()
    rows = [N_RANDOM + names.index(r) for r in TIES]
    p = params(len(l))
    geo = [x[rows] for x in (l, v, n)]
    if family == "microfacet":
        def call(fn):
            return lambda *x: tuple(fn(*x))
        inputs = geo + [p["w"][rows], p["rough"][rows]]
    else:
        full = family == "hapke b c"

        def call(fn):
            def f(l_, v_, n_, w_, *bc):
                return tuple(fn(l_, v_, n_, w_, *bc, hpk_scl=4.0,
                                shell_hapke=0 if full else 3))
            return f
        inputs = geo + [p["w"][rows]] + ([p["b"][rows], p["c"][rows]]
                                         if full else [])
    compare(call(jmicro if family == "microfacet" else jhapke),
            call(tmicro if family == "microfacet" else thapke), inputs,
            [names[r - N_RANDOM] for r in rows], family, floor=1e-5,
            fallback=False)


def test_clip_takes_jax_gradient_at_a_tie():
    """At an input exactly on a bound, jnp.clip passes half the gradient
    (maximum/minimum split ties); torch.clamp would pass all of it."""
    x = np.asarray([1e-6, 0.5, 1.0, 2.0, -1.0], np.float32)
    jg = jax.grad(lambda z: jnp.sum(jnp.clip(z, 1e-6, 1.0)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    clip(xt, 1e-6, 1.0).sum().backward()
    assert np.array_equal(xt.grad.numpy(), np.asarray(jg))
    assert np.array_equal(xt.grad.numpy(), [0.5, 1.0, 0.5, 0.0, 0.0])
