"""The port's public helpers against the JAX package's (Queue 1 item 14):
models.network.model_config_for_variant, the batched RPC functions of
geo/rpc (projection, localization_normalized, localization) on torch
tensors, and the names each subpackage exports."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brdfnerf_tpu.geo import rpc as jrpc
from brdfnerf_tpu.models import network as jnet

from brdfnerf_tpu_torch.geo import rpc as trpc
from brdfnerf_tpu_torch.models import network as tnet

import torch_port_common  # noqa: F401  (one torch thread a process)
from test_geo import _affine_rpc, _pleiades_like_rpc

VARIANTS = ["nerf", "s-nerf", "sat-nerf", "sps-nerf", "spsbrdf-nerf"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_config_for_variant_equals_jax(variant):
    for over in ({}, dict(feat=128, layers=4, skips=(2,)),
                 dict(siren=False, beta=True, sun_v="none")):
        j = jnet.model_config_for_variant(variant, **over)
        t = tnet.model_config_for_variant(variant, **over)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (variant,
                                                                over)


def test_model_config_for_variant_refuses_unknown():
    for fn in (jnet.model_config_for_variant, tnet.model_config_for_variant):
        with pytest.raises(ValueError, match="not valid"):
            fn("nerf++")


@pytest.fixture(scope="module")
def pleiades():
    rpc, resid = _pleiades_like_rpc()
    assert resid < 0.05
    return rpc


def _grid(rpc, n=9):
    cols, rows = np.meshgrid(np.linspace(200.0, 39800.0, n),
                             np.linspace(200.0, 39800.0, n))
    return cols.ravel(), rows.ravel()


def test_localization_normalized_equals_jax_float32(pleiades):
    """float32 Newton in normalized coordinates: within 1e-5 of the JAX
    function on the same inputs, over the image grid at three altitudes
    (one call, the JAX side jitted)."""
    import jax
    rpc = pleiades
    cols, rows = _grid(rpc)
    alts = np.repeat([float(rpc.alt_offset + n * rpc.alt_scale)
                      for n in (-0.95, 0.0, 0.95)], cols.size)
    cols, rows = np.tile(cols, 3), np.tile(rows, 3)
    jl = jax.jit(jrpc.localization_normalized)(
        rpc, *(jnp.asarray(v, jnp.float32) for v in (cols, rows, alts)))
    tl = trpc.localization_normalized(
        rpc, *(torch.tensor(v, dtype=torch.float32)
               for v in (cols, rows, alts)))
    for t, j in zip(tl, jl):
        assert t.dtype == torch.float32 and t.shape == (cols.size,)
        assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-5


def test_localization_round_trip_within_a_tenth_of_a_pixel(pleiades):
    """As tests/test_geo.py's subpixel test: the float32 normalized
    localization, denormalized in float64 and projected back, lands
    within 0.1 px; localization and projection in float64 close the loop
    and match the NumPy host functions."""
    rpc = pleiades
    cols, rows = _grid(rpc)
    for nalt in (-0.95, -0.4, 0.0, 0.55, 0.95):
        alt = float(rpc.alt_offset + nalt * rpc.alt_scale)
        nlon, nlat = trpc.localization_normalized(
            rpc, torch.tensor(cols, dtype=torch.float32),
            torch.tensor(rows, dtype=torch.float32), alt)
        lon = nlon.double().numpy() * float(rpc.lon_scale) + float(
            rpc.lon_offset)
        lat = nlat.double().numpy() * float(rpc.lat_scale) + float(
            rpc.lat_offset)
        c2, r2 = trpc.projection_np(rpc, lon, lat, np.full(cols.size, alt))
        assert np.hypot(c2 - cols, r2 - rows).max() < 0.1, nalt
        lon, lat = trpc.localization(rpc, torch.tensor(cols),
                                     torch.tensor(rows), alt)
        assert lon.dtype == torch.float64
        c3, r3 = trpc.projection(rpc, lon, lat, alt)
        assert np.hypot(c3.numpy() - cols, r3.numpy() - rows).max() < 1e-6
        c4, r4 = trpc.projection_np(rpc, lon.numpy(), lat.numpy(), alt)
        assert np.abs(c3.numpy() - c4).max() < 1e-6
        assert np.abs(r3.numpy() - r4).max() < 1e-6


def test_projection_equals_jax_float32():
    for rpc in (_affine_rpc(), _pleiades_like_rpc()[0]):
        rng = np.random.default_rng(0)
        lon = rpc.lon_offset + rpc.lon_scale * rng.uniform(-1, 1, 64)
        lat = rpc.lat_offset + rpc.lat_scale * rng.uniform(-1, 1, 64)
        alt = rpc.alt_offset + rpc.alt_scale * rng.uniform(-1, 1, 64)
        jc, jr = jrpc.projection(rpc, *(jnp.asarray(v, jnp.float32)
                                        for v in (lon, lat, alt)))
        tc, tr = trpc.projection(rpc, *(torch.tensor(v, dtype=torch.float32)
                                        for v in (lon, lat, alt)))
        scale = float(rpc.col_scale)
        assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 2e-6 * scale
        assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 2e-6 * scale


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_poly20_one_body_for_arrays_and_tensors(kind):
    """The one polynomial body and its derivatives, on float64 arrays and
    tensors, equal the host's GEMM forms (the design matrix times the
    coefficients, its first ten columns times _deriv_coeff_np)."""
    rpc = _pleiades_like_rpc()[0]
    x, y, z = np.random.default_rng(1).uniform(-1, 1, (3, 50))
    m = trpc._monomials20_np(x, y, z)
    for c in (rpc.col_num, rpc.col_den, rpc.row_num, rpc.row_den):
        c = np.asarray(c, np.float64)
        if kind == "numpy":
            args = (c, x, y, z)
        else:
            args = tuple(torch.from_numpy(v) for v in (c, x, y, z))
        val = np.asarray(trpc._poly20(*args))
        dx, dy = (np.asarray(d) for d in trpc._poly20_grad(*args))
        np.testing.assert_allclose(val, m @ c, rtol=1e-12, atol=1e-12)
        grad = m[:, :10] @ trpc._deriv_coeff_np(c)
        np.testing.assert_allclose(dx, grad[:, 0], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dy, grad[:, 1], rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_rpc_functions_stay_on_the_tensors_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rpc = _affine_rpc()
    c = torch.full((8,), float(rpc.col_offset), device="cuda")
    lon, lat = trpc.localization(rpc, c, c, float(rpc.alt_offset))
    col, row = trpc.projection(rpc, lon, lat, float(rpc.alt_offset))
    assert col.device.type == "cuda" and lon.device.type == "cuda"


SHARDING = {"make_mesh": "init_mesh", "shard_batch": "Mesh.block",
            "replicate": "Mesh.broadcast"}


@pytest.mark.parametrize("sub", ["brdf", "data", "geo", "models", "ops",
                                 "parallel", "render"])
def test_subpackages_export_the_jax_names(sub):
    """Every name of the JAX subpackage's __all__ is exported by the port's,
    in the same order, but the three JAX sharding idioms, whose
    counterparts the parallel docstring names."""
    j = importlib.import_module(f"brdfnerf_tpu.{sub}")
    t = importlib.import_module(f"brdfnerf_tpu_torch.{sub}")
    want = [n for n in j.__all__ if n not in SHARDING]
    assert list(t.__all__) == want
    for name in want:
        assert getattr(t, name) is not None, name
    if sub == "parallel":
        for jname, counterpart in SHARDING.items():
            assert jname in t.__doc__ and counterpart in t.__doc__
        from brdfnerf_tpu_torch.parallel import mesh
        assert callable(mesh.init_mesh) and callable(mesh.Mesh.block)
        assert callable(mesh.Mesh.broadcast)
