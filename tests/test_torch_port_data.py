"""The port's host data path against the JAX package on the same inputs:
GeoTIFF I/O, geodesy and the RPC model, the synthetic AOI (build_aoi), the
satellite dataset's store and validation samples, and mask reading.

Both packages run the same NumPy code.  The JAX package dispatches large
batches to its native C++ kernels (brdfnerf_tpu/native), which the port has
not copied; the `numpy_jax` fixture turns that dispatch off, so the two
sides compute the same float64 arithmetic in the same order.

Tolerances:
  * GeoTIFF round trips, AOI files, the dataset's store arrays, the scene
    normalisation and the validation samples: bit-equal (the same code on
    the same inputs; nothing is summed in another order).
  * geodesy and projection_np / localization_np: 1e-12 degrees (and
    1e-9 m in UTM, 1e-9 px), though equal bits are expected.
  * the RPV-shaded AOI image: at most one grey level of 255 (the port
    shades through torch, the JAX package through jnp, in float32).
"""

import filecmp
import os

import numpy as np
import pytest

import brdfnerf_tpu.native as jnative
from brdfnerf_tpu.data import satellite as jsat
from brdfnerf_tpu.data import synth_aoi as jaoi
from brdfnerf_tpu.geo import geodesy as jgeo
from brdfnerf_tpu.geo import rpc as jrpc
from brdfnerf_tpu.utils import geotiff as jtif

from brdfnerf_tpu_torch.data import factory as tfactory
from brdfnerf_tpu_torch.data import satellite as tsat
from brdfnerf_tpu_torch.data import synth_aoi as taoi
from brdfnerf_tpu_torch.geo import geodesy as tgeo
from brdfnerf_tpu_torch.geo import rpc as trpc
from brdfnerf_tpu_torch.utils import geotiff as ttif

import torch_port_common  # noqa: F401  (one torch thread a process)

STORE_KEYS = ("rays", "rgbs", "ts", "rows", "cols", "depths", "valid_depth",
              "depth_std", "normals", "valid_normal")


@pytest.fixture
def numpy_jax(monkeypatch):
    """The JAX package on its NumPy paths (no native dispatch)."""
    monkeypatch.setattr(jnative, "usable", lambda *a, **k: None)


def _tree_files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


# ----------------------------------------------------------------- GeoTIFF

@pytest.mark.parametrize("dtype,bands", [(np.uint8, 3), (np.float32, 1),
                                         (np.uint16, 2), (np.int16, 1)])
def test_geotiff_round_trips_between_packages(tmp_path, dtype, bands):
    rng = np.random.RandomState(bands)
    arr = (rng.uniform(0, 200, (bands, 19, 23))).astype(dtype)
    prof = dict(ulx=425000.5, uly=5317000.25, xres=0.5, yres=0.5,
                epsg=32631, nodata=(-9999.0 if dtype == np.float32
                                    else None))
    pj, pt = str(tmp_path / "j.tif"), str(tmp_path / "t.tif")
    jtif.write_geotiff(pj, arr, jtif.GeoProfile(**prof))
    ttif.write_geotiff(pt, arr, ttif.GeoProfile(**prof))
    assert filecmp.cmp(pj, pt, shallow=False)
    for path in (pj, pt):
        a_j, p_j = jtif.read_geotiff(path)
        a_t, p_t = ttif.read_geotiff(path)
        assert a_t.dtype == a_j.dtype == arr.dtype
        assert np.array_equal(a_t, arr) and np.array_equal(a_j, arr)
        assert vars(p_t) == vars(p_j)
    assert ttif.utm_epsg(31, True) == jtif.utm_epsg(31, True) == 32631
    assert ttif.utm_epsg(18, False) == jtif.utm_epsg(18, False)


# ------------------------------------------------------- geodesy and RPC

def test_geodesy_and_rpc_match_jax(numpy_jax):
    rng = np.random.RandomState(0)
    n = 5000          # over the JAX package's native threshold and block
    # inside the AOI's footprint (normalised coordinates within +-0.8)
    lat = 48.0 + rng.uniform(-1.6e-4, 1.6e-4, n)
    lon = 2.0 + rng.uniform(-2.4e-4, 2.4e-4, n)
    alt = rng.uniform(60.0, 160.0, n)
    for f in ("latlon_to_ecef",):
        for a, b in zip(getattr(tgeo, f)(lat, lon, alt),
                        getattr(jgeo, f)(lat, lon, alt)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    x, y, z = jgeo.latlon_to_ecef(lat, lon, alt)
    for a, b in zip(tgeo.ecef_to_latlon(x, y, z), jgeo.ecef_to_latlon(x, y, z)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    e_t, n_t = tgeo.utm_from_latlon(lat, lon)
    e_j, n_j = jgeo.utm_from_latlon(lat, lon)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-9)
    for a, b in zip(tgeo.latlon_from_utm(e_j, n_j, 31),
                    jgeo.latlon_from_utm(e_j, n_j, 31)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert tgeo.utm_zone_from_latlon(48.0, 2.0) == \
        jgeo.utm_zone_from_latlon(48.0, 2.0)
    np.testing.assert_array_equal(tgeo.sun_direction(55.0, 140.0),
                                  jgeo.sun_direction(55.0, 140.0))
    assert tgeo.scaling_params(alt) == jgeo.scaling_params(alt)

    # a non-affine RPC: every polynomial term and the denominators live
    d = jaoi.affine_rpc_dict(0.15, 0.05)
    for k in ("col_num", "row_num", "col_den", "row_den"):
        d[k] = [v + 1e-3 * rng.uniform(-1, 1) * (j > 0)
                for j, v in enumerate(d[k])]
    rj, rt = jrpc.rpc_from_dict(d), trpc.rpc_from_dict(d)
    for a, b in zip(rt, rj):
        assert np.array_equal(a, b)
    col_t, row_t = trpc.projection_np(rt, lon, lat, alt)
    col_j, row_j = jrpc.projection_np(rj, lon, lat, alt)
    np.testing.assert_allclose(col_t, col_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(row_t, row_j, rtol=0, atol=1e-9)
    lo_t, la_t = trpc.localization_np(rt, col_j, row_j, alt)
    lo_j, la_j = jrpc.localization_np(rj, col_j, row_j, alt)
    np.testing.assert_allclose(lo_t, lo_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(la_t, la_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lo_t, lon, rtol=0, atol=1e-9)
    for a, b in zip(trpc.rescale_rpc(rt, 0.5), jrpc.rescale_rpc(rj, 0.5)):
        assert np.array_equal(a, b)
    text = "\n".join(
        [f"{k}: {float(d[v])}" for k, v in jrpc._RPC00B_FIELD_MAP.items()]
        + [f"{k}_{j + 1}: {d[v][j]}" for k, v in
           jrpc._RPC00B_COEFF_MAP.items() for j in range(20)])
    assert (trpc.rpc_dict_from_rpc00b_text(text)
            == jrpc.rpc_dict_from_rpc00b_text(text))


# ---------------------------------------------------------- the AOI

def test_build_aoi_writes_the_jax_packages_files(tmp_path):
    rj = jaoi.build_aoi(str(tmp_path / "j"))
    rt = taoi.build_aoi(str(tmp_path / "t"))
    files = _tree_files(rj["root"])
    assert files == _tree_files(rt["root"]) and len(files) > 10
    for f in files:
        assert filecmp.cmp(os.path.join(rj["root"], f),
                           os.path.join(rt["root"], f), shallow=False), f
    assert {k: v for k, v in rt.items() if k not in ("root", "gt_dir")} \
        == {k: v for k, v in rj.items() if k not in ("root", "gt_dir")}


def test_build_aoi_rpv_shading_matches_jax(tmp_path, numpy_jax):
    """The RPV-, Hapke- and Microfacet-shaded AOIs against the JAX
    package's build_aoi: images within 1 level, other files byte-equal."""
    for name, gt in (("rpv", jaoi.RPV_GT), ("hapke", jaoi.HAPKE_GT),
                     ("microfacet", jaoi.MICROFACET_GT)):
        kw = dict(bumpy=True, brdf=dict(gt))
        rj = jaoi.build_aoi(str(tmp_path / name / "j"), **kw)
        rt = taoi.build_aoi(str(tmp_path / name / "t"), **kw)
        files = _tree_files(rj["root"])
        assert files == _tree_files(rt["root"]), name
        for f in files:
            a, b = (os.path.join(r["root"], f) for r in (rj, rt))
            if f.startswith("img_") and f.endswith(".tif"):
                ia, ib = jtif.read_geotiff(a)[0], jtif.read_geotiff(b)[0]
                d = np.abs(ia.astype(int) - ib.astype(int))
                assert d.max() <= 1, (name, f, d.max())
            else:
                assert filecmp.cmp(a, b, shallow=False), (name, f)


# -------------------------------------------------------- the dataset

def _configs(root, **kw):
    kw = dict(dict(root_dir=root, aoi_id="Synth_001"), **kw)
    return jsat.SatelliteConfig(**kw), tsat.SatelliteConfig(**kw)


@pytest.mark.parametrize("cached", [False, True])
def test_satellite_dataset_matches_jax(tmp_path, numpy_jax, cached):
    """The train store and the val split's samples, array by array, on a
    bumpy AOI (nonzero GT normals); with a cache directory, a second build
    reads the port's own ray and depth caches."""
    info = taoi.build_aoi(str(tmp_path / "aoi"), bumpy=True)
    jc, tc = _configs(info["root"],
                      cache_dir=str(tmp_path / "cache") if cached else None)
    jtr, jva = (jsat.SatelliteDataset(jc, s) for s in ("train", "val"))
    for build in range(2 if cached else 1):
        ttr, tva = (tsat.SatelliteDataset(tc, s) for s in ("train", "val"))
        assert set(ttr.store) == set(jtr.store) == set(STORE_KEYS)
        for k in STORE_KEYS:
            a, b = ttr.store[k], jtr.store[k]
            assert a.dtype == b.dtype and np.array_equal(a, b), (build, k)
        assert np.array_equal(ttr.scene.center, jtr.scene.center)
        assert ttr.scene.range == jtr.scene.range
        assert ttr.utm_zone == jtr.utm_zone and len(tva) == len(jva) == 2
        for i in range(len(jva)):
            st, sj = tva.get_image(i), jva.get_image(i)
            assert set(st) == set(sj)
            for k, v in sj.items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(st[k], v), (i, k)
                else:
                    assert st[k] == v, (i, k)
    if cached:
        assert any(f.endswith(".npz") for f in os.listdir(tmp_path / "cache"))


def test_mask_is_read_as_pil_reads_it(tmp_path):
    """A {json}_mask.tif as the JAX package's dataset tools write it (PIL,
    uint8 0/255) reads through the port's GeoTIFF reader as through PIL."""
    from PIL import Image
    info = taoi.build_aoi(str(tmp_path / "aoi"))
    json_p = os.path.join(info["root"], info["names"][0])
    rng = np.random.RandomState(3)
    m = ((rng.uniform(0, 1, (32, 32)) > 0.4) * 255).astype(np.uint8)
    Image.fromarray(m).save(json_p[:-5] + "_mask.tif")
    got = tsat.load_mask(json_p, 32, 32)
    assert np.array_equal(got, jsat.load_mask(json_p, 32, 32))
    assert np.array_equal(got, np.asarray(Image.open(
        json_p[:-5] + "_mask.tif")).reshape(-1) > 0)
    assert got.dtype == bool and 0 < got.sum() < got.size
    missing = os.path.join(info["root"], info["names"][1])
    assert tsat.load_mask(missing, 4, 5).all()
    jc, tc = _configs(info["root"])
    assert np.array_equal(tsat.SatelliteDataset(tc, "val").get_image(0)[
        "mask"], jsat.SatelliteDataset(jc, "val").get_image(0)["mask"])


def test_what_is_not_ported_raises(tmp_path):
    """Nothing of the data layer raises not_ported any more: the dataset
    at img_downscale 2 builds (its parity with JAX is in
    tests/test_torch_port_host_data.py) and the factory loads blender
    directories (tests/test_torch_port_blender.py); a sat-nerf keypoint
    store without tie points raises FileNotFoundError."""
    info = taoi.build_aoi(str(tmp_path / "aoi"))
    _, tc = _configs(info["root"], img_downscale=2.0)
    assert tsat.SatelliteDataset(tc, "train").store["rays"].shape == (
        2 * 16 * 16, 11)
    # the sat-nerf keypoint store needs the AOI's tie points (pts3d.npy;
    # build_aoi writes them with_keypoints): its parity is in
    # tests/test_torch_port_defaults_cli.py
    _, tc = _configs(info["root"], load_depth=False, sparse_depth=True)
    with pytest.raises(FileNotFoundError, match="pts3d"):
        tsat.SatelliteDataset(tc, "train")
    from test_torch_port_blender import make_blender_dir
    broot = make_blender_dir(str(tmp_path / "blender"), n_frames=1)
    bl = tfactory.load_dataset("nerf", "blender", broot, img_wh=(24, 24))
    assert bl.store["rays"].shape == (24 * 24, 8)
    with pytest.raises(FileNotFoundError, match="transforms_train"):
        tfactory.load_dataset("spsbrdf-nerf", "blender", info["root"])
    ds = tfactory.load_dataset("spsbrdf-nerf", "sat", info["root"],
                               aoi_id=info["aoi_id"])
    assert ds.cfg.load_depth and "depths" in ds.store


def test_sat_config_from_opts_matches_jax():
    from brdfnerf_tpu.cli import opts as jopts
    from brdfnerf_tpu_torch.cli import opts as topts
    argv = ["--root_dir", "r", "--exp_name", "e", "--cache_dir", "c",
            "--img_dir", "i", "--infile_postfix", "_x", "--cs", "ecef",
            "--corrscale", "0.5", "--model", "sps-nerf"]
    a = topts.postprocess(topts.train_parser().parse_args(argv))
    b = jopts.postprocess(jopts.train_parser().parse_args(argv))
    assert vars(topts.sat_config_from_opts(a)) == \
        vars(jopts.sat_config_from_opts(b))
