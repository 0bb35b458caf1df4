"""The port's host data and output code against the libraries and the JAX
package functions it stands in for, on the CPU:

  * utils/png: decode equal to PIL on PIL-written frames and on frames
    written with each filter type, in several IDAT chunks; the C unfilter
    equal to its NumPy twin; palettes, 16 bits and Adam7 decoded, a bad
    filter type and CRC refused; the all-Paeth 800 x 800 RGBA decode
    within 3x PIL's time (tests/png_times.py);
  * utils/resample: Pillow's LANCZOS within 1 uint8 level (RGBA 800 ->
    400, odd sizes, every mode), cv2's INTER_NEAREST bit-equal and
    INTER_LINEAR within 1e-6 at downscales 1.5, 2 and 3 and odd sizes;
  * utils/viz: JET bit-equal to cv2, render_summary_panels bit-equal to
    the JAX package's, save_png read back equal (by PIL too);
  * the SatelliteDataset at img_downscale 2 (masks, dense depth) equal to
    the JAX package's; dataset_gen and the generate_dataset CLI on the
    patterns of tests/test_dataset_gen.py against the JAX functions;
  * utils/guards: the JAX package's roundtrip and checkify's NaN check;
  * with PIL and cv2 blocked from import: the blender load, the panels,
    the downscaled dataset and generate_dataset still run.
"""

import glob
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import brdfnerf_tpu.native as jnative
from brdfnerf_tpu import dataset_gen as jdg
from brdfnerf_tpu.data import satellite as jsat
from brdfnerf_tpu.utils import viz as jviz

from brdfnerf_tpu_torch import dataset_gen as tdg
from brdfnerf_tpu_torch.cli.generate_dataset import main as tgen_main
from brdfnerf_tpu_torch.data import satellite as tsat
from brdfnerf_tpu_torch.data import synth_aoi as taoi
from brdfnerf_tpu_torch.utils import guards, png, resample, viz
from brdfnerf_tpu_torch.utils.geotiff import read_geotiff

import torch_port_common  # noqa: F401  (one torch thread a process)
from image_builders import encode_png_any
from png_times import decode_times

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def frame(h, w, c, seed=0, noise=False):
    """A smooth uint8 frame (alpha: a soft disc), or uniform noise."""
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    a = np.stack([127 + 120 * np.sin(7 * xx + 3 * yy + i)
                  for i in range(c)], -1)
    if c in (2, 4):
        a[..., -1] = np.clip(400 * np.sin(9 * xx) * np.cos(5 * yy) + 128,
                             0, 255)
    return a.astype(np.uint8)


def squeeze(a):
    return a[..., 0] if a.shape[-1] == 1 else a


@pytest.fixture
def numpy_jax(monkeypatch):
    """The JAX package on its NumPy paths (no native dispatch), which the
    port runs."""
    monkeypatch.setattr(jnative, "usable", lambda *a, **k: None)


# ------------------------------------------------------------------ PNG

@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_decode_equals_pil_on_pil_written_frames(tmp_path, c):
    from PIL import Image
    for i, (h, w, noise) in enumerate(((37, 53, False), (64, 48, True),
                                       (1, 9, False))):
        img = squeeze(frame(h, w, c, seed=i, noise=noise))
        path = str(tmp_path / f"f{i}.png")
        Image.fromarray(img, MODES[c]).save(path)
        ref = np.asarray(Image.open(path))
        got = png.read_png(path)
        assert got.dtype == np.uint8 and np.array_equal(got, ref), (c, i)


@pytest.mark.parametrize("kind", [png.NONE, png.SUB, png.UP, png.AVERAGE,
                                  png.PAETH, "per row"])
def test_png_each_filter_type(kind):
    """Frames written with one filter type (or a different type each row),
    in IDAT chunks of 97 bytes: PIL decodes them to the frame, and so do
    the C unfilter and its NumPy twin."""
    from PIL import Image
    for c in (1, 2, 3, 4):
        img = squeeze(frame(23, 31, c, seed=c, noise=(c == 3)))
        filters = (np.arange(23) % 5) if kind == "per row" else kind
        buf = png.encode_png(img, filters, idat_size=97)
        assert buf.count(b"IDAT") > 2
        (p,) = png.scanlines(buf)[1]
        h, w, cc, raw = p.rows, p.stride // p.bpp, p.bpp, p.raw
        rows = np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0]
        assert np.array_equal(rows, np.broadcast_to(filters, (h,)))
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(buf))), img)
        got = png.decode_image(buf)[0]
        assert np.array_equal(got, img), (kind, c)
        assert np.array_equal(png.unfilter_plain(raw, h, w, cc),
                              got.reshape(h, -1))


def test_png_refuses_what_it_does_not_decode(tmp_path):
    """Palettes, 16-bit samples and Adam7, once refused, decode to PIL's
    array (every type, depth and Adam7: tests/test_torch_port_image_
    formats.py); a filter type past 4 and a bad CRC are still refused."""
    from PIL import Image
    pal = str(tmp_path / "p.png")
    Image.fromarray(frame(8, 8, 3)).convert("P").save(pal)
    with open(pal, "rb") as f:
        assert png.decode_image(f.read())[1] == "P"
    assert np.array_equal(png.read_png(pal), np.asarray(Image.open(pal)))
    deep = str(tmp_path / "d.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)
                    * 1000).save(deep)
    got = png.read_png(deep)
    assert got.dtype == np.uint16
    assert np.array_equal(got, np.asarray(Image.open(deep)))
    img = frame(8, 8, 3)
    laced = encode_png_any(img.astype(np.int64), 8, 2, interlace=True)
    assert laced[28] == 1                        # IHDR interlace byte
    assert np.array_equal(png.decode_image(laced)[0], img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(laced))), img)
    buf = bytearray(png.encode_png(frame(8, 8, 3), png.SUB))
    rows = bytearray(png.scanlines(bytes(buf))[1][0].raw)
    rows[3 * 25] = 7                              # row 3's filter byte
    body = zlib.compress(bytes(rows))
    bad = (png.SIGNATURE + bytes(buf[8:33])
           + struct.pack(">I", len(body)) + b"IDAT" + body
           + struct.pack(">I", zlib.crc32(b"IDAT" + body))
           + bytes(buf[-12:]))
    with pytest.raises(ValueError, match="row 3 has filter type 7"):
        png.decode_image(bad)
    with pytest.raises(ValueError, match="CRC"):
        png.decode_image(bytes(buf[:-5]) + b"\0" + bytes(buf[-4:]))


def test_geotiff_refuses_jpeg_compression_without_pil(tmp_path):
    """JPEG-in-TIFF now decodes without PIL (to PIL's pixels: tests/test_
    torch_port_image_formats.py); what the reader still refuses, ZSTD and
    WebP, raises UnsupportedTiffFeature naming the compression."""
    from PIL import Image
    from brdfnerf_tpu_torch.utils.geotiff import UnsupportedTiffFeature
    path = str(tmp_path / "j.tif")
    Image.fromarray(frame(16, 16, 3)).save(path, compression="jpeg")
    assert np.array_equal(read_geotiff(path)[0].transpose(1, 2, 0),
                          np.asarray(Image.open(path)))
    Image.fromarray(frame(16, 16, 3)).save(path, compression="zstd")
    with pytest.raises(UnsupportedTiffFeature,
                       match="compression 50000 .ZSTD"):
        read_geotiff(path)
    with open(path, "rb") as f:           # the same file marked WebP
        buf = bytearray(f.read())
    i = buf.index(struct.pack("<HHIH", 259, 3, 1, 50000))
    buf[i + 8:i + 10] = struct.pack("<H", 50001)
    with open(path, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(UnsupportedTiffFeature,
                       match="compression 50001 .WebP"):
        read_geotiff(path)


def test_png_paeth_frame_decodes_within_three_times_pil():
    """The all-Paeth 800 x 800 RGBA frame, best of 7 interleaved decodes."""
    times = decode_times(7)
    print("png decode", times)
    assert times["ratio"] <= 3.0, times


# ----------------------------------------------------------- resampling

@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_lanczos_matches_pillow(c):
    from PIL import Image
    sizes = [(800, 800, 400, 400)] if c == 4 else []
    sizes += [(37, 53, 20, 17), (50, 40, 50, 21), (31, 29, 60, 70),
              (100, 80, 33, 80)]
    for h, w, nh, nw in sizes:
        for noise in (False, True):
            img = squeeze(frame(h, w, c, noise=noise))
            ref = np.asarray(Image.fromarray(img, MODES[c]).resize(
                (nw, nh), Image.LANCZOS))
            got = resample.resize_lanczos(img, nw, nh)
            d = np.abs(got.astype(int) - ref.astype(int))
            assert got.shape == ref.shape and d.max() <= 1, (h, w, nh, nw)


@pytest.mark.parametrize("ds", [1.5, 2.0, 3.0])
def test_cv2_lookalikes(ds):
    """INTER_NEAREST bit-equal (uint8, float, bool-like masks, 1 channel
    dropped as cv2 drops it), INTER_LINEAR within 1e-6 on float images, at
    the satellite loader's size formulas."""
    import cv2
    rng = np.random.default_rng(int(ds * 10))
    for h, w in ((64, 64), (33, 47), (101, 99), (7, 5)):
        for c in (1, 3, 4):
            f = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
            nh, nw = int(h // ds), int(w // ds)
            ref = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
            got = resample.resize_linear(f, nw, nh)
            assert got.shape == ref.shape and got.dtype == ref.dtype
            assert np.abs(got - ref).max() <= 1e-6, (h, w, c)
            u = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
            nh, nw = int(h / ds), int(w / ds)
            for arr in (u, u[..., 0], f.astype(np.float64),
                        (u > 127).astype(np.uint8) * 255):
                ref = cv2.resize(arr, (nw, nh),
                                 interpolation=cv2.INTER_NEAREST)
                got = resample.resize_nearest(arr, nw, nh)
                assert got.shape == ref.shape and np.array_equal(got, ref)


# ------------------------------------------------------------------ viz

def test_jet_is_cv2s():
    import cv2
    m = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                          cv2.COLORMAP_JET)
    assert np.array_equal(viz.JET_RGB,
                          cv2.cvtColor(m, cv2.COLOR_BGR2RGB)[:, 0])
    x = np.random.default_rng(0).normal(size=(13, 17))
    x[2, 3] = np.nan
    for mode in ("minmax", "none", "-1et1", "enhance"):
        assert np.array_equal(viz.colorize(x, mode), jviz.colorize(x, mode))


def test_panels_equal_jax_and_read_back(tmp_path):
    from PIL import Image
    h, w = 12, 10
    rng = np.random.default_rng(1)
    maps = {"rgb_coarse": rng.uniform(0, 1, (h * w, 3)),
            "depth_coarse": rng.uniform(2, 6, h * w),
            "albedo_coarse": rng.uniform(0, 1, (h * w, 3)),
            "sun_coarse": rng.uniform(0, 1, (h * w, 1)),
            "normal_an_coarse": rng.uniform(-1, 1, (h * w, 3)),
            "rpv_k_coarse": rng.uniform(0, 2, (h * w, 1)),
            "beta_coarse": rng.uniform(0, 1, (h * w, 1))}
    gt = rng.uniform(0, 1, (h * w, 3))
    diff = rng.normal(0, 10, (h, w))
    diff_nr = rng.uniform(0, 120, (h, w))
    for kw in ({}, dict(diff=diff, diff_nr=diff_nr, visu_scale=1.7)):
        got = viz.render_summary_panels(maps, gt, h, w, **kw)
        ref = jviz.render_summary_panels(maps, gt, h, w, **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, ref)
        path = str(tmp_path / "sub" / "p.png")
        viz.save_png(path, got)
        assert np.array_equal(png.read_png(path), got)
        assert np.array_equal(np.asarray(Image.open(path)), got)
    for fn, args in (("normal_to_rgb", (maps["normal_an_coarse"],)),
                     ("depth_to_rgb", (maps["depth_coarse"], h, w)),
                     ("diff_to_rgb", (diff,)),
                     ("accumulate_feature",
                      (rng.uniform(0, 1, (h * w, 4)),
                       rng.uniform(0, 1, (h * w, 4, 1)), h, w))):
        assert np.array_equal(getattr(viz, fn)(*args),
                              getattr(jviz, fn)(*args)), fn


# ------------------------------------------------- downscale, dataset_gen

@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    """A bumpy AOI with footprint masks (the mask resize runs at ds > 1)."""
    info = taoi.build_aoi(str(tmp_path_factory.mktemp("aoi")), bumpy=True)
    tdg.generate_footprint_masks(info["root"], info["names"][0])
    return info


def test_downscaled_satellite_dataset_matches_jax(aoi, numpy_jax):
    """img_downscale 2: the train store (rays, rgbs, dense depth, normals)
    and the val samples (masks resized) equal the JAX package's: rgbs to
    1e-6 (cv2's INTER_LINEAR), everything else bit for bit."""
    kw = dict(root_dir=aoi["root"], aoi_id=aoi["aoi_id"], img_downscale=2.0)
    jtr = jsat.SatelliteDataset(jsat.SatelliteConfig(**kw), "train")
    jva = jsat.SatelliteDataset(jsat.SatelliteConfig(**kw), "val")
    ttr = tsat.SatelliteDataset(tsat.SatelliteConfig(**kw), "train")
    tva = tsat.SatelliteDataset(tsat.SatelliteConfig(**kw), "val")
    assert set(ttr.store) == set(jtr.store)
    assert ttr.store["rays"].shape[0] == 2 * 16 * 16
    for k, v in jtr.store.items():
        assert ttr.store[k].dtype == v.dtype and ttr.store[k].shape == v.shape
        if k == "rgbs":
            assert np.abs(ttr.store[k] - v).max() <= 1e-6
        else:
            assert np.array_equal(ttr.store[k], v), k
    for i in range(len(jva)):
        st, sj = tva.get_image(i), jva.get_image(i)
        assert set(st) == set(sj)
        assert not sj["mask"].all()
        for k, v in sj.items():
            if k == "rgbs":
                assert np.abs(st[k] - v).max() <= 1e-6
            elif isinstance(v, np.ndarray):
                assert np.array_equal(st[k], v), (i, k)
            else:
                assert st[k] == v, (i, k)
    for ds in (1.5, 3.0):
        flat = np.random.default_rng(0).normal(size=(32 * 32, 2))
        assert np.array_equal(tsat._resize_flat(flat, 32, 32, ds),
                              jsat._resize_flat(flat, 32, 32, ds))
        img = os.path.join(aoi["root"], "img_00.tif")
        assert np.abs(tsat.load_rgb(img, ds)
                      - jsat.load_rgb(img, ds)).max() <= 1e-6


def test_dataset_gen_functions_match_jax(aoi, tmp_path):
    """tests/test_dataset_gen.py's patterns: footprint, image JSON, masks
    (the JAX package's PIL-written and the port's, as PIL and read_geotiff
    read them), splits, the RPC text, run_ba's fallback."""
    from PIL import Image
    rpc_d = taoi.affine_rpc_dict()
    for mod in (jdg, tdg):
        assert mod.run_ba(aoi["root"], str(tmp_path / "ba")) is None
    j = jdg.image_footprint_geojson(jdg.rpc_mod.rpc_from_dict(rpc_d), 32, 32,
                                    z=taoi.ALT0)
    t = tdg.image_footprint_geojson(tdg.rpc_mod.rpc_from_dict(rpc_d), 32, 32,
                                    z=taoi.ALT0)
    assert j == t
    img = os.path.join(aoi["root"], "img_01.tif")
    dsm = os.path.join(aoi["gt_dir"], f"{aoi['aoi_id']}_DSM.tif")
    outs = [mod.create_image_json(img, rpc_d, 50.0, 160.0,
                                  str(tmp_path / side), dsm_path=dsm)
            for side, mod in (("j", jdg), ("t", tdg))]
    assert [json.load(open(p)) for p in outs][0] == json.load(open(outs[1]))
    for side, mod in (("j", jdg), ("t", tdg)):
        d = str(tmp_path / f"m{side}")
        os.makedirs(d)
        for f in glob.glob(os.path.join(aoi["root"], "img_*.json")):
            with open(f) as src, open(os.path.join(
                    d, os.path.basename(f)), "w") as dst:
                dst.write(src.read())
        assert len(mod.generate_footprint_masks(d, "img_00.json")) == 3
    for jm in sorted(glob.glob(str(tmp_path / "mj" / "*_mask.tif"))):
        tm = jm.replace("/mj/", "/mt/")
        ref = np.asarray(Image.open(jm))
        assert np.array_equal(np.asarray(Image.open(tm)), ref)
        assert np.array_equal(read_geotiff(tm)[0][0], ref)
        assert 0 < (ref > 0).mean()
    ids = [f"img_{i:02d}.json" for i in range(10)]
    for seed in (0, 1):
        assert (tdg.create_train_test_splits(ids, 0.2, seed=seed)
                == jdg.create_train_test_splits(ids, 0.2, seed=seed))
    sidecar = tmp_path / "cam.rpc_adj"
    sidecar.write_text(taoi.rpc00b_text(rpc_d))
    assert tdg.parse_rpc_file(str(sidecar)) == jdg.parse_rpc_file(
        str(sidecar)) == {k: (float(v) if not isinstance(v, list) else v)
                          for k, v in rpc_d.items()}
    for kw in ({}, dict(per_channel=True), dict(vmin=3.0, vmax=9.0)):
        x = np.random.default_rng(2).uniform(0, 12, (3, 5, 4))
        assert np.array_equal(tdg.scale_img(x, **kw), jdg.scale_img(x, **kw))


def test_generate_dataset_cli_matches_jax(aoi, tmp_path):
    """Both packages' CLIs on the same full-scene images and RPC sidecars
    (taoi.write_full_scenes): the same files, equal JSONs, splits and
    GeoTIFF pixels; the result trains (the port's SatelliteDataset loads
    it at img_downscale 2)."""
    from brdfnerf_tpu.cli.generate_dataset import main as jgen_main
    taoi.write_full_scenes(str(tmp_path / "imgs"))
    trees = {}
    for side, fn in (("j", jgen_main), ("t", tgen_main)):
        out = str(tmp_path / side)
        assert fn(["--aoi_id", aoi["aoi_id"], "--dsm_dir", aoi["gt_dir"],
                   "--img_dir", str(tmp_path / "imgs"), "--out_dir", out,
                   "--utm_zone", str(taoi.ZONE), "--run_ba"]) == 0
        trees[side] = sorted(os.path.relpath(os.path.join(a, f), out)
                             for a, _, fs in os.walk(out) for f in fs)
    assert trees["j"] == trees["t"] and len(trees["t"]) >= 10
    for f in trees["t"]:
        a, b = (os.path.join(str(tmp_path / s), f) for s in ("j", "t"))
        if f.endswith(".tif"):
            ra, rb = read_geotiff(a), read_geotiff(b)
            assert np.array_equal(ra[0], rb[0], equal_nan=True), f
        elif f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), f
        else:
            assert open(a).read() == open(b).read(), f
    root = os.path.join(str(tmp_path / "t"), f"dataset{aoi['aoi_id']}",
                        "root_dir", aoi["aoi_id"])
    scled = os.path.join(str(tmp_path / "t"), f"dataset{aoi['aoi_id']}",
                         aoi["aoi_id"], "RGB-crops", aoi["aoi_id"], "scled")
    ds = tsat.SatelliteDataset(tsat.SatelliteConfig(
        root_dir=root, img_dir=scled, aoi_id=aoi["aoi_id"],
        img_downscale=2.0, load_depth=False), "train")
    assert ds.store["rays"].shape[0] > 0


# --------------------------------------------------------------- guards

def test_guards_roundtrip_and_checkify(capsys):
    x = torch.tensor([1.0, float("nan"), float("inf")])
    guards.enable(False)
    assert guards.guard(x, "x") is x
    assert guards.guard_tree({"x": x}) == {"x": x}
    assert float(guards.replace_nan(x, 0.0)[1]) == 0.0
    assert float(guards.safe_pow(torch.tensor(-1.0), torch.tensor(0.5))) \
        == pytest.approx(1e-4, rel=1e-2)
    assert float(guards.unit_fraction(torch.tensor(
        [[1.0, 0, 0], [2.0, 0, 0]]))) == pytest.approx(0.5)
    capsys.readouterr()
    try:
        guards.enable(True)
        guards.guard_tree({"x": x}, "t/")
        assert "[numerics] t/x: 1 NaN, 1 Inf of 3" in capsys.readouterr().out

        def fn(v):
            return torch.sqrt(v * 2.0 - 3.0).sum()
        err, out = guards.checkify_wrap(fn)(torch.tensor([2.0, 4.0]))
        assert err.get() is None and torch.isfinite(out)
        err, out = guards.checkify_wrap(fn)(torch.tensor([1.0, 4.0]))
        assert "sqrt" in err.get() and torch.isnan(out)
        with pytest.raises(FloatingPointError, match="sqrt"):
            err.throw()
        # NaN in, NaN out: no op generated it
        err, _ = guards.checkify_wrap(fn)(torch.tensor([float("nan")]))
        assert err.get() is None
    finally:
        guards.enable(False)


# ------------------------------------------------------ without PIL, cv2

def test_host_paths_run_without_pil_or_cv2(aoi, tmp_path, monkeypatch):
    """PIL and cv2 made unimportable: a blender frame loads and resizes,
    panels are written and read back, the downscaled dataset builds and
    generate_dataset writes its dataset and masks."""
    from brdfnerf_tpu_torch.data.blender import BlenderDataset
    root = str(tmp_path / "blender")
    os.makedirs(os.path.join(root, "val"))
    png.write_png(os.path.join(root, "val", "r_0.png"), frame(40, 40, 4))
    with open(os.path.join(root, "transforms_val.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": [
            {"file_path": "./val/r_0",
             "transform_matrix": np.eye(4).tolist()}]}, f)
    taoi.write_full_scenes(str(tmp_path / "imgs"))
    for name in list(sys.modules):
        if name.split(".")[0] in ("PIL", "cv2"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    s = BlenderDataset(root, "val", img_wh=(20, 20)).get_image(0)
    assert s["rgbs"].shape == (400, 3)
    panel = viz.render_summary_panels(
        {"rgb_coarse": s["rgbs"], "depth_coarse": s["rays"][:, 6]},
        s["rgbs"], 20, 20)
    viz.save_png(str(tmp_path / "p" / "panel.png"), panel)
    assert np.array_equal(png.read_png(str(tmp_path / "p" / "panel.png")),
                          panel)
    ds = tsat.SatelliteDataset(tsat.SatelliteConfig(
        root_dir=aoi["root"], aoi_id=aoi["aoi_id"], img_downscale=2.0),
        "val")
    assert not ds.get_image(1)["mask"].all()
    out = str(tmp_path / "gen")
    assert tgen_main(["--aoi_id", aoi["aoi_id"], "--dsm_dir", aoi["gt_dir"],
                      "--img_dir", str(tmp_path / "imgs"), "--out_dir", out,
                      "--utm_zone", str(taoi.ZONE)]) == 0
    root = os.path.join(out, f"dataset{aoi['aoi_id']}", "root_dir",
                        aoi["aoi_id"])
    assert len(tdg.generate_footprint_masks(root, "full_00.json")) == 3
