"""The blender dataset (--data blender, vanilla NeRF) in the port against
the JAX package, on the CPU:

  * BlenderDataset's train store and get_image: rays within 1e-6, rgbs
    within 1/255 where the frames are resized (Pillow's LANCZOS there,
    utils/resample here) and equal otherwise, on frames PIL wrote and on
    frames the port wrote with each PNG filter type; the perturbations;
  * a render of a blender image at equal weights and draws within the
    serve tests' bounds (close_slice);
  * both packages' train CLIs on a small blender directory: PSNR rises
    (the port's by 3 dB, as tests/test_misc.py's blender e2e), the same
    validation panel PNGs on the JAX cadence, each decoding to the stack of
    its render; the port's eval CLI writes the panels and serves the run by
    index.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.cli import opts as jopts
from brdfnerf_tpu.cli.train import main as jax_train_main
from brdfnerf_tpu.data import blender as jbl
from brdfnerf_tpu.render import render as jrender

from brdfnerf_tpu_torch import serve as tserve
from brdfnerf_tpu_torch.cli import opts as topts
from brdfnerf_tpu_torch.cli.eval import evaluate as teval
from brdfnerf_tpu_torch.cli.train import main as port_train_main
from brdfnerf_tpu_torch.data import blender as tbl
from brdfnerf_tpu_torch.render import render as trender
from brdfnerf_tpu_torch.utils import png, viz

from test_torch_port_serve import close_slice
from torch_port_common import networks, render_draws, t


def frame(wh, i, rng):
    """A smooth RGBA frame with a noisy alpha (the blending test's)."""
    yy, xx = np.mgrid[0:wh, 0:wh] / wh
    img = np.zeros((wh, wh, 4))
    img[..., 0] = 127 + 100 * np.sin(3 * xx + i)
    img[..., 1] = 127 + 100 * np.cos(2 * yy - i)
    img[..., 2] = 127 + 100 * np.sin(2 * xx + 2 * yy)
    img = img.astype(np.uint8)
    img[..., 3] = (rng.uniform(0, 1, (wh, wh)) > 0.5) * 255
    img[: wh // 4, : wh // 4, 3] = 128               # partial alpha
    return img


def make_blender_dir(root, n_frames=2, wh=48, writer="port",
                     splits=("train", "val")):
    """transforms_{split}.json and frames r_i.png on a sphere of radius 4;
    the port's writer cycles the PNG filter types frame by frame."""
    rng = np.random.default_rng(0)
    for split in splits:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n_frames):
            ang = 2 * np.pi * i / n_frames + (split == "val")
            c2w = np.eye(4)
            c2w[:3, 3] = [4 * np.cos(ang), 4 * np.sin(ang), 0.5]
            img = frame(wh, i, rng)
            p = f"./{split}/r_{i}"
            path = os.path.join(root, p + ".png")
            if writer == "pil":
                from PIL import Image
                Image.fromarray(img).save(path)
            else:
                png.write_png(path, img, filters=i % 5)
            frames.append({"file_path": p,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return root


@pytest.mark.parametrize("writer", ["port", "pil"])
@pytest.mark.parametrize("wh", [(48, 48), (32, 24)])
def test_store_and_images_match_jax(tmp_path, writer, wh):
    root = make_blender_dir(str(tmp_path), n_frames=5, writer=writer)
    j, tt = (m.BlenderDataset(root, "train", img_wh=wh) for m in (jbl, tbl))
    assert len(tt) == len(j) == 5 * wh[0] * wh[1]
    resized = wh != (48, 48)
    for k, v in j.train_store.items():
        got = tt.train_store[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        if k == "rgbs" and resized:
            assert np.abs(got - v).max() <= 1 / 255 + 1e-7
        elif k == "rays":
            assert np.abs(got - v).max() <= 1e-6
        else:
            assert np.array_equal(got, v), k
    assert tt.focal == j.focal
    jv, tv = (m.BlenderDataset(root, "val", img_wh=wh) for m in (jbl, tbl))
    assert len(tv) == len(jv) == 5
    for i in range(5):
        sj, st = jv.get_image(i), tv.get_image(i)
        assert set(st) == set(sj)
        for k, v in sj.items():
            if k == "rgbs" and resized:
                assert np.abs(st[k] - v).max() <= 1 / 255 + 1e-7
            elif k == "rays":
                assert np.abs(st[k] - v).max() <= 1e-6
            elif isinstance(v, np.ndarray):
                assert np.array_equal(st[k], v), (i, k)
            else:
                assert st[k] == v, (i, k)


def test_perturbations_match_jax():
    """Colour and occlusion perturbations of an RGBA and an RGB frame
    (ImageDraw's rectangles, both corners inclusive) equal JAX's."""
    from PIL import Image
    rng = np.random.default_rng(1)
    rgba = frame(600, 1, rng)
    for img in (rgba, np.ascontiguousarray(rgba[..., :3])):
        for pert in (["color"], ["occ"], ["color", "occ"]):
            for seed in (1, 7):
                ref = np.asarray(jbl.add_perturbation(
                    Image.fromarray(img), pert, seed))
                got = tbl.add_perturbation(img, pert, seed)
                assert np.array_equal(got, ref), (img.shape, pert, seed)


def _configs(extra=()):
    argv = ["--data", "blender", "--model", "nerf", "--root_dir", "r",
            "--exp_name", "e", "--fc_layers", "4", "--fc_feat", "64",
            "--n_samples", "16", *extra]
    j = jopts.to_run_config(jopts.postprocess(
        jopts.train_parser().parse_args(argv)))
    tc = topts.to_run_config(topts.postprocess(
        topts.train_parser().parse_args(argv)), device=torch.device("cpu"))
    return j, tc


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_render_matches_jax(tmp_path, perturb):
    """render_rays on 256 rays of a blender image, both packages on the
    JAX package's draws for the same key."""
    import dataclasses as dc
    root = make_blender_dir(str(tmp_path), n_frames=1, splits=("val",))
    rays = tbl.BlenderDataset(root, "val", img_wh=(32, 32)).get_image(
        0)["rays"][::4]
    jc, tc = _configs()
    jr = dc.replace(jc.render, perturb=perturb)
    tr = dc.replace(tc.render, perturb=perturb)
    params, net = networks(jc.model, tc.model)
    key = jax.random.PRNGKey(5)
    ref = jrender.render_rays({"coarse": params}, jc.model, jr,
                              jrender.RenderInputs(
                                  rays=jnp.asarray(rays),
                                  cos_irra_on=jnp.asarray(False)), key)
    with torch.no_grad():
        got = trender.render_rays(
            net, tc.model, tr, trender.RenderInputs(
                rays=t(rays), cos_irra_on=torch.tensor(False)),
            draws=render_draws(key, jr, rays.shape[0],
                               jr.sun_march_count(16)))
    assert set(got) == set(ref) and "rgb_coarse" in got
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        close_slice(got[k], ref[k], rays.shape[0], k)


def _psnrs(run_dir):
    rows = [json.loads(ln) for ln in open(os.path.join(run_dir,
                                                       "scalars.jsonl"))]
    return [r["train/psnr"] for r in rows if "train/psnr" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' train CLIs on the same small blender directory (two
    48-px frames at --img_wh 32 32, 4 x 64, 128 steps)."""
    base = tmp_path_factory.mktemp("blender")
    root = make_blender_dir(str(base / "data"), n_frames=2)
    out = {}
    for side, fn in (("jax", jax_train_main), ("port", port_train_main)):
        argv = ["--data", "blender", "--model", "nerf", "--root_dir", root,
                "--img_wh", "32", "32", "--fc_layers", "4", "--fc_feat",
                "64", "--n_samples", "16", "--batch_size", "256", "--lr",
                "5e-3", "--max_train_steps", "128", "--eval_every_n_epochs",
                "4", "--save_visu_every_n_epochs", "8",
                "--save_first_n_visu", "0", "--exp_name", side,
                "--logs_dir", str(base / "logs"), "--ckpts_dir",
                str(base / "ckpts")]
        kw = {"device": "cpu"} if side == "port" else {}
        assert fn(argv, **kw) == 0
        out[side] = os.path.join(str(base / "logs"), side)
    return dict(out, root=root)


def test_train_clis_raise_psnr_and_write_the_same_panels(runs):
    jp, tp = _psnrs(runs["jax"]), _psnrs(runs["port"])
    print("train psnr, JAX", jp, "port", tp)
    assert jp[-1] > jp[0] and tp[-1] >= tp[0] + 3.0, (jp, tp)
    pngs = {side: sorted(f for f in os.listdir(runs[side])
                         if f.endswith(".png"))
            for side in ("jax", "port")}
    assert pngs["port"] == pngs["jax"]
    assert "val_1_epoch8.png" in pngs["port"], pngs
    assert "val_1_epoch4.png" not in pngs["port"], pngs
    panel = png.read_png(os.path.join(runs["port"], "val_0_epoch0.png"))
    assert panel.shape == (3 * 32 + 2 * 2, 32, 3)


def test_eval_writes_panels_equal_to_their_renders(runs, tmp_path):
    """The eval CLI scores the port's run and writes {src}_panels.png (a
    blender src_id holds its split's directory); each decodes to the
    panel stack of the render that load_renderer serves by index."""
    last = max(int(f.split("=")[1].split(".")[0]) for f in os.listdir(
        os.path.join(os.path.dirname(os.path.dirname(runs["port"])),
                     "ckpts", "port")) if f.endswith(".npz")
        and not f.endswith(".opt.npz"))
    res = teval(runs["port"], last, output_dir=str(tmp_path), device="cpu")
    assert np.isfinite(res["psnr"]) and np.isnan(res["mae"])
    r = tserve.load_renderer(runs["port"], last, device="cpu")
    assert len(r) == 2
    for i in range(2):
        s = r.get_image(i)
        out = r.render_image(i)
        path = os.path.join(str(tmp_path), f"{s['src_id']}_panels.png")
        want = viz.render_summary_panels(out, s["rgbs"], s["h"], s["w"])
        assert np.array_equal(png.read_png(path), want), path
