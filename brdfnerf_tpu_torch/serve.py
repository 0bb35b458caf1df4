"""Serving API: load a trained run and render images with it.

    from brdfnerf_tpu_torch.serve import load_renderer
    r = load_renderer(run_dir, epoch_number=40)        # on CUDA
    out = r.render_image({"rays": rays})               # rays (N, 11)
    out = r.render_image(0)                            # image 0 of the val split
    # out["rgb_coarse"], out["depth_coarse"], the per-ray panel maps, ...

`load_renderer` reads the run's opts.json and its epoch={n}.npz, or the
reference's epoch={n}.ckpt (the JAX package's contract, so a run trained by
either package, or by the reference, serves here).  `render_image` renders
in fixed-size chunks (opts `--chunk`, 5120 by default) through
`render_image_rays`, which the Trainer's validation renders through too:
the block render (parallel/train_step.render_blocks), or with
BRDFNERF_NO_SCAN_RENDER set, the chunk loop `render_in_chunks`.

    r = load_renderer(run_dir, 40, compute_dtype="int8")   # int8 trunk
    r = load_renderer(run_dir, 40, n_devices=2)            # two GPUs

compute_dtype="int8" runs the trunk's products of the sigma passes as int8
x int8 -> int32 (models/network._linear_int8), and the main pass's
differentiated trunk on the bfloat16_all twin (K2, or K4 with
BRDFNERF_FUSED_HEADS).  n_devices=N serves from one process with a replica
on each of the first N devices: each chunk's rays and draws split into N
contiguous blocks, rendered on their devices at the same time and gathered
(render_blocks).
"""

from __future__ import annotations

import copy
import dataclasses as dc
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import RunConfig
from .models.network import model_params
from .utils.device import resolve_device

# per-ray result keys returned verbatim (train.py:676-677)
PER_RAY_KEYS = ("rgb_coarse", "depth_coarse", "albedo_accu_coarse",
                "rgb_fine", "depth_fine")
# per-sample (N, S, C) fields reduced to per-ray maps: weighted sum along
# samples ('wsum') or plain mean ('mean', irradiance, main.py:446-449)
PANEL_ACCUM = {
    "albedo_coarse": "wsum", "sun_coarse": "wsum", "sky_coarse": "wsum",
    "normal_an_coarse": "wsum", "normal_lr_coarse": "wsum",
    "roughness_coarse": "wsum", "rpv_k_coarse": "wsum",
    "rpv_theta_coarse": "wsum", "rpv_rhoc_coarse": "wsum",
    "hpk_b_coarse": "wsum", "hpk_c_coarse": "wsum",
    "hpk_theta_coarse": "wsum", "beta_coarse": "wsum",
    "irradiance_coarse": "mean",
}


def final_render_config(cfg: RunConfig, test_sun_v: bool = False):
    """The RenderConfig of the final static phase, which serving and
    validation render with (eval.py:383-384 semantics: apply_brdf when
    brdf_on < 1, apply_theta when brdf_on < 0.5)."""
    return dc.replace(
        cfg.render,
        apply_brdf=cfg.train.brdf_on < 1.0 and cfg.render.apply_brdf,
        apply_theta=cfg.train.brdf_on < 0.5 and cfg.render.apply_theta,
        force_sun_march=cfg.render.force_sun_march or test_sun_v)


def render_in_chunks(net, cfg: RunConfig, rcfg, rays,
                     chunk: int, device: torch.device, seed: int = 0,
                     draws: Optional[Dict[str, torch.Tensor]] = None,
                     t: int = 0) -> Dict[str, np.ndarray]:
    """Render every ray of `rays` (N, 8|11) in chunks of `chunk` through
    `net` (a models.network.Params; a bare Network: the coarse one), padding the last by
    repeating its final ray: the per-ray rgb / depth plus the reduced panel
    maps, as numpy arrays.  Every chunk takes the same draws: `draws` (one
    chunk's, see render/render.py), else those of a generator seeded with
    `seed` anew for each chunk, as the JAX package renders every chunk with
    one key (train.py:586); every ray the transient embedding t."""
    from .parallel.train_step import make_render_step, reduce_panels
    from .render.render import RenderInputs
    step = make_render_step(cfg.model, rcfg)
    rays = np.asarray(rays, np.float32)
    n = rays.shape[0]
    cos_irra_on = torch.tensor(cfg.train.cos_irra_on < 1.0, device=device)
    ts = torch.full((chunk,), int(t), dtype=torch.int64, device=device)
    outs: Dict[str, List[np.ndarray]] = {}
    for i in range(0, n, chunk):
        part = rays[i:i + chunk]
        keep = part.shape[0]
        if keep < chunk:
            part = np.concatenate(
                [part, np.tile(part[-1:], (chunk - keep, 1))], 0)
        inp = RenderInputs(rays=torch.from_numpy(part).to(device), ts=ts,
                           cos_irra_on=cos_irra_on)
        gen = None
        if draws is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
        res = step(net, inp, draws=draws, generator=gen)
        for k in PER_RAY_KEYS:
            if k in res:
                outs.setdefault(k, []).append(
                    res[k][:keep].float().cpu().numpy())
        for k, acc in reduce_panels(res, PANEL_ACCUM).items():
            outs.setdefault(k, []).append(acc[:keep].float().cpu().numpy())
    return {k: np.concatenate(v, 0) for k, v in outs.items()}


def render_image_rays(net, cfg: RunConfig, rcfg, rays,
                      chunk: int, device: torch.device, seed: int = 0,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      t: int = 0, replicas=None) -> Dict[str, np.ndarray]:
    """Every ray of an image, as render_in_chunks returns them: through the
    block render by default, or, with BRDFNERF_NO_SCAN_RENDER set to
    anything truthy, through the chunk loop (the JAX package's
    Trainer.render_image switch).  replicas: [(device, net)] of a
    multi-device server (more than one: each chunk split over them; the
    chunk loop is then the block render one chunk a block)."""
    loop = os.environ.get("BRDFNERF_NO_SCAN_RENDER", "") not in ("", "0")
    split = replicas is not None and len(replicas) > 1
    if loop and not split:
        return render_in_chunks(net, cfg, rcfg, rays, chunk, device, seed,
                                draws, t)
    from .parallel.train_step import render_blocks
    return render_blocks(net, cfg.model, rcfg, rays, chunk, device,
                         cfg.train.cos_irra_on < 1.0, PER_RAY_KEYS,
                         PANEL_ACCUM, seed=seed, draws=draws, t=t,
                         block=1 if loop else None,
                         replicas=replicas)


@dc.dataclass
class Renderer:
    """A trained run loaded for rendering.  `cfg` is the RunConfig in use
    (serving overrides applied), `net` the restored parameters on `device`
    (a models.network.Params).
    render_image takes a sample dict, or an index into the run's `split`
    ('val': training image 0 and the test images; 'train': every training
    image), whose dataset is built from opts.json at the first such
    call.  replicas: [(device, params)] of a multi-device server, the
    first being (device, net)."""
    args: object
    cfg: RunConfig
    net: torch.nn.Module
    device: torch.device
    chunk: int = 5120
    seed: int = 0
    test_sun_v: bool = False
    split: str = "val"
    replicas: Optional[list] = dc.field(default=None, repr=False)
    _dataset: object = dc.field(default=None, repr=False)

    @property
    def dataset(self):
        """The split's dataset: a SatelliteDataset (sat_config_from_opts),
        'val' or 'train_render' for split='train' (eval.py:238-249); or for
        --data blender the BlenderDataset of the 'val' or 'train' frames."""
        if self._dataset is None and self.args.data == "blender":
            from .data.blender import BlenderDataset
            self._dataset = BlenderDataset(
                self.args.root_dir,
                split=("train" if self.split == "train" else "val"),
                img_wh=tuple(self.args.img_wh))
        if self._dataset is None:
            from .cli.opts import sat_config_from_opts
            from .data.satellite import SatelliteDataset
            self._dataset = SatelliteDataset(
                sat_config_from_opts(self.args),
                split=("train_render" if self.split == "train" else "val"))
        return self._dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def get_image(self, idx: int) -> Dict:
        return self.dataset.get_image(idx)

    def render_config(self):
        """The final static phase (eval.py:383-384 semantics)."""
        return final_render_config(self.cfg, self.test_sun_v)

    def render_image(self, sample, t: int = 0,
                     draws: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, np.ndarray]:
        """Render every ray of `sample["rays"]` (N, 8|11), or of image
        `sample` of the split: per-ray rgb / depth plus the weighted-sum
        panel maps, as numpy arrays (render_image_rays).

        t: transient-embedding index every ray takes (0: the reference's
        predefined_val_ts, main.py:416-417)."""
        if isinstance(sample, (int, np.integer)):
            sample = self.get_image(int(sample))
        return render_image_rays(self.net, self.cfg, self.render_config(),
                                 sample["rays"], self.chunk, self.device,
                                 self.seed, draws, t, self.replicas)


def load_renderer(run_dir: str, epoch_number: int,
                  checkpoints_dir: Optional[str] = None,
                  split: str = "val",
                  compute_dtype: Optional[str] = None,
                  normal_at_surface: Optional[bool] = None,
                  sun_march_samples: Optional[int] = None,
                  output_dir: Optional[str] = None,
                  n_devices: int = 0,
                  device=None) -> Renderer:
    """Reload a run's opts.json (eval.py:228-229) and restore its epoch={n}
    checkpoint (.npz, or the reference's .ckpt) into a Renderer on `device`
    (CUDA unless the caller names another; without CUDA and without a
    device this raises).

    split: 'val' = train img 0 + test imgs; 'train' = every training
    image (eval.py:238-249).  output_dir: where the CLIs write (created;
    the run directory by default).  Overrides as the eval CLI:
    compute_dtype (int8: the serving-only int8 trunk), normal_at_surface,
    sun_march_samples.  n_devices >= 1: a replica on each of the first
    n_devices devices (refused above the visible count; on the CPU,
    n_devices replicas share it), each chunk split over them."""
    from .cli import opts as opts_mod
    from .parallel.mesh import serving_devices
    from .utils import checkpoint as ckpt

    dev = resolve_device(device)
    # refuse a mesh wider than the visible devices before any reading
    devs = serving_devices(n_devices, dev) if n_devices else [dev]
    dev = devs[0]
    args = opts_mod.load_opts(run_dir)
    if compute_dtype:
        allowed = ("float32", "bfloat16", "bfloat16_all", "int8")
        if compute_dtype not in allowed:
            raise ValueError(f"compute_dtype={compute_dtype!r} not in "
                             f"{allowed}")
        args.compute_dtype = compute_dtype
    cfg = opts_mod.to_run_config(args, device=dev)
    if normal_at_surface is not None:
        cfg = dc.replace(cfg, render=dc.replace(
            cfg.render, normal_at_surface=bool(normal_at_surface)))
    if sun_march_samples is not None:
        cfg = dc.replace(cfg, render=dc.replace(
            cfg.render, sun_march_samples=int(sun_march_samples)))

    ckpts_dir = checkpoints_dir or os.path.join(args.ckpts_dir,
                                                args.exp_name)
    # the run's parameter structure: the fine network with n_importance >
    # 0, the t table with beta (the JAX package's Trainer template)
    net = model_params(cfg.model, cfg.render.n_importance, device=dev)
    ckpt.restore_params(net, ckpt.resolve_epoch_ckpt(ckpts_dir,
                                                     epoch_number))
    net.requires_grad_(False)
    replicas = [(d, net if d == dev else copy.deepcopy(net).to(d))
                for d in devs]
    os.makedirs(output_dir or run_dir, exist_ok=True)
    return Renderer(args=args, cfg=cfg, net=net, device=dev,
                    chunk=int(getattr(args, "chunk", 5120) or 5120),
                    test_sun_v=bool(getattr(args, "test_sun_v", 0)),
                    split=split,
                    replicas=replicas if len(replicas) > 1 else None)
