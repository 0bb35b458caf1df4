"""Host training loop: schedule gates, the per-phase step cache,
validation and checkpointing (counterpart of the JAX package's train.py).

A plain loop around one fused train step (parallel/train_step.
make_fused_train_step): the store lives on the device, and per step the
host uploads the (batch,) int32 index vector and nothing else; metrics
become Python floats only where they are logged.  The two gates that change
what the step computes (apply_brdf at brdf_on*max_steps, apply_theta at
2*brdf_on*max_steps, main.py:202-210) select among at most three step
functions, one per static phase; the other gates follow from the step
count inside the step.  scan_chunk > 1 runs N steps per call
(make_scan_train_step) with the same trajectory.

Validation renders full images through serve.render_image_rays (the block
render serving uses), then scores PSNR / SSIM and, with a GT directory, the
DSM MAE chain.  sat-nerf with depth supervision (ds_lambda > 0) and a
keypoint store draws a keypoint sub-batch each step from a second
device-resident store, whose rays the step renders a second time for the
keypoint depth loss.  Validation writes each image's panel stack
(utils/viz) as val_{idx}_epoch{epoch}.png on the JAX package's cadence.  A
store without a scene (the blender dataset) validates without the DSM
chain.

Data parallelism (mesh: a parallel/mesh.Mesh, one Trainer a rank): every
rank builds the same Trainer from the same seed and store, rank 0's
initial weights are broadcast, and each step takes the rank's block of the
global batch (the replicated store, or with sharded_store the rank's shard
of it, data/batcher.ShardedRayBatcher) and all-reduces the gradients
(parallel/train_step.py).  Rank 0 alone logs, validates and writes panels
and checkpoints.  scale_global_batch scales the batch and the learning
rate by the mesh's data width.

Tensor parallelism (a mesh whose model axis is larger than 1,
parallel/tensor.py): every rank builds (or resumes) the whole state, rank
0's whole weights are broadcast, and each rank keeps its blocks of the
trunk and of Adam's moments (tensor.shard_state); the render config takes
K1-K5 off.  At an epoch's end that validates or saves, the ranks of rank
0's model group gather the whole state (tensor.gather_state), and rank 0
validates and writes whole weights and moments in the npz layouts, so a
one-device run of either package reads them.
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import RenderConfig, RunConfig
from .data.batcher import DeviceRayBatcher, ShardedRayBatcher
from .geo import dsm as dsm_mod
from .metrics import masked_scores
from .parallel.train_step import (GateSchedule, TrainState,
                                  create_train_state, make_fused_train_step,
                                  make_render_step, make_scan_train_step)
from .serve import final_render_config, render_image_rays
from .utils import checkpoint as ckpt
from .utils import viz
from .utils.device import resolve_device


@dataclass
class TrainerPaths:
    logs_dir: str
    ckpts_dir: str
    gt_dir: Optional[str] = None
    aoi_id: str = ""


class ScalarLog:
    """JSONL scalar logger (+ TensorBoard when asked and it imports)."""

    def __init__(self, logs_dir: str, use_tb: bool = False):
        os.makedirs(logs_dir, exist_ok=True)
        self.f = open(os.path.join(logs_dir, "scalars.jsonl"), "a")
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(logs_dir)
            except ImportError:
                self.tb = None

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def log_image(self, step: int, tag: str, img_hw3_uint8):
        """TensorBoard image (main.py:680-685 add_images analog); no-op
        without a TB writer (the PNG on disk is always written)."""
        if self.tb is not None:
            self.tb.add_image(tag, img_hw3_uint8, step, dataformats="HWC")

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


class NullLog:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, step: int, scalars: Dict[str, float]):
        pass

    def log_image(self, step: int, tag: str, img_hw3_uint8):
        pass

    def close(self):
        pass


class Trainer:
    """The JAX package's Trainer on one device (CUDA unless `device`
    names another), or as one rank of a data-parallel mesh (on the mesh's
    device).  sharded_store (mesh only): shard the ray store over the
    ranks with per-shard draws (data/batcher.ShardedRayBatcher).
    scale_global_batch (mesh only): the global batch becomes batch_size *
    the mesh's width and the learning rate scales linearly with it
    (the JAX package's train.py:110-131)."""

    def __init__(self, cfg: RunConfig, train_store: Dict[str, np.ndarray],
                 paths: TrainerPaths, val_dataset=None,
                 mesh=None, seed: int = 0, use_tb: bool = False,
                 freeze: Optional[List[str]] = None,
                 in_ckpts: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 depth_store: Optional[Dict[str, np.ndarray]] = None,
                 visu_scale: float = 1.0,
                 save_first_n_visu: int = 0,
                 save_visu_every_n_epochs: int = 1,
                 test_sun_v: bool = False,
                 sharded_store: bool = False,
                 scale_global_batch: bool = False,
                 device=None):
        self.mesh = mesh
        # rank 0 (or the one device) logs, validates and checkpoints
        self.is_main = mesh is None or mesh.rank == 0
        self.cfg = cfg
        self.paths = paths
        self.val_dataset = val_dataset
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.log = (ScalarLog(paths.logs_dir, use_tb) if self.is_main
                    else NullLog())
        os.makedirs(paths.ckpts_dir, exist_ok=True)
        # the batch-scaling factor is the data axis's width: the model
        # axis shares one batch
        k = mesh.n_data if (scale_global_batch and mesh is not None) else 1
        if k > 1:
            cfg = dc.replace(cfg, train=dc.replace(
                cfg.train, batch_size=cfg.train.batch_size * k,
                lr=cfg.train.lr * k))
            self.cfg = cfg
            warm = cfg.train.lr_warmup_steps
            self._say(f"[mesh] scaled global batch: {cfg.train.batch_size} "
                      f"rays/step ({k} devices), lr -> {cfg.train.lr:.3e}"
                      + (f", lr warmup "
                         f"{'2 epochs' if warm == -1 else warm}"
                         if warm not in (0, -2) else ""))
        tcfg = cfg.train
        # observability guard: fitting hotspot-gated BRDF parameters on
        # geometry that never samples the hotspot leaves them at their
        # priors (the JAX package's inversion study)
        if "rays" in train_store:
            from .analysis import warn_unobservable_brdf_params
            warn_unobservable_brdf_params(train_store["rays"], cfg.model,
                                          once=True)
        batch_keys = [k for k in ("rays", "rgbs", "ts", "depths",
                                  "valid_depth", "depth_std", "normals",
                                  "valid_normal") if k in train_store]
        self.sharded_store = bool(sharded_store and mesh is not None)
        if sharded_store and not self.sharded_store:
            self._say("[mesh] sharded_store ignored: needs a mesh")
        arrays = {k: train_store[k] for k in batch_keys}
        if self.sharded_store:
            self.batcher = ShardedRayBatcher(arrays, tcfg.batch_size, mesh,
                                             seed=seed)
        else:
            self.batcher = DeviceRayBatcher(arrays, tcfg.batch_size,
                                            seed=seed, device=self.device,
                                            mesh=mesh)
        # sat-nerf's keypoint depth: a second batcher over the tie-point
        # store (the reference's second loader, main.py:177-183, at the
        # same batch size, or the store's size if smaller)
        self.depth_batcher = None
        if (depth_store is not None and tcfg.ds_lambda > 0
                and cfg.model.variant == "sat-nerf"):
            n_kp = depth_store["rays"].shape[0]
            kp_bs = min(tcfg.batch_size, n_kp)
            kp_store = {k: depth_store[k] for k in ("rays", "depths", "ts")}
            if mesh is not None:
                # the keypoint sub-batch splits over the ranks: tile a
                # store of fewer tie points than ranks up to one a rank
                # (the JAX package's train.py:186-200)
                n_dev = mesh.n_data
                if n_kp < n_dev:
                    reps = -(-n_dev // n_kp)
                    kp_store = {k: np.concatenate([v] * reps, 0)
                                for k, v in kp_store.items()}
                    kp_bs = n_dev
                else:
                    kp_bs = max(n_dev, kp_bs - kp_bs % n_dev)
            self.depth_batcher = DeviceRayBatcher(
                kp_store, kp_bs, seed=seed + 7, device=self.device,
                mesh=mesh)
        self.steps_per_epoch = self.batcher.steps_per_epoch
        self.max_steps = tcfg.max_train_steps
        # the tensor-parallel layout (None on one device or a 1-D mesh);
        # its steps and renders run without K1-K5
        from .parallel.tensor import kernels_off, state_shardings
        self.layout = state_shardings(mesh, cfg.model.skips)
        if self.layout is not None:
            cfg = dc.replace(cfg, render=kernels_off(cfg.render))
            self.cfg = cfg
        self._whole = None          # (step, the gathered whole state)

        self.state, self.opt = create_train_state(
            cfg.model, tcfg, self.steps_per_epoch, seed=seed,
            n_importance=cfg.render.n_importance, device=self.device,
            frozen=freeze)
        net = self.state.params
        if in_ckpts:
            if freeze and "all" in freeze:
                # --eval load mode (c): restore everything, all frozen
                # (main.py:91-96)
                include = None
            else:
                # two-stage handoff: trunk + sigma + feats (+ rgb unless
                # Hapke)
                include = ckpt.handoff_include(ckpt.NET_KEY,
                                               cfg.model.hapke_b)
            ckpt.restore_params(net, in_ckpts, include=include)
            if include is None:
                # freeze-all evaluation: every parameter must come from
                # the checkpoint, or frozen random heads score garbage
                ck_keys = set(ckpt.load_flat(in_ckpts))
                missing = [k for k in ckpt.params_to_flat(net)
                           if k not in ck_keys]
                if missing:
                    raise ValueError(
                        f"--eval in_ckpts {in_ckpts} is missing "
                        f"{len(missing)} parameters of this model config "
                        f"(e.g. {missing[:3]}); a freeze-all evaluation "
                        f"needs a checkpoint from the same config")
            self.state = TrainState(net, self.opt.init(net), 0)
            self._say(f"[handoff] restored {include or 'ALL'} from "
                      f"{in_ckpts}")
        if resume_from:
            ckpt.restore_params(net, resume_from)
            step = ckpt.checkpoint_step(resume_from)
            opt_state = self.opt.init(net)
            opt_path = resume_from.replace(".npz", ".opt.npz")
            if os.path.exists(opt_path):
                try:
                    ckpt.restore_opt_state(net, opt_state, opt_path)
                except ValueError as e:
                    print(f"[resume] optimizer state not restored: {e}")
            self.state = TrainState(net, opt_state, step)
            # the batcher resumes where the uninterrupted run stands, so
            # the resumed run draws that run's indices (the JAX Trainer
            # restarts its batcher's sequence here)
            for _ in range(step):
                self.batcher.next_indices()
                if self.depth_batcher is not None:
                    self.depth_batcher.next_indices()
            self._say(f"[resume] step {step} from {resume_from}")
        if mesh is not None:
            # the same initial weights on every rank: rank 0's
            mesh.broadcast_module(net)
        if self.layout is not None:
            from .parallel.tensor import shard_state, trunk_bytes
            whole = trunk_bytes(net)
            self.state = shard_state(self.state, self.opt, self.layout)
            self._say(f"[mesh] tensor parallelism: trunk sharded over "
                      f"{mesh.n_model} 'model' devices x {mesh.n_data} "
                      f"'data' ({trunk_bytes(self.state.params):,} of the "
                      f"trunk's {whole:,} parameter bytes a rank, and as "
                      "many again for its gradient and each Adam moment)")

        # schedule thresholds (fractions of max_steps, main.py:60-63)
        self.t_brdf = tcfg.brdf_on * self.max_steps
        self.t_theta = 2.0 * tcfg.brdf_on * self.max_steps
        self.t_nrrg = tcfg.nrrg_on * self.max_steps
        self.t_cos_irra = tcfg.cos_irra_on * self.max_steps
        self.t_gsam_only = tcfg.gsam_only_on * self.max_steps
        self.t_ds_drop = tcfg.ds_drop * self.max_steps

        self._step_fns: Dict = {}
        # each step's draws come from step_generator(seed + 1, step), as
        # the JAX package folds the step into PRNGKey(seed + 1)
        self._draw_seed = seed + 1
        self.eval_chunk = 16384          # --chunk (opt.py:182) analog
        self.test_sun_v = test_sun_v     # --TestSun_v (main.py:391)
        # visualization cadence (main.py:368-389): panels written for the
        # first N epochs and every save_visu_every_n_epochs afterwards
        self.visu_scale = visu_scale
        self.save_first_n_visu = save_first_n_visu
        self.save_visu_every_n_epochs = max(1, save_visu_every_n_epochs)

    # ---------------------------------------------------------- step fns

    def _static_phase(self, step: int):
        rcfg = self.cfg.render
        return (step > self.t_brdf and rcfg.apply_brdf,
                step > self.t_theta and rcfg.apply_theta,
                step > self.t_gsam_only and rcfg.gsam_only)

    def _gate_schedule(self) -> GateSchedule:
        return GateSchedule(
            t_cos_irra=float(self.t_cos_irra),
            t_ds_drop=float(self.t_ds_drop),
            t_nrrg=float(self.t_nrrg),
            steps_per_epoch=int(self.steps_per_epoch),
            first_beta_epoch=int(self.cfg.train.first_beta_epoch))

    def _get_step_fn(self, phase, scan: bool = False):
        """The step function of a static phase (a scan one: N steps per
        call), built once per phase."""
        key = ("scan", phase) if scan else phase
        if key not in self._step_fns:
            rcfg = dc.replace(self.cfg.render, apply_brdf=phase[0],
                              apply_theta=phase[1], gsam_only=phase[2])
            make = make_scan_train_step if scan else make_fused_train_step
            self._step_fns[key] = make(
                self.cfg.model, rcfg, self.cfg.train, self.opt,
                self._gate_schedule(),
                has_kp=self.depth_batcher is not None, mesh=self.mesh,
                store_sharded=self.sharded_store)
        return self._step_fns[key]

    def _say(self, line: str):
        """Print on rank 0 (or the one device) alone."""
        if self.is_main:
            print(line, flush=True)

    def _next_phase_change(self, step: int) -> int:
        """First step index > `step` at which a static phase gate flips: a
        scan chunk must not span it, because the step function changes
        there."""
        nxt = 10 ** 18
        rcfg = self.cfg.render
        for t, enabled in ((self.t_brdf, rcfg.apply_brdf),
                           (self.t_theta, rcfg.apply_theta),
                           (self.t_gsam_only, rcfg.gsam_only)):
            # a threshold whose render flag is off never changes the step
            # (_static_phase ANDs with the flag)
            if not enabled:
                continue
            flip = int(np.floor(t)) + 1
            if flip > step:
                nxt = min(nxt, flip)
        return nxt

    # ------------------------------------------------------------- train

    def fit(self, max_steps: Optional[int] = None,
            log_every: int = 100, eval_every_n_epochs: int = 1,
            save_ckpt_every_n_epochs: int = 1,
            progress: bool = True,
            scan_chunk: Optional[int] = None) -> Dict[str, float]:
        """Train to max_steps.  scan_chunk > 1 (or BRDFNERF_SCAN_CHUNK)
        runs N steps per call with the same index, draw and gate
        sequences; chunks clamp at epoch boundaries, static-phase changes
        and (when scan_chunk > log_every) multiples of log_every, so every
        log point gets its own row.  BRDFNERF_PROFILE=<dir> writes a
        torch.profiler chrome trace of steps start+10 .. start+20 there."""
        if self.cfg.model.compute_dtype == "int8":
            raise ValueError(
                "compute_dtype='int8' is serving-only: the quantizer's "
                "round() has zero gradient, so training would silently "
                "freeze the trunk. Train at float32/bfloat16* and pass "
                "--compute_dtype int8 to the eval CLI instead.")
        max_steps = max_steps or self.max_steps
        if scan_chunk is None:
            scan_chunk = int(os.environ.get("BRDFNERF_SCAN_CHUNK", "1"))
        t0 = time.perf_counter()
        last_metrics: Dict[str, float] = {}
        start = int(self.state.step)
        epoch = start // self.steps_per_epoch
        profile_dir = os.environ.get("BRDFNERF_PROFILE")
        prof_window = (start + 10, start + 20) if profile_dir else None
        prof = None
        if prof_window:
            scan_chunk = 1       # keep the trace's step <-> call mapping
        step = start
        first = True
        while step < max_steps:
            new_epoch = step // self.steps_per_epoch
            if new_epoch != epoch or first:
                if not first:
                    self._on_epoch_end(epoch, eval_every_n_epochs,
                                       save_ckpt_every_n_epochs)
                epoch = new_epoch
            first = False
            if prof_window and step == prof_window[0]:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            if prof_window and step == prof_window[1]:
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(profile_dir, f"trace_step{step}.json"))
                prof_window = None
            phase = self._static_phase(step)
            chunk = 1
            if scan_chunk > 1:
                chunk = min(scan_chunk, max_steps - step,
                            (epoch + 1) * self.steps_per_epoch - step,
                            self._next_phase_change(step) - step)
                if scan_chunk > log_every:
                    # chunks end exactly on each multiple of log_every, so
                    # the logged metrics are the logged step's own
                    m = ((step + log_every - 1) // log_every) * log_every
                    chunk = min(chunk, m - step + 1)
            store = self.batcher.store
            kp = self.depth_batcher
            if chunk > 1:
                def mat(b):
                    m = np.stack([b.next_local_indices()
                                  for _ in range(chunk)])
                    return torch.from_numpy(m.astype(np.int32)).to(
                        self.device, non_blocking=True)
                idx_mat = mat(self.batcher)
                kp_args = ({} if kp is None
                           else dict(kp_store=kp.store, kp_mat=mat(kp)))
                self.state, metrics = self._get_step_fn(phase, scan=True)(
                    self.state, store, idx_mat, self._draw_seed, **kp_args)
            else:
                kp_args = ({} if kp is None else dict(
                    kp_store=kp.store, kp_idx=kp.next_index_tensor()))
                self.state, metrics = self._get_step_fn(phase)(
                    self.state, store, self.batcher.next_index_tensor(),
                    self._draw_seed, **kp_args)
            end = step + chunk - 1       # the last step this call ran
            # log when the chunk holds a multiple of log_every (chunk=1:
            # step % log_every == 0); the only host sync of the loop
            if ((step - 1) // log_every != end // log_every
                    or end == max_steps - 1):
                metrics = {k2: float(v) for k2, v in metrics.items()}
                dt = time.perf_counter() - t0
                rays_s = ((end - start + 1) * self.cfg.train.batch_size) / dt
                metrics["rays_per_sec"] = rays_s
                self.log.log(end, {f"train/{k2}": v
                                   for k2, v in metrics.items()})
                if progress and self.is_main:
                    print(f"step {end:6d} epoch {epoch:3d} "
                          f"loss {metrics['loss']:.4f} "
                          f"psnr {metrics['psnr']:.2f} "
                          f"{rays_s:,.0f} rays/s", flush=True)
                last_metrics = metrics
            step = end + 1
        self._on_epoch_end(epoch, eval_every_n_epochs,
                           save_ckpt_every_n_epochs, final=True)
        if self.mesh is not None:
            # every rank leaves fit with rank 0's last checkpoint written
            self.mesh.barrier()
        return last_metrics

    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.paths.ckpts_dir, f"epoch={epoch}.npz")

    def _on_epoch_end(self, epoch: int, eval_every: int, save_every: int,
                      final: bool = False):
        """Cadences: every N epochs (N >= 1; epoch 0 included, like the
        reference's Lightning check_val_every_n_epoch), 0 = never during
        training (the final save and validation still run).  On a mesh,
        rank 0 alone validates and saves; under tensor parallelism the
        ranks of its model group gather the whole state for it first."""
        validate = self.val_dataset is not None and (
            (eval_every > 0 and epoch % eval_every == 0) or final)
        save = (save_every > 0 and epoch % save_every == 0) or final
        if (self.layout is not None and (validate or save)
                and self.mesh.data_rank == 0):
            from .parallel.tensor import gather_state
            whole = gather_state(self.state, self.layout)
            # rank 0 keeps it for validation, the checkpoint and
            # render_image; the other ranks only took part
            self._whole = (self.state.step, whole) if self.is_main else None
        if not self.is_main:
            return
        if validate:
            try:
                self.validate(epoch)
            except Exception as e:   # validation must never kill training
                traceback.print_exc()
                print(f"[val] failed at epoch {epoch}: {e}", flush=True)
        if save:
            path = self.checkpoint_path(epoch)
            net, opt, step = self.whole_state()
            ckpt.save_checkpoint(path, net, step=step)
            ckpt.save_opt_state(path.replace(".npz", ".opt.npz"), net, opt,
                                count=step)

    # -------------------------------------------------------------- eval

    def whole_state(self) -> TrainState:
        """The state with whole weights: self.state, or under tensor
        parallelism the one gathered at the last epoch end that validated
        or saved (fit's last one always does), on rank 0's model group."""
        if self.layout is None:
            return self.state
        if self._whole is None or self._whole[0] != self.state.step:
            raise ValueError("no whole state gathered at this step: the "
                             "ranks of rank 0's model group gather it at "
                             "an epoch end that validates or saves")
        return self._whole[1]

    def render_image(self, sample: Dict, chunk: Optional[int] = None,
                     rcfg: Optional[RenderConfig] = None,
                     t: int = 0) -> Dict[str, np.ndarray]:
        """A full image through serve.render_image_rays, by default in the
        final static phase (eval.py:383-384).  t: the transient-embedding
        index every ray takes; the default 0 is the reference's
        predefined_val_ts (main.py:416-417), eval's --find_best_t searches
        it (eval.py:184-199)."""
        if rcfg is None:
            rcfg = final_render_config(self.cfg, self.test_sun_v)
        return render_image_rays(self.whole_state().params, self.cfg, rcfg,
                                 sample["rays"], chunk or self.eval_chunk,
                                 self.device, t=t)

    def _save_cross_section(self, sample: Dict, epoch: int):
        """Mid-row diagnostic dump: z_vals / sigma / alpha / T for every
        pixel of the middle image row (main.py:567-595 analog)."""
        from .render.render import RenderInputs
        h, w = sample["h"], sample["w"]
        row = h // 2
        rays = sample["rays"][row * w:(row + 1) * w]
        fn = make_render_step(self.cfg.model, self.cfg.render)
        inp = RenderInputs(
            rays=torch.from_numpy(np.ascontiguousarray(rays)).to(self.device),
            ts=torch.zeros(rays.shape[0], dtype=torch.int64,
                           device=self.device),
            cos_irra_on=torch.tensor(False, device=self.device))
        gen = torch.Generator(device=self.device).manual_seed(0)
        res = fn(self.whole_state().params, inp, generator=gen)
        z = res["z_vals_coarse"].float().cpu().numpy()
        sig = res["sigmas_coarse"][..., 0].float().cpu().numpy()
        alpha = res["alphas_coarse"].float().cpu().numpy()
        trans = res["transparency_coarse"].float().cpu().numpy()
        path = os.path.join(self.paths.logs_dir, f"cross_epoch{epoch}.txt")
        with open(path, "w") as f:
            f.write("# col sample z sigma alpha transparency\n")
            for c in range(0, z.shape[0], max(1, z.shape[0] // 64)):
                for sidx in range(z.shape[1]):
                    f.write(f"{c} {sidx} {z[c, sidx]:.6f} {sig[c, sidx]:.6f}"
                            f" {alpha[c, sidx]:.6f} {trans[c, sidx]:.6f}\n")

    def validate(self, epoch: int) -> Dict[str, float]:
        ds = self.val_dataset
        t0 = time.perf_counter()
        all_scalars = {}
        for idx in range(len(ds)):
            s = ds.get_image(idx)
            out = self.render_image(s)
            h, w = s["h"], s["w"]
            is_val = s.get("is_val", True)
            if s.get("save_cross"):
                try:
                    self._save_cross_section(s, epoch)
                except Exception as e:
                    traceback.print_exc()
                    print(f"[val] cross-section dump failed: {e}")
            rgb = out.get("rgb_fine", out["rgb_coarse"]).reshape(h, w, 3)
            gt = s["rgbs"].reshape(h, w, 3)
            mask = s.get("mask")
            mval = (torch.from_numpy(mask.reshape(h, w, 1))
                    if mask is not None else None)
            # masked metrics are the primary scalars, the unmasked pair
            # alongside (main.py:604-607,668); scl at epoch 2
            # (main.py:603,668-672)
            sc = masked_scores(torch.from_numpy(rgb), torch.from_numpy(gt),
                               mval, scl=(epoch == 2), with_unmasked=True)
            p, sv = sc["psnr"], sc["ssim"]
            tag = "val" if is_val else "train_"
            scal = {f"{tag}/psnr_{idx}": p, f"{tag}/ssim_{idx}": sv,
                    f"{tag}/psnr_all_{idx}": sc["psnr_all"],
                    f"{tag}/ssim_all_{idx}": sc["ssim_all"]}
            if epoch == 2:
                print(f"[val] psnr_scl: {sc['psnr_scl']:.3f}, "
                      f"ssim_scl: {sc['ssim_scl']:.3f}"
                      f" | psnr_dif: {p - sc['psnr_scl']:.5f}"
                      f" ssim_dif: {sv - sc['ssim_scl']:.6f}")
            rep = None
            if self.paths.gt_dir and getattr(ds, "scene", None) is not None:
                depth = out.get("depth_fine", out["depth_coarse"])
                roi = dsm_mod.load_roi(self.paths.gt_dir, self.paths.aoi_id)
                dsm, prof = dsm_mod.dsm_from_depth(
                    s["rays"], depth, ds.scene, cs=ds.cfg.cs,
                    utm_zone=ds.utm_zone,
                    resolution=(float(roi[3]) if roi is not None else 0.5))
                if not is_val:
                    # train-image "fair MAE": Cloud2Grid NaN infill before
                    # diffing (main.py:624-629, sat_utils.py:299-313)
                    dsm = dsm_mod.interpolate_nans(dsm)
                rep = dsm_mod.mae_report(
                    dsm, prof, self.paths.gt_dir, self.paths.aoi_id,
                    out_dir=os.path.join(self.paths.logs_dir, "rdsm"),
                    src_id=s.get("src_id", str(idx)), epoch_number=epoch)
                scal[f"{tag}/mae_{idx}"] = rep.mae
                scal[f"{tag}/mae_nr_{idx}"] = rep.mae_nr
            save_visu = (epoch <= self.save_first_n_visu
                         or epoch % self.save_visu_every_n_epochs == 0)
            if save_visu:
                try:
                    # the panel stack (rgb/gt/depth + BRDF/normal/sun maps;
                    # the DSM diff panels on the fair-MAE train image,
                    # main.py:426-558,630-636)
                    fair = rep is not None and not is_val
                    panel = viz.render_summary_panels(
                        out, s["rgbs"], h, w,
                        diff=rep.diff if fair else None,
                        diff_nr=rep.diff_nr if fair else None,
                        visu_scale=self.visu_scale)
                    viz.save_png(os.path.join(
                        self.paths.logs_dir,
                        f"val_{idx}_epoch{epoch}.png"), panel)
                    self.log.log_image(int(self.state.step),
                                       f"{tag}/panels_{idx}", panel)
                except Exception as e:
                    traceback.print_exc()
                    print(f"[val] panel save failed: {e}", flush=True)
            all_scalars.update(scal)
        self.log.log(int(self.state.step), all_scalars)
        # masked convention only: psnr_all_* (unmasked) and *_scl stay out
        # of the printed mean
        vals = [v for k2, v in all_scalars.items()
                if k2.startswith("val/psnr_")
                and "all" not in k2 and "scl" not in k2]
        if vals:
            print(f"[val] epoch {epoch} mean psnr {np.mean(vals):.2f} "
                  f"({len(ds)} images in {time.perf_counter() - t0:.3f} s)",
                  flush=True)
        return all_scalars
