"""Training CLI: python -m brdfnerf_tpu_torch.cli.train --model spsbrdf-nerf
--exp_name ... --root_dir ... (the JAX package's cli/train.py, with its
flags; reference main.py:694-736 semantics).

Dumps opts.json into logs_dir/exp_name (the layout the JAX package's eval
CLI reloads), trains with the Trainer loop on the card, writes
epoch={n}.npz checkpoints and their .opt.npz optimizer states.  Prints one
line saying which fused CUDA kernels the run uses, and why none where the
kernels do not cover the model.

--n_devices N (N >= 1) trains data-parallel on N ranks, one process a GPU
(parallel/mesh.run_ranks: rank 0 in this process, the others spawned; NCCL
on CUDA, gloo on the CPU); the visible devices are counted before the
dataset is read.  --sharded_store and --scale_global_batch act on a mesh,
as in the JAX package.  --tp T (tensor parallelism, parallel/tensor.py)
makes the N ranks a (N / T, T) (data, model) mesh: N must be a multiple
of T, checked before the dataset is read, and the run takes K1-K5 off
(its [kernels] line says why).
"""

from __future__ import annotations

import dataclasses as dc
import os
import sys
import time

from . import opts as opts_mod
from ..models.network import grad_safe_cfg, int8_trunk


def kernels_line(cfg, device, train: bool = True, tp: int = 1) -> str:
    """Which fused kernels the run launches, or why none: its train steps,
    or with train=False its renders (the serving instantiations, no
    backward); tp: the model axis of a tensor-parallel run."""
    from ..ops.fused_mlp import (CUDA_DTYPES, act_of, cuda_kernels_cover,
                                 kernel_cfg, layer_major, split_operands)
    m, r = cfg.model, cfg.render
    if tp > 1:
        return (f"[kernels] none: tensor parallelism (--tp {tp}) cuts every "
                "trunk layer over the model axis, and K1-K5 run all the "
                "trunk's layers in one launch, with no place for the "
                "all-reduce each layer pair needs, so the trunk runs "
                "Megatron's split in plain torch (parallel/tensor.py)")
    if device.type != "cuda":
        return ("[kernels] none: the run is on the CPU, where the kernels' "
                "plain PyTorch twins run in their place")
    # int8 serving: the sigma passes take the int8 trunk in K1's place,
    # and the main pass runs on the bfloat16_all twin (its kernels)
    int8 = m.compute_dtype == "int8"
    int8_sigma = int8_trunk(m)
    m = grad_safe_cfg(m)
    if m.variant != "spsbrdf-nerf":
        return (f"[kernels] none: the {m.variant} variant runs its trunk in "
                "plain torch, as the JAX package runs it without a Pallas "
                "kernel (apply_network)")
    if not cuda_kernels_cover(m):
        why = [w for w, bad in (
            (f"compute_dtype={m.compute_dtype!r}",
             m.compute_dtype not in CUDA_DTYPES),
            (f"skips {m.skips} with {m.layers} layers", len(m.skips) != 1
             or not 0 < m.skips[0] < m.layers or m.layers < 3)) if bad]
        return ("[kernels] none: the CUDA kernels do not cover this model ("
                + ", ".join(why) + "), so the run takes the unfused "
                "torch path (ROADMAP.md Queue 2)")
    used, notes = [], []
    if r.use_pallas and int8:
        used.append("no K1: the sigma-only passes run the trunk as int8 "
                    "products (torch._int_mm)" if int8_sigma else
                    "no K1: the sigma-only passes run the raw-xyz trunk at "
                    "bfloat16_all in plain torch (int8 needs the sine "
                    "encoding's bounded inputs)")
    elif r.use_pallas:
        used.append("K1 (the sigma-only passes)")
    fine = r.n_importance > 0
    analytic = m.normal in ("analystic", "analystic_learned")
    if r.fused_trunk and analytic and r.normal_at_surface:
        notes.append("no K2/K3: --normal_at_surface takes one analytic "
                     "normal a ray by autograd through the unfused trunk "
                     "(the JAX package's jax.grad)")
    elif r.fused_trunk and analytic:
        k23 = "K2 + K3" if train else "K2"
        if train:
            used.append("K2 + K3 (the differentiated trunk and its "
                        "backward)")
        else:
            used.append("K2 (the trunk with its sigma gradient)")
        if fine:
            used.append(f"{k23} twice a {'step' if train else 'chunk'}: "
                        "on the coarse and on the fine network "
                        "(--n_importance)")
        if os.environ.get("BRDFNERF_FUSED_HEADS"):
            if m.beta:
                used.append("BRDFNERF_FUSED_HEADS is set, but K4/K5 "
                            "refuse a t-embedding (--beta), so the heads "
                            f"stay on {k23}")
            elif m.roughness or m.uses_hapke:
                family = "Microfacet" if m.roughness else "Hapke"
                used.append(f"BRDFNERF_FUSED_HEADS is set, but K4/K5 take "
                            f"only the RPV(111) heads, so the {family} "
                            "heads stay on " + ("K2 + K3" if train
                                                else "K2"))
            elif r.apply_theta:
                used.append("BRDFNERF_FUSED_HEADS is set, but K4/K5 take "
                            "RPV without theta (--brdf_on 0.5 or more), so "
                            "the heads stay on "
                            + ("K2 + K3" if train else "K2"))
            else:
                used.append(("K4 + K5 in their place" if train
                             else "K4 in its place") + " where the flagship "
                            "head set runs (BRDFNERF_FUSED_HEADS; "
                            f"{heads_at(m, train)})")
    if not used:
        return "[kernels] none: " + ("; ".join(notes) or (
            "--use_pallas 0 and no fused trunk (--fused_trunk 0, or no "
            "analytic normals)"))
    how = (" (float32: each f32 product as three on its bf16 hi and lo "
           "terms)" if split_operands(m) else "")
    act = {"poly": "the polynomial sine", "sin": "the exact sine",
           "relu": "ReLU"}[act_of(m)]
    dtype = ("'int8' (the main pass on its bfloat16_all twin)" if int8
             else repr(m.compute_dtype))
    kc = kernel_cfg(m)
    family = "layer-major" if layer_major(kc) else "fused"
    width = f"width {m.feat}"
    if kc.feat != m.feat:
        width += f" (K1-K3 run at {kc.feat}, zero-padded)"
    if layer_major(kc):
        width += (" (K1-K3 launch one layer's product over a block of "
                  "points a kernel, ops/trunk_layers.py"
                  + (f"; an encoding of {m.xyz_in_dim} lanes"
                     if m.xyz_in_dim > 128 else "") + ")")
    return (f"[kernels] {family} CUDA kernels at {width}, compute_dtype="
            f"{dtype}{how}, {act}: " + "; ".join(used + notes))


def heads_at(m, train: bool = True) -> str:
    """Which family and width K4/K5 (K4 when serving) run a model at
    (fused_mlp.kernel_cfg, as K1-K3): "K4/K5 layer-major at 2048", "K4/K5
    at 128, zero-padded", "K4/K5 fused at 512"."""
    from ..ops.fused_mlp import kernel_cfg, layer_major
    kc, k = kernel_cfg(m), "K4/K5" if train else "K4"
    if layer_major(kc):
        return f"{k} layer-major at {kc.feat}"
    if kc.feat != m.feat:
        return f"{k} at {kc.feat}, zero-padded"
    return f"{k} fused at {kc.feat}"


def main(argv=None, device=None):
    """Train on CUDA unless `device` names another (the tests pass
    device='cpu'); with --n_devices N, on N ranks (on the CPU, N gloo
    ranks share it)."""
    from ..utils.device import resolve_device
    args = opts_mod.postprocess(opts_mod.train_parser().parse_args(argv))
    # fail fast, before dataset ingestion
    if args.tp > 1 and (not args.n_devices or args.n_devices % args.tp):
        raise SystemExit(
            f"--tp {args.tp} needs --n_devices set to a multiple of it "
            f"(got {args.n_devices})")
    if args.n_devices < 0:
        raise SystemExit(f"--n_devices {args.n_devices}: need 0 (one "
                         "device, no mesh) or N >= 1")
    device = resolve_device(device)
    run_dir = os.path.join(args.logs_dir, args.exp_name)
    if args.n_devices:
        from ..parallel.mesh import check_devices, run_ranks
        check_devices(args.n_devices, device)
        opts_mod.dump_opts(args, run_dir)
        return run_ranks(train_rank, args.n_devices, run_dir, device,
                         args=(args,), n_model=max(1, args.tp))
    opts_mod.dump_opts(args, run_dir)
    return _train(args, device)


def train_rank(mesh, args) -> int:
    """One rank of a --n_devices run, on mesh.device."""
    return _train(args, mesh.device, mesh)


def _train(args, device, mesh=None) -> int:
    main_rank = mesh is None or mesh.rank == 0

    def say(line):
        if main_rank:
            print(line, flush=True)

    run_dir = os.path.join(args.logs_dir, args.exp_name)
    cfg = opts_mod.to_run_config(args, device=device)
    say(kernels_line(cfg, device, tp=args.tp))
    if mesh is not None:
        say(f"[mesh] {mesh.n_data} data-parallel rank(s)"
            + (f" x {mesh.n_model} model-parallel" if mesh.n_model > 1
               else "") + f", {mesh.backend} on {device.type}")

    if args.print_debuginfo:
        from ..utils import guards
        guards.enable(True)

    from ..train import Trainer, TrainerPaths

    t0 = time.perf_counter()
    if args.data == "blender":
        from ..data.blender import BlenderDataset
        train_ds = BlenderDataset(args.root_dir, split="train",
                                  img_wh=tuple(args.img_wh))
        val_ds = BlenderDataset(args.root_dir, split="val",
                                img_wh=tuple(args.img_wh))
        n_imgs = int(train_ds.store["ts"].max()) + 1
    else:
        from ..data.satellite import SatelliteDataset
        sat_cfg = dc.replace(
            opts_mod.sat_config_from_opts(args),
            mod_alt_bound=bool(args.mod_alt_bound),
            sparse_depth=(args.model == "sat-nerf" and args.ds_lambda > 0))
        train_ds = SatelliteDataset(sat_cfg, split="train")
        val_ds = SatelliteDataset(sat_cfg, split="val")
        n_imgs = len(train_ds.train_files)
    say(f"[data] {train_ds.store['rays'].shape[0]} training rays from "
        f"{n_imgs} images, {len(val_ds)} validation images; ingested in "
        f"{time.perf_counter() - t0:.3f} s")
    depth_store = getattr(train_ds, "depth_store", None)
    if depth_store is not None:
        say(f"[data] {depth_store['rays'].shape[0]} keypoint "
            "rays (sat-nerf's keypoint depth store)")

    ckpts_dir = os.path.join(args.ckpts_dir, args.exp_name)
    paths = TrainerPaths(logs_dir=run_dir, ckpts_dir=ckpts_dir,
                         gt_dir=args.gt_dir, aoi_id=args.aoi_id)
    # --eval 1: load in_ckpts fully, freeze all parameters (the
    # reference's load mode (c), main.py:91-96 + opt.py:320)
    freeze = ["all"] if args.eval_mode else None
    trainer = Trainer(cfg, train_ds.store, paths, val_dataset=val_ds,
                      seed=args.seed, use_tb=args.tensorboard,
                      in_ckpts=args.in_ckpts, resume_from=args.ckpt_path,
                      freeze=freeze, test_sun_v=bool(args.test_sun_v),
                      depth_store=depth_store, visu_scale=args.visu_scale,
                      save_first_n_visu=args.save_first_n_visu,
                      save_visu_every_n_epochs=args.save_visu_every_n_epochs,
                      mesh=mesh, sharded_store=bool(args.sharded_store),
                      scale_global_batch=bool(args.scale_global_batch),
                      device=device)
    trainer.eval_chunk = args.chunk
    try:
        trainer.fit(eval_every_n_epochs=args.eval_every_n_epochs,
                    save_ckpt_every_n_epochs=args.save_ckpt_every_n_epochs,
                    scan_chunk=args.scan_chunk)
    finally:
        trainer.log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
