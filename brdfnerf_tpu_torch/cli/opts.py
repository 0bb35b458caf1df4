"""Flag definitions + opts.json round-trip (reference: opt.py:10-355), the
port's own copy of the JAX package's cli/opts.py, so a run directory written
by either package loads in the other.

Training dumps opts.json into the run directory; serving reloads it as the
source of truth (opt.py:349-351, eval.py:228-229).  Flag names and defaults
match the reference.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import (ModelConfig, RenderConfig, TrainConfig, RunConfig,
                      derive_nr_spv_type)
from ..models.network import grad_safe_cfg
from ..ops.fused_mlp import cuda_kernels_cover
from ..utils.device import resolve_device


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="brdfnerf_tpu_torch training")
    # paths (opt.py:127-151)
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--ckpts_dir", type=str, default="ckpts")
    p.add_argument("--logs_dir", type=str, default="logs")
    p.add_argument("--gt_dir", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--in_ckpts", type=str, default=None)
    p.add_argument("--exp_name", type=str, required=True)
    # core training (opt.py:152-184)
    p.add_argument("--gpu_id", type=int, default=1)
    p.add_argument("--model", type=str, default="spsbrdf-nerf",
                   choices=["nerf", "s-nerf", "sat-nerf", "sps-nerf",
                            "spsbrdf-nerf"])
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--img_downscale", type=float, default=1.0)
    p.add_argument("--max_train_steps", type=int, default=300000)
    p.add_argument("--save_ckpt_every_n_epochs", type=int, default=1)
    p.add_argument("--eval_every_n_epochs", type=int, default=1)
    p.add_argument("--scan_chunk", type=int, default=None,
                   help="dispatch N fused train steps per call (the "
                        "same trajectory; chunks clamp at epoch/phase "
                        "boundaries). 1 = one step per call; unset falls "
                        "back to $BRDFNERF_SCAN_CHUNK, then 1")
    p.add_argument("--fc_feat", type=int, default=512)
    p.add_argument("--fc_layers", type=int, default=8)
    p.add_argument("--n_samples", type=int, default=64)
    p.add_argument("--n_importance", type=int, default=0)
    p.add_argument("--noise_std", type=float, default=0.0)
    p.add_argument("--chunk", type=int, default=1024 * 5)
    p.add_argument("--data", type=str, default="sat",
                   choices=["sat", "blender"])
    # loss weights (opt.py:186-245)
    p.add_argument("--lambda_rgb", type=float, default=1.0)
    p.add_argument("--sc_lambda", type=float, default=0.0)
    p.add_argument("--ds_lambda", type=float, default=0.0)
    p.add_argument("--ds_drop", type=float, default=1.0)
    p.add_argument("--ds_noweights", action="store_true")
    p.add_argument("--first_beta_epoch", type=int, default=2)
    p.add_argument("--t_embbeding_tau", type=int, default=4)
    p.add_argument("--t_embbeding_vocab", type=int, default=30)
    p.add_argument("--beta", action="store_true")
    p.add_argument("--mapping", action="store_true")
    p.add_argument("--GNLL", "--gnll", dest="gnll", action="store_true")
    p.add_argument("--usealldepth", action="store_true")
    p.add_argument("--guided_samples", type=int, default=64)
    p.add_argument("--margin", type=float, default=0.0001)
    p.add_argument("--stdscale", type=float, default=1.0)
    p.add_argument("--corrscale", type=float, default=1.0)
    p.add_argument("--siren", type=int, default=1)
    # reference: type=int default=1 (opt.py:323); nargs='?' keeps the
    # bare --mod_alt_bound spelling working too
    p.add_argument("--mod_alt_bound", type=int, nargs="?", const=1,
                   default=1)
    p.add_argument("--sun_v", type=str, default="none",
                   choices=["none", "analystic", "learned"])
    p.add_argument("--indirect_light", action="store_true")
    p.add_argument("--normal", type=str, default="none",
                   choices=["none", "analystic", "learned",
                            "analystic_learned"])
    p.add_argument("--nr_reg_an_lambda", type=float, default=0.0)
    p.add_argument("--nr_reg_lr_lambda", type=float, default=0.0)
    p.add_argument("--nr_spv_lambda", type=float, default=0.0)
    p.add_argument("--nr_spv_type", type=int, default=0)
    p.add_argument("--hs_lambda", type=float, default=0.0)
    p.add_argument("--brdf_on", type=float, default=1.0)
    p.add_argument("--nrrg_on", type=float, default=0.0)
    p.add_argument("--cos_irra_on", type=float, default=1.0)
    p.add_argument("--gsam_only_on", type=float, default=1.0)
    p.add_argument("--gsam_only", action="store_true")
    # BRDF (opt.py:261-309)
    p.add_argument("--MultiBRDF", dest="multi_brdf", type=int, default=0)
    p.add_argument("--roughness", action="store_true")
    p.add_argument("--pretrain_normal", action="store_true",
                   help="parsed for script compatibility; inert in the "
                        "reference too (opt.py:305 has no consumer)")
    p.add_argument("--toyBRDF", dest="toy_brdf", action="store_true",
                   help="reference debug visualization (manual normal/"
                        "roughness in val images, main.py:557); parsed but "
                        "not implemented here")
    p.add_argument("--glossy_scale", type=float, default=1.0)
    p.add_argument("--fresnel_f0", "--f0", dest="f0", type=float,
                   default=0.04)
    p.add_argument("--shell_hapke", type=int, default=0)
    p.add_argument("--hpk_scl", type=float, default=4.0)
    p.add_argument("--b", dest="hapke_b", action="store_true")
    p.add_argument("--c", dest="hapke_c", action="store_true")
    p.add_argument("--B0", dest="hapke_b0", action="store_true")
    p.add_argument("--h", dest="hapke_h", action="store_true")
    p.add_argument("--theta", dest="hapke_theta", action="store_true")
    p.add_argument("--funcM", dest="func_m", type=int, default=0)
    p.add_argument("--funcF", dest="func_f", type=int, default=0)
    p.add_argument("--funcH", dest="func_h", type=int, default=0)
    p.add_argument("--dim_RPV", dest="dim_rpv", type=int, default=1)
    p.add_argument("--input_viewdir", type=int, default=0)
    # reflectance-encoder flags: parsed by the reference (opt.py:312-315)
    # but consumed NOWHERE in its model code — kept here with the same
    # parse-only behavior (postprocess defaults fc_feat_ref to fc_feat,
    # opt.py:334-335) so run scripts port unchanged
    p.add_argument("--fc_feat_ref", type=int, default=0)
    p.add_argument("--fc_layers_ref", type=int, default=0)
    p.add_argument("--eval", dest="eval_mode", type=int, default=0,
                   help="1 = load in_ckpts fully and freeze ALL parameters "
                        "(reference load mode (c), main.py:91-96)")
    # dataset details
    p.add_argument("--aoi_id", type=str, default="Dji_012")
    p.add_argument("--cs", type=str, default="utm", choices=["utm", "ecef"])
    p.add_argument("--inputdds", type=str, default="DenseDepth_ZM4")
    # reference default is "" with ".txt" appended in postprocess
    # (opt.py:343)
    p.add_argument("--infile_postfix", type=str, default="")
    p.add_argument("--scale", type=float, default=1.0 / 255.0)
    p.add_argument("--std_range", "--dRange", dest="std_range", type=float,
                   default=3.0)
    p.add_argument("--use_disp", action="store_true")
    p.add_argument("--img_wh", type=int, nargs=2, default=(400, 400))
    p.add_argument("--std_quirk", type=int, default=1,
                   help="reproduce the reference's zero-std GT-delta "
                        "guided sampling (satellite_rgb_dep.py:407-408)")
    p.add_argument("--normal_at_surface", action="store_true",
                   help="analytic normal once per ray at the expected "
                        "surface (deviates from the reference's per-sample "
                        "normals)")
    p.add_argument("--fast_sin", type=int, default=1,
                   help="polynomial siren activation (1.7e-5 abs err); "
                        "0 = exact sin for strict parity")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "bfloat16_all"],
                   help="matmul compute dtype (ModelConfig.compute_dtype). "
                        "'bfloat16' = bf16 operands with f32 "
                        "accumulation/activations; 'bfloat16_all' also "
                        "keeps activations bf16")
    p.add_argument("--fused_trunk", type=int, default=None,
                   help="fused trunk-with-gradient kernel for "
                        "analytic-normal configs (same semantics). "
                        "Default: on where the CUDA kernels cover the "
                        "config, off on the CPU")
    p.add_argument("--use_pallas", type=int, default=None,
                   help="fused trunk-sigma kernel for the sigma-only "
                        "passes; same device-dependent default")
    # visualization / logging cadence (opt.py:164-167,246-250,267-268,298)
    p.add_argument("--visu_scale", type=float, default=1.0,
                   help="brightness multiplier on rgb/gt/albedo panels")
    p.add_argument("--save_visu_every_n_epochs", type=int, default=1)
    p.add_argument("--save_file_every_n_epochs", type=int, default=-1)
    p.add_argument("--save_first_n_visu", type=int, default=0)
    p.add_argument("--TestNormal", dest="test_normal", type=int, default=0,
                   choices=[0, 1])
    p.add_argument("--TestSun_v", dest="test_sun_v", type=int, default=0,
                   choices=[0, 1])
    p.add_argument("--print_debuginfo", action="store_true",
                   help="enable the NaN-guard debug layer (utils.guards)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel devices (0 = single device; N "
                        "trains on N ranks, one process a GPU: NCCL on "
                        "CUDA, gloo on the CPU)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width T: the --n_devices ranks "
                        "form a (n_devices / T, T) (data, model) mesh and "
                        "each model group shares the trunk's layers "
                        "(needs --n_devices a multiple of T; K1-K5 off)")
    p.add_argument("--sharded_store", type=int, default=0, choices=[0, 1],
                   help="shard the device ray store over the mesh 'data' "
                        "axis (1/N of the rays + HBM per device, per-shard "
                        "stratified minibatch draws) instead of "
                        "replicating it; needs --n_devices > 1")
    p.add_argument("--scale_global_batch", type=int, default=0,
                   choices=[0, 1],
                   help="N-chip scaled-batch data parallelism: global "
                        "batch = batch_size * n_devices (per-device batch "
                        "stays at batch_size) with linear lr scaling")
    p.add_argument("--lr_warmup_steps", type=int, default=0,
                   help="linear lr warmup steps from lr/10 (0 = off, the "
                        "default; -1 = two epochs; positive = explicit "
                        "count)")
    p.add_argument("--sun_march_samples", type=int, default=0,
                   help="analytic sun-visibility march sample count: 0 = "
                        "reference intent (N_samples; rendering.py:251-253 "
                        "marches N_samples; the transparency is resampled "
                        "onto the final axis); -1 = the merged final count; "
                        "any positive int = explicit count")
    return p


def eval_parser() -> argparse.ArgumentParser:
    """The JAX package's eval flags and defaults (reference Test_parser,
    opt.py:10-29)."""
    p = argparse.ArgumentParser(description="brdfnerf_tpu_torch evaluation")
    p.add_argument("--run_id", type=str, default=None)
    p.add_argument("--logs_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--epoch_number", type=int, required=True)
    p.add_argument("--split", type=str, default="val",
                   help="'val' = train img 0 + test imgs; 'train' = render "
                        "every training image (eval.py:238-249)")
    p.add_argument("--infile_postfix", type=str, default="")
    p.add_argument("--checkpoints_dir", type=str, default=None)
    p.add_argument("--find_best_t", type=int, default=0,
                   help="search the t-embedding vocab per val image and "
                        "score with the best-PSNR index instead of the "
                        "predefined t=0 (eval.py:184-199,215); runs "
                        "with --beta carry the t-embedding")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16", "bfloat16_all", "int8"],
                   help="override the run's training compute_dtype for "
                        "this evaluation; 'int8' runs the (siren, mapped) "
                        "trunk's sigma passes as int8 products "
                        "(torch._int_mm), serving-only; the main pass's "
                        "per-sample analytic normals run on the "
                        "bfloat16_all twin")
    p.add_argument("--normal_at_surface", type=int, default=None,
                   help="override the run's normal_at_surface for this "
                        "evaluation (1/0)")
    p.add_argument("--sun_march_samples", type=int, default=None,
                   help="override the run's sun-visibility march sample "
                        "count for this evaluation (0 = reference intent "
                        "N_samples; -1 = merged final count, what "
                        "pre-knob runs trained with and what their "
                        "reloaded opts.json defaults to; positive = "
                        "explicit count)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="multi-GPU serving: a replica on each of the first "
                        "N devices, each chunk's rays split over them; 0 = "
                        "single device")
    return p


def postprocess(args: argparse.Namespace) -> argparse.Namespace:
    args.nr_spv_type = derive_nr_spv_type(args.normal, args.nr_spv_type)
    if args.sun_v != "learned":
        args.sc_lambda = 0.0                      # opt.py:339-341
    if not args.infile_postfix.endswith(".txt"):
        args.infile_postfix += ".txt"             # opt.py:343
    if getattr(args, "fc_feat_ref", 0) == 0:
        args.fc_feat_ref = args.fc_feat           # opt.py:334-335
    if getattr(args, "eval_mode", 0) and not args.in_ckpts:
        raise SystemExit(
            "--eval 1 requires --in_ckpts (main.py:91-92). If you meant "
            "the validation cadence, spell out --eval_every_n_epochs.")
    return args


def _backend_default(v, device, mcfg: ModelConfig) -> bool:
    """None -> the fused kernels are on when the run is on CUDA and the
    kernels cover the model (the analogue of the JAX package's
    accelerator-backend default); an int8 model's main pass runs on its
    bfloat16_all twin, whose cover decides (the sigma passes' int8 trunk
    refuses K1 per call, ops/fused_mlp.kernel_supports)."""
    if v is not None:
        return bool(v)
    return (torch.device(device).type == "cuda"
            and cuda_kernels_cover(grad_safe_cfg(mcfg)))


def to_run_config(args: argparse.Namespace, device=None) -> RunConfig:
    """The RunConfig of parsed flags for a run on `device`, which decides
    the fused kernels' default (None: CUDA, raising without it)."""
    device = resolve_device(device)
    mcfg = ModelConfig(
        variant=args.model, layers=args.fc_layers, feat=args.fc_feat,
        siren=bool(args.siren), mapping=bool(args.mapping),
        input_viewdir=bool(args.input_viewdir), beta=args.beta,
        t_embedding_vocab=args.t_embbeding_vocab,
        t_embedding_tau=args.t_embbeding_tau,
        sun_v=args.sun_v, indirect_light=args.indirect_light,
        normal=args.normal, roughness=args.roughness,
        func_m=bool(args.func_m), func_f=bool(args.func_f),
        func_h=args.func_h, dim_rpv=args.dim_rpv,
        hapke_b=args.hapke_b, hapke_c=args.hapke_c,
        hapke_theta=args.hapke_theta, hapke_h=args.hapke_h,
        hapke_b0=args.hapke_b0, shell_hapke=args.shell_hapke,
        hpk_scl=args.hpk_scl, glossy_scale=args.glossy_scale,
        fresnel_f0=args.f0, multi_brdf=bool(args.multi_brdf),
        fast_sin=bool(getattr(args, "fast_sin", 1)),
        compute_dtype=getattr(args, "compute_dtype", "float32"))
    brdf_requested = (args.roughness or args.func_m or args.func_f
                      or args.func_h or args.hapke_b or args.shell_hapke)
    rcfg = RenderConfig(
        n_samples=args.n_samples, n_importance=args.n_importance,
        guided_samples=args.guided_samples, use_disp=args.use_disp,
        noise_std=args.noise_std, std_range=args.std_range,
        stdscale=args.stdscale, margin=args.margin,
        apply_brdf=bool(brdf_requested and args.brdf_on < 1.0),
        apply_theta=bool(brdf_requested and args.brdf_on < 0.5),
        gsam_only=args.gsam_only,
        sun_march_samples=getattr(args, "sun_march_samples", 0),
        normal_at_surface=bool(getattr(args, "normal_at_surface", False)),
        fused_trunk=_backend_default(getattr(args, "fused_trunk", None),
                                     device, mcfg),
        use_pallas=_backend_default(getattr(args, "use_pallas", None),
                                    device, mcfg),
        use_sat_sun=(args.data == "sat"))
    tcfg = TrainConfig(
        lr=args.lr, batch_size=args.batch_size,
        max_train_steps=args.max_train_steps,
        lambda_rgb=args.lambda_rgb, sc_lambda=args.sc_lambda,
        ds_lambda=args.ds_lambda, ds_drop=args.ds_drop,
        ds_noweights=args.ds_noweights, gnll=args.gnll,
        usealldepth=args.usealldepth,
        nr_reg_an_lambda=args.nr_reg_an_lambda,
        nr_reg_lr_lambda=args.nr_reg_lr_lambda,
        nr_spv_lambda=args.nr_spv_lambda, nr_spv_type=args.nr_spv_type,
        lr_warmup_steps=getattr(args, "lr_warmup_steps", 0),
        hs_lambda=args.hs_lambda, first_beta_epoch=args.first_beta_epoch,
        brdf_on=args.brdf_on, nrrg_on=args.nrrg_on,
        cos_irra_on=args.cos_irra_on, gsam_only_on=args.gsam_only_on)
    return RunConfig(model=mcfg, render=rcfg, train=tcfg)


def dump_opts(args: argparse.Namespace, run_dir: str) -> str:
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "opts.json")
    with open(path, "w") as f:
        json.dump(vars(args), f, indent=2)
    return path


def load_opts(run_dir: str) -> argparse.Namespace:
    """eval.py:228-229: reload opts.json as the config source of truth."""
    with open(os.path.join(run_dir, "opts.json")) as f:
        d = json.load(f)
    # Back-compat: runs recorded before --sun_march_samples existed
    # trained (and validated) with the march at the merged final count —
    # today's spelling -1, NOT today's default 0 (= N_samples).  Filling
    # the legacy value here keeps their re-evaluation bit-true to the
    # behavior the checkpoint was trained with; fresh runs always dump
    # the key.
    d.setdefault("sun_march_samples", -1)
    return argparse.Namespace(**d)


def sat_config_from_opts(args: argparse.Namespace):
    """SatelliteConfig from a run's (re)loaded opts: one place for the
    dataset-affecting fields, so training, serving and evaluation build the
    dataset the run trained on (the JAX package's sat_config_from_opts)."""
    from ..data.satellite import SatelliteConfig
    return SatelliteConfig(
        root_dir=args.root_dir, img_dir=args.img_dir,
        depth_subdir=args.inputdds, aoi_id=args.aoi_id, cs=args.cs,
        img_downscale=args.img_downscale, scale=args.scale,
        corrscale=args.corrscale, stdscale=args.stdscale,
        margin=args.margin, mod_alt_bound=args.mod_alt_bound,
        infile_postfix=args.infile_postfix,
        cache_dir=args.cache_dir,
        std_quirk=bool(getattr(args, "std_quirk", 1)),
        load_depth=(args.model in ("sps-nerf", "spsbrdf-nerf")))
