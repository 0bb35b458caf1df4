"""Smoke run of the port on one NVIDIA GPU: build the CUDA kernels from the
checkout's sources, hold each against its plain PyTorch twin at the main
paths' shapes, then serve and train the flagship spsbrdf-nerf model through
the port's own entry points and check what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught; a step-check
comparison that misses its bound is reported at the end of the run, after
every phase has run, and the run exits 1; each phase prints the seconds
the one before it took):
  1. device   - require CUDA; print the card's name and power limit
  2. build    - nvcc for sm_90a, one process per kernel library (five
                sources, each for the polynomial sine, the exact sine and
                ReLU; each also at the widths 64, 128 and 256, and at 64
                for the exact sine and ReLU), all in parallel; each
                library's nvcc seconds, and
                registers, spills and stack frames of every kernel function
                (ptxas -v)
  3. kernels  - K1 (trunk + sigma, split f32 products) at 327,680 and
                65,536 points (the serving and training passes) and K2
                (trunk + sigma gradient) at 655,360 points, the serving
                shape; K2 saving zs/us and K3 (the trunk's second-order
                backward) at 131,072 points, the training step's, and K2,
                K4, K1 (with and without feats) and K3, K5 (on 5 draws)
                again at 192 points (3 tiles: no multiple of a split or a
                wave); bfloat16_all with the polynomial sine, each against
                its twin, every instantiation of K1, K2 and K4 launched
                twice with bit-identical outputs; times of kernel, twin and
                a chain of torch.matmul calls for the same products (K1:
                hi and lo chains summed, its fidelity, and one bf16 chain),
                and of K3's and K5's kernel functions (K5's b_th chain,
                sweep, weight gradients, reduce); the sigma head's bias
                gradient held to 1e-2 of its terms' L2 norm (DBSIG_BOUND)
  4. serving  - a run directory from the port's train_parser / dump_opts and
                a seeded init_network / save_checkpoint, then
                load_renderer(device="cuda") answers 3 requests of 16,384
                rays at chunk 5120; launch counts checked per chunk
  5. check    - outputs finite and of the expected shapes, and a 1,024-ray
                render through the kernels on the card against the same
                render through the plain twins on the CPU
  6. training - the flagship stage-2 step (create_train_state,
                DeviceRayBatcher, make_fused_train_step) on a 16 x 1,024-ray
                synthetic store: 3 warm-up steps, then timed steps with
                launch counts per step and a falling loss; one step profiled
  7. step check - one step's parameter gradients on 128 rays through the
                kernels on the card against the same step through the twins,
                on the card and on the CPU, at the weights after each of the
                last 4 timed steps (the last: after all of them); at every
                point the backward kernel held to its twin on all 128 rays,
                and every comparison held to its bound on the rays whose
                gradient the bf16 contract determines (rpv_ill_conditioned,
                read from the twins on the CPU, at least half of them)
With BRDFNERF_FUSED_HEADS set in-process (the flagship head block inside
the kernel pair, ops/fused_trunk_heads.py):
  3b. kernels - K4 (trunk + heads) at the serving shape without zs and at
                the training shape with zs, K5 (its backward, rebuilding the
                u chain from zs) at the training shape, twice, each against
                its twin, and K5's rebuilt chain against the twin's
  5b. serving, fused heads - the same 3 requests; launches K1 2, K4 1 per
                chunk, and a 1,024-ray render against the CPU twins
  6b. training, fused heads - the same stage-2 step; launches K1 2, K4 1,
                K5 1 per step, a falling loss; one step profiled
  7b. step check, fused heads - one step's gradients, every parameter, at
                the weights after this run's last 4 timed steps, held as
                in 7
At compute_dtype float32, the CLIs' default (every product of f32
operands as three on bf16 tensor cores), and bfloat16 (f32 zs/us):
  3c. kernels, float32 - K1 at 327,680 and 65,536 points, K2 and K4 at
                655,360, K2 saving zs/us, K3, K4 saving zs and K5 at
                131,072, each twice bit-identical and held to its exact-f32
                twin at 1e-4 relative L2 and ten (K4/K5: a hundred) times
                closer than the bfloat16_all kernel on the same inputs
                (tools/f32_check.py; K4/K5 also to their split twins); then
                at 192, 640 and 8,448 points; the bfloat16 instantiations
                (K2 -> K3, K4 -> K5 on f32 zs/us) against their twins at the
                training shape and at 192 points; times of kernel, twin and
                the f32 (bf16) torch.matmul chain
  3d. kernels, activations - every instantiation built for the exact sine
                and for ReLU at every dtype: tools/act_check.py at 8,448
                points, then each at the main shapes twice bit-identical,
                against its twin and timed (act_kernels); every K3/K5
                sweep, each activation and dtype, twice bit-identical at
                131,072 points
  5c. serving, float32 - the 3 requests: K1 2, K2 1 per chunk; a 1,024-ray
                render against the CPU twins at a tenth of the bf16 bounds
  6c. training, float32 - the stage-2 step (launches K1 2, K2 1, K3 1, a
                falling loss, one step profiled), then the same step with
                the fused kernels off (the unfused f32 autograd path)
  7c. step check, float32 - as 7 at a tenth of its bounds, the rays set
                aside by the f32 contract's normal error
  6d. training, bfloat16 - 4 steps with the switch off (K2, K3) and on
                (K4, K5), on f32 zs/us
  5e/6e/7e. float32 with the switch on - one request (K1 2 / K4 1 per
                chunk) against the CPU twins at a tenth of the bf16 bounds,
                the stage-2 step (K1 2 / K4 1 / K5 1 a step, a falling
                loss) and one step-check point at the float32 bounds
  6f. serving and training at the exact sine and at ReLU - per
                activation: one request with the switch off and on at
                bfloat16_all and at float32, the stage-2 step off and on
                (bfloat16_all: 10 timed steps and a falling loss; float32
                and bfloat16: 2), launch counts per chunk and step
With the switch unset again:
  8. workflow - the two-stage workflow through the port's train CLI
                (cli/train.main) at the flagship's width on the port's
                synthetic AOI (build_aoi, 256 px: 2 train + 1 test image,
                128 steps an epoch at batch 1,024): stage 1 (128 steps),
                stage 2 handed off from stage 1's last epoch=N.npz (128
                steps, the flagship heads), a resume of stage 2 for 2 steps,
                16 stage-2 steps with --scan_chunk 8 against 16 with
                --scan_chunk 1, and 16 stage-2 steps with no --compute_dtype
                (float32: its [kernels] line names K1 and K2 + K3), again
                with --fast_sin 0 and with --siren 0 (the line names the
                activation too); launches
                per step held (K1 in stage 1; K1,
                K2 and K3 in stage 2; validation's apart), losses falling,
                checkpoints at the cadence (stage 2's with the RPV heads),
                finite validation psnr / ssim / DSM MAE for every validation
                epoch, the resume's step, Adam count and learning rate, the
                scan's per-step losses; the AOI build, ingestion and
                validation times, fit's rays/s and the device's busy share
                over the loop printed
  9. eval     - the evaluation side through the port's CLIs on stage 2's
                run: cli/eval.main on its last checkpoint (launches K1 2 and
                K2 1 per chunk, 26 chunks; the files the JAX CLI writes;
                PSNR / SSIM / MAE against the stage's last validation of the
                same weights, within 1e-4 dB / 1e-5 / 1e-5 m), the same
                weights under the flagship's brdf_on 0.5 (RPV without theta)
                with BRDFNERF_FUSED_HEADS off and on (K1 2 and K4 1 per
                chunk; 0.5 dB / 0.02 / 0.05 m apart), convert_ckpt npz -> ckpt -> npz (bit-equal; the
                .ckpt scores the same), one image through the block render
                against the chunk loop (BRDFNERF_NO_SCAN_RENDER; outputs
                bit-identical; wall time, rays/s, device-to-host copies and
                host waits of each), create_dsm (a DSM, a finite MAE) and
                brf_probe --param_probe (33 finite rows); the eval CLI on
                the float32 stage-2 run (K1 2 and K2 1 per chunk, its
                [kernels] line at float32)
The BRDF families and the variants (before phase 8):
 10. family, hapke / family, microfacet - the flagship's configuration with
                the family's heads in place of RPV(111) (Hapke: --b --c
                --theta --brdf_on 0; Microfacet: --roughness), at
                bfloat16_all and at float32: one request (K1 2 / K2 1 a
                chunk) against the CPU twins at the bounds of 5 (float32:
                5c), the stage-2 step (K1 2 / K2 1 / K3 1 a step over
                FAMILY_STEPS timed steps, a falling loss, one step
                profiled), one step with BRDFNERF_FUSED_HEADS set (K4 and
                K5 launch 0: they take the RPV(111) heads alone), one
                step-check point as 7 (7c at float32) on the rays that
                brdf_ill_conditioned leaves (the family's BRDF read by
                autograd on the CPU twins); Hapke also 4 stage-1 steps with
                --shell_hapke 3 (K1 1 / K2 1 / K3 1: no sun march in stage 1)
 11. variants - nerf, s-nerf, sat-nerf and sps-nerf (beta off; the
                learned sun and its solar-correction loss where the variant
                has them) at 8 x 512 and float32: one request against the
                CPU twins (256 rays) and VARIANT_STEPS steps on a one-batch
                store (the loss falls), K1-K5 launching 0 (the JAX package
                runs these trunks without a Pallas kernel); then spsbrdf-nerf
                with --sun_v learned (bfloat16_all): a request (K1 1 / K2 1 a
                chunk) and 4 steps (K1 1 / K2 1 / K3 1: the learned head
                replaces the sun march; the solar-correction pass is plain
                torch)
 11b. variants, defaults - the variants at their own defaults, 8 x 512 at
                float32 unless noted, each a request (K1-K5 launches per
                chunk, against the CPU twins on 256 rays at the float32
                bounds, the fine keys too) and WARM_STEPS + VARIANT_STEPS
                steps on a one-batch store (launches per step, the loss
                falls): spsbrdf-nerf with --n_importance 64 (K1 2 / K2 2 /
                K3 2 a step, K1 2 / K2 2 a chunk; with BRDFNERF_FUSED_HEADS
                K1 2 / K4 2 / K5 2; one step-check point at float32, every
                gradient held, and one at bfloat16_all, the fine network's
                gradients printed but held only in the backward kernel's
                comparison), with --beta (K1 2 / K2 1 / K3 1; K4/K5 0 with
                the switch; a request at t = 3 differs from t = 0 in beta),
                with --MultiBRDF 1, with --normal_at_surface (K2/K3 0),
                with --noise_std 1; sat-nerf --beta with the keypoint
                store of build_aoi(with_keypoints=True) and --ds_lambda 10
                (no kernel; a finite nonzero kp_ term; a step's host
                traffic with and without the store) and sps-nerf --beta;
                the phase's seconds
After phase 9:
 12. workflow, hapke / workflow, microfacet - each family's two-stage
                workflow through the train CLI on its shaded AOI
                (build_aoi(size=256, bumpy=True, brdf=HAPKE_GT |
                MICROFACET_GT)), FAMILY_WF_STEPS steps a stage, launches of
                steps and validation held, the [kernels] lines, falling
                losses, checkpoints with the family's heads; then the eval
                CLI on stage 2 (K1 52 / K2 26), its PSNR, SSIM and DSM MAE
                finite and printed
The trunk widths (before phase 6):
 13. widths - K1-K5 built for the widths 64, 128 and 256
                (tools/width_check.py: at 192 and 8,448 points, every dtype,
                8 layers with the skip at 4, and 4 with it at 2 at 64, the
                exact sine and ReLU at 64; each twice bit-identical and
                held to its twin at the bounds of the width-512 rows, K4's
                sigma and gx bit for bit K2's, K5's rebuilt b_th chain and
                head partials); per width every instantiation held so
                again at its main shape, where each block runs several
                tiles, and timed there (a row each in the kernels line);
                then at bfloat16_all and float32 the unfused stage-2 step
                first and a request (K1 2 / K2 1 a chunk), at those and
                bfloat16 a request with BRDFNERF_FUSED_HEADS set (K1 2 /
                K4 1 a chunk), each against the CPU twins, the fused step
                (K1 2 / K2 1 / K3 1) and the fused-heads step (K1 2 / K4 1
                / K5 1; WIDTH_STEPS timed, a falling loss; bfloat16
                WIDTH_SHORT), and at bfloat16_all a step-check point of
                each
 13b. widths, layer-major - K1-K3 where the fused kernels do not take
                the shape (ops/trunk_layers.py, csrc/trunk_layers.cu: a
                width past 512 or an encoding over 128 lanes) and the
                fused family at a zero-padded width: the libraries' nvcc
                seconds; every instantiation at every dtype against its
                twin, twice bit-identical (width_check.check_layers: 12 x
                2048 on LAYER_POINTS points, 4 x 768 at the exact sine and
                ReLU, a 144-lane encoding at 4 x 128 and 8 x 128 and
                width 96, at the
                512 rows' bounds times sum_length_scale); the 12 x 2048
                rows at their main shapes (bfloat16_all; the float32
                step's K2 saving zs/us and K3), timed; then the 12 x 2048
                flagship trunk on the card: a 16,384-ray request (K1L 2 /
                K2L 1 a chunk) against the CPU twins, the stage-2 step at
                bfloat16_all (K1L 2 / K2L 1 / K3L 1, LAYER_SHORT timed, a
                falling loss) and a step-check point on its weights,
                LAYER_CHECK_RAYS rays, against the twins on the card (the
                bf16 bounds times sum_length_scale);
                LAYER_SHORT float32 steps and a step-check point on
                their weights at the float32 bounds (also against the
                unfused step on the card); a request and steps at width
                96 (the fused kernels at 128; the request against the CPU
                twins) and at a 144-lane encoding (every K1 and K2 call
                of the request held to its twins on its own inputs:
                held_on_inputs); then with BRDFNERF_FUSED_HEADS set the
                layer-major K4/K5: the 12 x 2048 rows of K4, K4
                saving zs and K5 (bfloat16_all and float32), a request
                (K1L 2 / K4L 1 a chunk) against the CPU twins, LAYER_SHORT
                bfloat16_all steps (K1L 2 / K4L 1 / K5L 1, a falling loss,
                peak memory, one profiled) and a step-check point against
                the twins on the card, LAYER_SHORT float32 steps and their
                step-check point; at width 96 (the fused pair at 128) and
                at 144 lanes (every K1 and K4 call held on its own inputs)
                a request and LAYER_SHORT steps each; the phase's seconds
After phase 12:
 14. workflow, width 64 - stage 1 and stage 2 through the train CLI at
                --fc_feat 64 (the [kernels] line names the width), the eval
                CLI on stage 2 (K1 52 / K2 26); stage 2 again with
                BRDFNERF_FUSED_HEADS set at --brdf_on 0.5 (the line names
                K4 + K5; K2 / K3 before the BRDF's first step, K4 / K5
                after), the eval CLI on it (K1 52 / K4 26)
After phase 14:
 15. blender, host data - the reference's data and output paths without
                PIL or cv2, no kernel (every count 0): a scene in lego's
                layout (data/synth_blender.py; BLENDER_SCENE's 20 train, 2
                val and 2 test frames of 800 x 800 RGBA, cut from lego's
                100 / 100 / 200), written by utils/png with every filter
                type; the host C unfilter against its NumPy twin on every
                frame; the train CLI at --data blender --model nerf (8 x
                512 ReLU, positional encoding, 64 samples, batch 1,024,
                --img_wh 400 400; BLENDER_STEPS steps, PSNR up by
                BLENDER_PSNR_GAIN dB) with its validation panels; 16,384-ray
                requests, and 1,024 rays of a val image against the CPU
                twin at the serving bounds of 5; the eval CLI, each panel
                decoding to its array; then generate_dataset on full scenes
                of a synthetic AOI (write_full_scenes), footprint masks, the
                train CLI at --img_downscale 2 (SAT_STEPS steps; the store's
                size from the JAX formulas) and the eval CLI with panels;
                ingestion seconds, train and request rays/s printed
After phase 9 (before 12):
 16. serving, int8 - the flagship run's request 0 at --compute_dtype int8
                (load_renderer(compute_dtype="int8")) with
                BRDFNERF_FUSED_HEADS off and on, timed in turns with the
                bfloat16_all request (bf16, int8, int8, bf16): launches K1 0
                (the sigma passes run the int8 trunk, torch._int_mm, 18
                products a chunk, counted by models/network.INT8_MM) and K2
                (K4 with the switch) 1 a chunk on the bfloat16_all twin; rgb
                and depth against phase 5's (5b's) request within the
                ranges INT8_RGB_MEAN / INT8_DEPTH_MEAN; 256 rays against
                the CPU twins at phase 5's bounds; a request with normal_at_surface
                (no K2, 27 int8 products a chunk); the eval CLI at
                --compute_dtype int8 on the workflow's stage-2 run (K1 0 /
                K2 26), its scores within INT8_SCORES of phase 9's
 17. data parallel - the flagship fused step on a mesh of one NCCL rank
                against the one-device step (2 steps, bit for bit), both
                timed in turns (DP_STEPS steps each; K1 2 / K2 1 / K3 1 a
                step); one float32 step on two gloo ranks sharing the card
                (spawned processes) against the one-device step at
                tools/dp_check's bounds; the train CLI with --n_devices 1
                --sharded_store 1 --scale_global_batch 1 (8 steps on the
                workflow's AOI); load_renderer(n_devices=1) against phase
                5's request bit for bit; the same server with two replicas
                sharing the card (the split render, a thread a replica)
                against phase 5's request within SPLIT_TOL
 18. tensor parallel - one float32 step of the 12 x 2048 trunk tensor
                parallelism exists for (the flagship heads and losses,
                TP_BATCH rays) on a (1, 2) mesh of two gloo ranks sharing
                the card against the one-device unfused step
                (tools/tp_check at the JAX package's TP bounds), each rank
                holding its share of the trunk; K1-K5 launched 0 times (this
                process and the ranks); the model group's collectives
                (calls, bytes, host seconds) printed; the flagship 8 x 512
                train CLI's [kernels] line with --n_devices 2 --tp 2 names
                tensor parallelism
Then one JSON line of every ported kernel instantiation (each launched on
a main path: the run fails if one was not; launches_int8, launches_dp,
launches_split and launches_tp the new phases' counts; the layer-major
rows keyed "<K1|K2|K2zs|K3> <dtype> f2048"), the card's line, and the
last line {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import dataclasses as dc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM bytes/s
N_SAMPLES = 64          # stratified and guided samples per ray
CHUNK = 5120            # rays per render chunk (opts --chunk default)
REQ_SIDE = 128          # a request is a 128 x 128 image
N_REQUESTS = 3
BATCH = 1024            # rays per train step (the flagship's batch)
STORE_BATCHES = 16      # the ray store holds 16 batches
WARM_STEPS = 3          # from step 3 on every gate of bench.py holds
TIMED_STEPS = 16        # one pass over the store (32 until the activations'
                        # phases came, whose time this cut pays for in part)
CHECK_RAYS = 128        # rays of the whole-step kernels-vs-twins check
CHECK_POINTS = 4        # ... at the weights after each of the last 4 steps
MIX_STEPS = 4           # timed steps of the mixed bfloat16 runs
UNFUSED_STEPS = 4       # ... and of the unfused float32 step (~340 ms each)
ACT_STEPS = 10          # timed steps at the exact sine and at ReLU
ACT_SHORT = 2           # ... of their float32 and bfloat16 runs
FAMILY_STEPS = 10       # timed steps of each BRDF family and dtype
VARIANT_STEPS = 4       # timed steps of each variant (a one-batch store)
FUSED_HEADS = "BRDFNERF_FUSED_HEADS"   # read per call by models.network
# the flagship render's (n, 3) panel maps
FLAGSHIP_KEYS3 = ("albedo_coarse", "normal_an_coarse", "rpv_k_coarse",
                  "rpv_theta_coarse", "rpv_rhoc_coarse", "irradiance_coarse")


T0 = time.perf_counter()
_PHASE = [None, T0]          # the phase running and when it began


def phase(name):
    """Start phase `name`: prints the run's time so far and the seconds
    the previous phase took."""
    now = time.perf_counter()
    prev = ("" if _PHASE[0] is None else
            f"; {_PHASE[0]} took {now - _PHASE[1]:.1f} s")
    print(f"== {name} (t+{now - T0:.1f} s{prev})", flush=True)
    _PHASE[:] = [name, now]


def timed(fn, reps):
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def diff(name, got, ref):
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    out = {"max": d.max().item(), "mean": d.mean().item(), "scale": scale,
           "rel": rel_l2(got, ref)}
    print(f"  {name}: max|d| {out['max']:.3e}  mean|d| {out['mean']:.3e}  "
          f"rel L2 {out['rel']:.3e}  (scale {scale:.3e})", flush=True)
    return out


def same_twice(label, first, second):
    """Two launches of a kernel on the same inputs give the same bits (a
    fixed summation order, no atomics)."""
    torch.cuda.synchronize()
    for i, (a_, b_) in enumerate(zip(first, second)):
        assert torch.equal(a_, b_), f"{label}: output {i} differs between " \
                                    "launches"
    print(f"  {label}: two launches bit-identical", flush=True)


def rel_l2(got, ref):
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


# the sigma head's bias, whose gradient is one sum over the points of terms
SIGMA_BIAS = "sigma_from_xyz.0.b"
# the sigma head's bias gradient is one sum over the points of terms of
# either sign: held to DBSIG_BOUND of its terms' L2 norm
# (tools/f32_check.dbsig_scale), not of the sum, which is small where the
# terms cancel and then makes the relative error large for any summation
# order (the old relative reading is printed beside)
DBSIG_BOUND = 1e-2


def dbsig_held(label, got, ref, scale):
    """dbsig against its twin, held to DBSIG_BOUND of its terms' norm;
    returns the error."""
    from brdfnerf_tpu_torch.tools.f32_check import dbsig_error
    e = dbsig_error(got, ref, scale)
    print(f"  {label} dbsig: {e:.3e} of its terms' L2 norm (bound "
          f"{DBSIG_BOUND:g}); relative to the sum {rel_l2(got, ref):.3e}",
          flush=True)
    assert e <= DBSIG_BOUND, (label, e)
    return e


# K2 and K4 are instantiations <ZS, HEADS, ZF32, SPLIT> of one kernel
# template, K3's and K5's sweep <HEADS, ZF32, SPLIT>, their weight-gradient
# and reduce kernels <HEADS>, K1 <SPLIT>, K5's b_th chain <ZF32>; names as
# the profiler gives them, demangled or not
def sigma_bias_scales(bias_terms):
    """{sigma-bias parameter name: the L2 norm of its gradient's terms} of
    a step ('coarse.' + SIGMA_BIAS, and 'fine.' + SIGMA_BIAS with a fine
    network).  bias_terms: (network name, norm) of each backward call of
    the step."""
    sq = {}
    for name, v in bias_terms:
        sq[name] = sq.get(name, 0.0) + v * v
    return {f"{name}.{SIGMA_BIAS}": float(np.sqrt(v))
            for name, v in sq.items()}


def pack_owners(params):
    """{data_ptr of each network's first trunk bias: the network's name in
    the Params}: the packed weights of a kernel call hold that parameter's
    own storage (pack_trunk_weights takes the f32 biases as they are), so
    packed["b0"].data_ptr() names the network of the call."""
    return {net["fc_net"][0].b.data_ptr(): name
            for name, net in params.named_children()}


@contextlib.contextmanager
def fixed_fine(fine_z, rays):
    """Inside, the fine pass takes rows `rays` of the fine samples fine_z
    (N, n_importance) in place of sample_pdf's, so that every render of a
    step check runs the fine network on the same points, whatever the
    coarse weights it rendered (None: nothing replaced)."""
    from brdfnerf_tpu_torch.render import render as render_mod
    real = render_mod.sample_pdf

    def fixed(bins, weights, n_samples, **_):
        assert weights.shape[0] == len(rays), weights.shape
        assert n_samples == fine_z.shape[1], fine_z.shape
        return fine_z[torch.as_tensor(rays)].to(weights.device)
    if fine_z is not None:
        render_mod.sample_pdf = fixed
    try:
        yield
    finally:
        render_mod.sample_pdf = real


def held_on_inputs(r, rays, label):
    """Render `rays` through renderer r with every K1 and K2 call (K4's
    with BRDFNERF_FUSED_HEADS set) held to its plain twin on the inputs
    the render gives it: the request's own
    encoded points at the path's shapes, each call launched twice
    (bit-identical) and within tools/width_check.held's bounds at r's
    dtype and activation, as check_layers holds them.  It holds a render
    that no comparison with another render determines: with an encoding of
    24 octaves (xyz scaled by 2^23) a moved depth moves the guided
    samples' encodings by O(1), so two renders, on the card and on the
    CPU, run on different points.  Returns the number of calls held."""
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.tools import act_check, width_check
    mcfg = r.cfg.model
    act, dtype = k1.act_of(mcfg), mcfg.compute_dtype
    assert dtype != "float32", "float32's ratio needs a bfloat16_all run"
    saved = (k1._trunk_sigma_cuda, k2._trunk_fwd_grad_cuda,
             k4._trunk_heads_fwd_cuda)
    calls = []

    def holding(kern, fn, twin):
        def run(packed, cfg, x, want):
            out = fn(packed, cfg, x, want)
            got = [v for v in out if v is not None]
            names = (("sigma", "feats") if kern == "K1" else
                     ("sigma", "feats", "gx", "zs", "us"))[:len(got)]
            width_check.held(
                kern, f"{label}, call {len(calls)}, {x.shape[0]} points",
                names, got,
                [v for v in fn(packed, cfg, x, want) if v is not None],
                [v for v in twin(packed, cfg, x, want) if v is not None],
                dtype, act, {}, feat=cfg.feat)
            calls.append(kern)
            return out
        return run

    def holding_heads(fn, twin):
        def run(packed, hw, cfg, x, want=False):
            out = fn(packed, hw, cfg, x, want)
            got = [v for v in out if v is not None]
            width_check.held(
                "K4", f"{label}, call {len(calls)}, {x.shape[0]} points",
                ("out", "gx", "zs")[:len(got)], got,
                [v for v in fn(packed, hw, cfg, x, want) if v is not None],
                [v for v in twin(packed, hw, cfg, x, want) if v is not None],
                dtype, act, {}, feat=cfg.feat)
            calls.append("K4")
            return out
        return run

    k1._trunk_sigma_cuda = holding("K1", saved[0], k1._trunk_sigma_plain)
    k2._trunk_fwd_grad_cuda = holding("K2", saved[1],
                                      k2._trunk_fwd_grad_plain)
    k4._trunk_heads_fwd_cuda = holding_heads(saved[2],
                                             k4._trunk_heads_fwd_plain)
    try:
        r.render_image({"rays": rays})
    finally:
        (k1._trunk_sigma_cuda, k2._trunk_fwd_grad_cuda,
         k4._trunk_heads_fwd_cuda) = saved
    assert not act_check.MISSES, act_check.MISSES
    return len(calls)


GROUPS = (("K1-K5 layer-major products", ("layers_product_kernel",)),
          ("K1-K5 layer-major epilogues", ("layers_split_kernel",
                                           "layers_colsum_kernel",
                                           "layers_sigma_finish",
                                           "layers_k2_seed",
                                           "layers_k3_head",
                                           "layers_heads_finish",
                                           "layers_tile_rows")),
          ("K1 trunk_sigma", ("trunk_sigma_kernel",)),
          ("K4 trunk_heads_fwd", ("trunk_fwd_grad_kernel<true, true,",
                                  "trunk_fwd_grad_kernel<false, true,",
                                  "trunk_fwd_grad_kernelilb1elb1e",
                                  "trunk_fwd_grad_kernelilb0elb1e")),
          ("K2 trunk_fwd_grad", ("trunk_fwd_grad_kernel",)),
          ("K5 trunk_heads_bwd b_th chain", ("trunk_heads_uchain_kernel",)),
          ("K5 trunk_heads_bwd sweep", ("trunk_bwd_sweep_kernel<true,",
                                        "trunk_bwd_sweep_kernelilb1e")),
          ("K5 trunk_heads_bwd wgrad", ("trunk_bwd_wgrad_kernel<true>",
                                        "trunk_bwd_wgrad_kernelilb1e")),
          ("K5 trunk_heads_bwd reduce", ("trunk_bwd_reduce_kernel<true>",
                                         "trunk_bwd_reduce_kernelilb1e")),
          ("K3 trunk_bwd sweep", ("trunk_bwd_sweep_kernel",)),
          ("K3 trunk_bwd wgrad", ("trunk_bwd_wgrad_kernel",)),
          ("K3 trunk_bwd reduce", ("trunk_bwd_reduce_kernel",)),
          ("layout check (tools/sm90_check.py)", ("sm90_check_kernel",)),
          ("optimizer (Adam)", ("adam",)),
          ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_")),
          ("elementwise", ("elementwise",)))


def kernel_group(name):
    """The GROUPS label of a kernel name as the profiler gives it, or
    "other"."""
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def kernel_parts(fn):
    """Device ms per call of each kernel function fn launches (the
    backward's b_th chain, sweep, wgrad and reduce), from torch.profiler
    over 3 calls after one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for part, key in (("uchain", "trunk_heads_uchain_kernel"),
                              ("sweep", "trunk_bwd_sweep_kernel"),
                              ("wgrad", "trunk_bwd_wgrad_kernel"),
                              ("reduce", "trunk_bwd_reduce_kernel")):
                if key in ev.key:
                    parts[f"{part}_ms"] = (parts.get(f"{part}_ms", 0.0)
                                           + ev.self_device_time_total / 3e3)
    return parts


def profile_device(fn, label):
    """Device time by kernel group over one call of fn (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operator rows repeat their kernels' time
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = (by_name.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e3)
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        groups[kernel_group(name)] += ms
    device_ms = sum(by_name.values())
    print(f"  profiled {label}: wall {wall_ms:.2f} ms, device "
          + (f"{device_ms:.2f} ms (busy {device_ms / wall_ms:.1%})"
             if device_ms else "time not measured (no device events)"),
          flush=True)
    for name, ms in groups.items():
        print(f"    {ms:9.3f} ms  {name}", flush=True)
    if device_ms:
        print(f"    {wall_ms - device_ms:9.3f} ms  device idle", flush=True)
    print("  top kernels:", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.3f} ms  {name[:100]}", flush=True)


def k1_check(label, k1, packed, mcfg, enc, feats):
    """K1 against its twin on the card, launched twice with bit-identical
    outputs; returns the largest |d| of sigma."""
    got = k1._trunk_sigma_cuda(packed, mcfg, enc, feats)
    n_out = 2 if feats else 1
    same_twice(label, got[:n_out],
               k1._trunk_sigma_cuda(packed, mcfg, enc, feats)[:n_out])
    ref = k1._trunk_sigma_plain(packed, mcfg, enc, feats)
    torch.cuda.synchronize()
    # K1 splits each f32 operand into bf16 hi and lo terms (2^-16 relative)
    # and sums both products in f32, the twin's f32 arithmetic to within
    # summation order: measured on the card sigma max 7.2e-6 and mean
    # 1.2e-6 of its scale at 192 .. 327,680 points, feats max 5.1e-5 and
    # mean 5.0e-6 (tools/sigma_variants.py --check).  The sigma bounds are
    # 400 times tighter than those of the bf16-activation design (2e-2,
    # 2e-3 of the scale), whose kernel measured 3.9e-3 and 5.5e-4 here
    errs = []
    for i, (mx, mn) in enumerate(((5e-5, 5e-6), (2e-4, 2e-5))[:n_out]):
        e = diff(f"{label} {('sigma', 'feats')[i]}", got[i], ref[i])
        assert torch.isfinite(got[i]).all(), label
        assert e["max"] <= mx * e["scale"], (label, i, e)
        assert e["mean"] <= mn * e["scale"], (label, i, e)
        errs.append(e["max"])
    return errs[0]


K5_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig", "dwf", "dbf", "dw1r", "db1r", "dw2r", "db2r", "dw1p",
            "db1p", "dw2p", "db2p")


def heads_kernels(rows, mcfg, net, packed, wbytes, points, chain_k2,
                  chain_k3, peaks, gen):
    """Phase 3b: K4 at the serving shape without zs and at the training
    shape with zs, K5 at the training shape, twice; each against its twin
    on the card, timed beside its twin and a torch.matmul chain of the
    same products (the trunk's chain of K2 / K3, plus the heads'; K5's
    also the rebuild of the u chain)."""
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.tools import f32_check as fc
    from brdfnerf_tpu_torch.tools.width_check import (bound_ms,
                                                      heads_chains,
                                                      trunk_work)
    feat, hid, lane, ein = mcfg.feat, mcfg.feat // 2, k1.LANE, mcfg.xyz_in_dim
    hw = k4.pack_head_weights(net, mcfg, torch.bfloat16)
    hbytes = sum(v.numel() * v.element_size() for v in hw.values())
    chain_heads, chain_k5_heads = heads_chains(packed, hw, mcfg, lane)

    def check(label, got, ref, max_rel=5e-2, mean_rel=1e-3, l2=None):
        e = diff(label, got, ref)
        assert torch.isfinite(got.float()).all(), label
        assert e["max"] <= max_rel * e["scale"], label
        assert e["mean"] <= mean_rel * e["scale"], label
        if l2 is not None:
            assert e["rel"] <= l2, (label, e["rel"])
        return e["max"]

    # K4: the main pass of a serving chunk, CHUNK * 2 * N_SAMPLES points
    n2 = CHUNK * 2 * N_SAMPLES
    enc = points(n2)
    out_k, gx_k, _ = k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc)
    same_twice("K4", (out_k, gx_k),
               k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc)[:2])
    out_p, gx_p, _ = k4._trunk_heads_fwd_plain(packed, hw, mcfg, enc)
    sig2, _, gx2 = k2._trunk_fwd_grad_cuda(packed, mcfg, enc)
    torch.cuda.synchronize()
    # both sides round the same operands to bf16; as K2, summation order
    # flips some roundings and the flips cascade, through three more
    # products for the logits
    errs = [check("K4 out", out_k, out_p), check("K4 gx", gx_k, gx_p)]
    assert out_k[:, 7].abs().max().item() == 0.0, "K4 padded column"
    assert gx_k[:, ein:].abs().max().item() == 0.0, "K4 gx padded lanes"
    # K4 runs K2's trunk and chain with the same arithmetic
    same = torch.equal(gx_k, gx2) and torch.equal(out_k[:, 0], sig2)
    print(f"  K4 sigma and gx bit-identical to K2's: {same}", flush=True)
    assert same, "K4's sigma or gx differ from K2's"
    del out_k, gx_k, out_p, gx_p, sig2, gx2
    encb = enc.to(torch.bfloat16)
    hb = torch.randn(n2, feat, device="cuda", generator=gen).to(
        torch.bfloat16)
    rows["K4"] = {
        "name": "trunk_heads_fwd", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_heads_fwd.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_trunk_heads.py:154",
        "max_abs_err": max(errs),
        "ms": timed(lambda: k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc),
                    5),
        "plain_ms": timed(lambda: k4._trunk_heads_fwd_plain(packed, hw, mcfg,
                                                            enc), 1),
        "library_ms": timed(lambda: (chain_k2(encb), chain_heads(hb)), 5)}
    # the trunk's and the heads' products; x and gx at the encoding's ein
    # lanes, the packed logits, the weights once (width_check.trunk_work)
    rows["K4"]["_flops"], k4_bytes = trunk_work("K4", mcfg, n2, wbytes,
                                                hbytes)
    rows["K4"]["bound_ms"], rows["K4"]["bound_by"] = bound_ms(
        rows["K4"]["_flops"], k4_bytes, peaks)
    del enc, encb, hb

    # K4 saving zs and K5, at the train step's main pass
    n3 = BATCH * 2 * N_SAMPLES
    enc = points(n3)
    out_k, gx_k, zs = k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc,
                                               want_zs=True)
    same_twice("K4 saving zs", (out_k, gx_k, zs),
               k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc, want_zs=True))
    out_s, gx_s, _ = k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc)
    out_p, gx_p, zs_p = k4._trunk_heads_fwd_plain(packed, hw, mcfg, enc,
                                                  want_zs=True)
    torch.cuda.synchronize()
    # as K2 saving zs/us
    errs = [check(f"K4+zs {name}", got, ref, l2=1e-2)
            for name, got, ref in (("out", out_k, out_p), ("gx", gx_k, gx_p),
                                   ("zs", zs, zs_p))]
    assert torch.equal(out_k, out_s) and torch.equal(gx_k, gx_s), \
        "K4 with zs changes its outputs"
    del out_k, gx_k, out_s, gx_s, out_p, gx_p, zs_p
    rows["K4zs"] = {
        "name": "trunk_heads_fwd (saving zs)", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_heads_fwd.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_trunk_heads.py:154",
        "max_abs_err": max(errs),
        "ms": timed(lambda: k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc,
                                                     want_zs=True), 5),
        "plain_ms": timed(lambda: k4._trunk_heads_fwd_plain(
            packed, hw, mcfg, enc, want_zs=True), 1)}
    rows["K4zs"]["_flops"], rows["K4zs"]["_bytes"] = trunk_work(
        "K4zs", mcfg, n3, wbytes, hbytes)
    rows["K4zs"]["bound_ms"], rows["K4zs"]["bound_by"] = bound_ms(
        rows["K4zs"]["_flops"], rows["K4zs"]["_bytes"], peaks)
    encb = enc.to(torch.bfloat16)
    hb = torch.randn(n3, feat, device="cuda", generator=gen).to(
        torch.bfloat16)
    rows["K4zs"]["library_ms"] = timed(lambda: (chain_k2(encb),
                                                chain_heads(hb)), 5)

    cot = torch.randn(n3, k4.HEAD_COLS, device="cuda", generator=gen)
    cot[:, 7] = 0.0
    cg = torch.zeros(n3, lane, device="cuda")
    cg[:, :ein] = torch.randn(n3, ein, device="cuda", generator=gen)
    scratch = {}
    got = k4._trunk_heads_bwd_cuda(packed, hw, mcfg, enc, cot, cg, zs,
                                   scratch_out=scratch)
    again = k4._trunk_heads_bwd_cuda(packed, hw, mcfg, enc, cot, cg, zs)
    ref = k4._trunk_heads_bwd_plain(packed, hw, mcfg, enc, cot, cg, zs)
    torch.cuda.synchronize()
    # the b_th chain K5 rebuilds from zs before its sweep, against the
    # twin's, at K2's us bounds: the same bf16 operands, f32 sums in
    # another order, whose flipped roundings of b_tz cascade down the
    # chain as in K2's (measured on the card 8.1e-4 relative L2, K2's us
    # 3.2e-3)
    check("K5 rebuilt b_th chain",
          k4.uchain_from_kernel(scratch["uc"], n3, mcfg.layers),
          k4.uchain_plain(packed, mcfg, zs), l2=1e-2)
    del scratch
    k5_err, k5_rel = 0.0, 0.0
    for name, g_, r_, a_ in zip(K5_NAMES, got, ref, again):
        # deterministic: a fixed summation order, no atomics
        assert torch.equal(g_, a_), f"K5 {name} differs between launches"
        if name in ("dw2r", "dw2p"):        # the 3 logit columns
            g_, r_ = g_[:, :3], r_[:, :3]
        e = diff(f"K5 {name}", g_, r_)
        k5_err = max(k5_err, e["max"])
        assert torch.isfinite(g_).all(), name
        if name == "dbsig":
            dbsig_held("K5", g_, r_, fc.dbsig_scale(packed, mcfg, cot[:, 0],
                                                    cg, zs))
            continue
        k5_rel = max(k5_rel, e["rel"])
        # K3's bound (its measured 1.6e-3 .. 3.6e-3): K5 rebuilds the u
        # chain from zs in f32 as its twin and the Pallas kernel do, so the
        # two differ in summation order alone, as K3 and its twin do
        assert e["rel"] <= 1e-2, f"K5 {name} relative L2 {e['rel']:.3e}"
    del got, again, ref
    czb = torch.randn(n3, 4 * hid, device="cuda", generator=gen).to(
        torch.bfloat16)

    ubt = torch.randn(n3, feat, device="cuda", generator=gen).to(
        torch.bfloat16)

    def chain_k5():
        chain_k3()
        chain_k5_heads(hb, czb, ubt)

    rows["K5"] = {
        "name": "trunk_heads_bwd", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_heads_bwd.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_trunk_heads.py:185",
        "max_abs_err": k5_err,
        "ms": timed(lambda: k4._trunk_heads_bwd_cuda(
            packed, hw, mcfg, enc, cot, cg, zs), 5),
        "plain_ms": timed(lambda: k4._trunk_heads_bwd_plain(
            packed, hw, mcfg, enc, cot, cg, zs), 1),
        "library_ms": timed(chain_k5, 5)}
    rows["K5"].update(kernel_parts(lambda: k4._trunk_heads_bwd_cuda(
        packed, hw, mcfg, enc, cot, cg, zs)))
    # K3's reads and writes, with the logit cotangents in place of c_feats
    # and no us, plus the head weights and their grads; K3's products plus
    # the heads' and the rebuilt u chain's (L - 1 products of F x F)
    rows["K5"]["_flops"], rows["K5"]["_bytes"] = trunk_work(
        "K5", mcfg, n3, wbytes, hbytes)
    rows["K5"]["bound_ms"], rows["K5"]["bound_by"] = bound_ms(
        rows["K5"]["_flops"], rows["K5"]["_bytes"], peaks)
    print(f"  K5 largest relative L2 against its twin {k5_rel:.3e}",
          flush=True)


def forward_small(n, mcfg, net, packed, points):
    """K2 and K4, serving and saving zs/us (K4: zs), and K1 with and
    without feats, at n points against their twins on the card at the main
    paths' bounds, each K1 launch twice with bit-identical outputs; n = 192
    is 3 tiles, so most blocks of the persistent grid get none and the last
    wave is ragged."""
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    hw = k4.pack_head_weights(net, mcfg, torch.bfloat16)
    enc = points(n)
    z2 = k2._trunk_fwd_grad_cuda(packed, mcfg, enc, want_zs=True)
    s2 = k2._trunk_fwd_grad_cuda(packed, mcfg, enc)
    z4 = k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc, want_zs=True)
    s4 = k4._trunk_heads_fwd_cuda(packed, hw, mcfg, enc)
    p2 = k2._trunk_fwd_grad_plain(packed, mcfg, enc, want_zs=True)
    p4 = k4._trunk_heads_fwd_plain(packed, hw, mcfg, enc, want_zs=True)
    torch.cuda.synchronize()
    cases = (list(zip(("K2 sigma", "K2 feats", "K2 gx", "K2 zs", "K2 us"),
                      z2, p2))
             + [("K4 out", z4[0], p4[0]), ("K4 gx", z4[1], p4[1]),
                ("K4 zs", z4[2], p4[2])])
    worst = 0.0
    for label, got, ref in cases:
        e = diff(f"{label} at {n} points", got, ref)
        assert torch.isfinite(got.float()).all(), label
        assert e["max"] <= 5e-2 * e["scale"], label
        assert e["mean"] <= 1e-3 * e["scale"], label
        if label.endswith(("zs", "us")):
            assert e["rel"] <= 1e-2, label
        worst = max(worst, e["rel"])
    for a_, b_ in zip(z2[:3], s2):
        assert torch.equal(a_, b_), "K2 with zs/us changes its outputs"
    for a_, b_ in zip(z4[:2], s4[:2]):
        assert torch.equal(a_, b_), "K4 with zs/us changes its outputs"
    assert torch.equal(s4[1], s2[2]) and torch.equal(s4[0][:, 0], s2[0])
    print(f"  K2 and K4 at {n} points: largest relative L2 against the "
          f"twins {worst:.3e}", flush=True)
    for feats in (False, True):
        k1_check(f"K1 at {n} points, feats {feats}", k1, packed, mcfg, enc,
                 feats)


def backward_small(n, mcfg, net, packed, points, gen, k5_draws=5):
    """K3 and K5 at n points against their twins on the card, each twice
    with bit-identical grads, at K3's bound of the training shape; K5 on
    k5_draws draws of cotangents (the first with K3's points)."""
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.tools.f32_check import dbsig_scale
    lane, ein = k2.LANE, mcfg.xyz_in_dim
    hw = k4.pack_head_weights(net, mcfg, torch.bfloat16)
    enc = points(n)
    _, _, _, zs, us = k2._trunk_fwd_grad_cuda(packed, mcfg, enc, want_zs=True)
    cs = torch.randn(n, device="cuda", generator=gen)
    cf = (torch.randn(n, mcfg.feat, device="cuda", generator=gen)
          * 0.1).to(torch.bfloat16)

    def c_g():
        cg_ = torch.zeros(n, lane, device="cuda")
        cg_[:, :ein] = torch.randn(n, ein, device="cuda", generator=gen)
        return cg_

    def c_out():
        cot_ = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
        cot_[:, 7] = 0.0
        return cot_

    cg = c_g()
    cases = [("K3", K5_NAMES[:9],
              lambda: k2._trunk_bwd_cuda(packed, mcfg, enc, cs, cf, cg, zs,
                                         us),
              lambda: k2._trunk_bwd_plain(packed, mcfg, enc, cs, cf, cg, zs,
                                          us),
              dbsig_scale(packed, mcfg, cs, cg, zs))]
    for d in range(k5_draws):
        cot, cg_d = c_out(), (cg if d == 0 else c_g())
        cases.append((
            f"K5 (draw {d})", K5_NAMES,
            lambda cot=cot, cg_d=cg_d: k4._trunk_heads_bwd_cuda(
                packed, hw, mcfg, enc, cot, cg_d, zs),
            lambda cot=cot, cg_d=cg_d: k4._trunk_heads_bwd_plain(
                packed, hw, mcfg, enc, cot, cg_d, zs),
            dbsig_scale(packed, mcfg, cot[:, 0], cg_d, zs)))
    for label, names, kernel, twin, scale in cases:
        got, again, ref = kernel(), kernel(), twin()
        torch.cuda.synchronize()
        worst = 0.0
        for name, g_, r_, a_ in zip(names, got, ref, again):
            assert torch.equal(g_, a_), f"{label} {name} at {n} points"
            if name in ("dw2r", "dw2p"):
                g_, r_ = g_[:, :3], r_[:, :3]
            assert torch.isfinite(g_).all(), (label, name, n)
            if name == "dbsig":
                dbsig_held(f"{label} at {n} points", g_, r_, scale)
                continue
            rel = rel_l2(g_, r_)
            worst = max(worst, rel)
            assert rel <= 1e-2, (label, name, n, rel)
        print(f"  {label} at {n} points: two launches bit-identical, largest "
              f"relative L2 against its twin {worst:.3e}", flush=True)


def f32_kernels(rows, mcfg, net, points, peaks, gen):
    """Phase 3c: the float32 instantiations (every product as three on the
    bf16 hi and lo terms of its f32 operands) of K1 at 327,680 and 65,536
    points, K2 at 655,360, K2 saving zs/us and K3 at 131,072, each launched
    twice bit-identical and held against its exact-f32 twin on the card
    (TF32 off) at tools/f32_check.py's bounds, beside the bfloat16_all
    kernel's output for the same inputs against the same twin; then the
    same at 192 points, and the mixed bfloat16 instantiations (f32 zs/us:
    K2 -> K3, K4 -> K5) against their twins at the training shape and at
    192 points.  Each timed beside its twin and the torch.matmul chain of
    the same products in f32 (TF32 off: cuBLAS SGEMM), or for the mixed
    ones in bf16 as the bfloat16_all rows."""
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.tools import f32_check as fc
    from brdfnerf_tpu_torch.tools.width_check import (bound_ms,
                                                      matmul_chains,
                                                      trunk_work)
    c32 = dc.replace(mcfg, compute_dtype="float32")
    cmix = dc.replace(mcfg, compute_dtype="bfloat16")
    p32 = k1.pack_trunk_weights(net, c32, torch.float32)
    p16 = k1.pack_trunk_weights(net, mcfg, torch.bfloat16)
    assert set(k1.PLANE_KEYS.values()) <= set(p32)
    # the bytes the split kernels read of the weights: the hi and lo planes
    # (the f32 weights' bytes) and the f32 vectors
    wbytes = sum(v.numel() * v.element_size() for k, v in p32.items()
                 if k not in k1.PLANE_KEYS)
    feat, lane, layers = mcfg.feat, k1.LANE, mcfg.layers
    ein = mcfg.xyz_in_dim
    chain_fwd, chain_k2, chain_k3 = matmul_chains(p32, mcfg, lane)
    report = {}

    def row(key, name, source, replaces, err, ms, plain_ms, library_ms,
            flops, nbytes, label):
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms}
        r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes, peaks)
        if label in report:
            r["rel_l2"] = report[label]["rel_l2"]
            if "bf16_over_f32" in report[label]:
                # the float32 kernel's error against the same twin, over the
                # bfloat16_all kernel's: how many times closer it is
                r["bf16_over_f32"] = report[label]["bf16_over_f32"]
                r["bound_split_ms"], _ = bound_ms(3 * flops, nbytes, peaks)
        rows[key] = r

    def max_err(got, ref):
        return max((g.float() - r.float()).abs().max().item()
                   for g, r in zip(got, ref))

    # K1: the serving pass (timed) and the training pass
    src1, rep1 = ("brdfnerf_tpu_torch/csrc/trunk_sigma.cu",
                  "brdfnerf_tpu/ops/pallas_mlp.py:114")
    n1 = CHUNK * N_SAMPLES
    for n in (n1, BATCH * N_SAMPLES):
        enc = points(n)
        got = k1._trunk_sigma_cuda(p32, c32, enc, False)
        same_twice(f"K1 float32 at {n} points", got[:1],
                   k1._trunk_sigma_cuda(p32, c32, enc, False)[:1])
        b16 = k1._trunk_sigma_cuda(p16, mcfg, enc, False)
        ref = k1._trunk_sigma_plain(p32, c32, enc, False)
        label = f"K1 float32 at {n}"
        fc.hold_f32(label, ("sigma",), got[:1], b16[:1], ref[:1], report)
        if n == n1:
            row("K1f32", "trunk_sigma (float32)", src1, rep1,
                max_err(got[:1], ref[:1]),
                timed(lambda: k1._trunk_sigma_cuda(p32, c32, enc, False), 10),
                timed(lambda: k1._trunk_sigma_plain(p32, c32, enc, False), 2),
                timed(lambda: chain_fwd(enc), 5),
                *trunk_work("K1", c32, n, wbytes), label)
        del enc, got, b16, ref

    # K2: the serving chunk's main pass
    src2, rep2 = ("brdfnerf_tpu_torch/csrc/trunk_fwd_grad.cu",
                  "brdfnerf_tpu/ops/pallas_trunk_vjp.py:205")
    n2 = CHUNK * 2 * N_SAMPLES
    enc = points(n2)
    got = k2._trunk_fwd_grad_cuda(p32, c32, enc)
    same_twice("K2 float32", got, k2._trunk_fwd_grad_cuda(p32, c32, enc))
    b16 = k2._trunk_fwd_grad_cuda(p16, mcfg, enc)
    ref = k2._trunk_fwd_grad_plain(p32, c32, enc)
    fc.hold_f32(f"K2 float32 at {n2}", ("sigma", "feats", "gx"), got, b16,
                ref, report)
    assert got[2][:, mcfg.xyz_in_dim:].abs().max().item() == 0.0
    err = max_err(got, ref)
    del got, b16, ref
    row("K2f32", "trunk_fwd_grad (float32)", src2, rep2, err,
        timed(lambda: k2._trunk_fwd_grad_cuda(p32, c32, enc), 5),
        timed(lambda: k2._trunk_fwd_grad_plain(p32, c32, enc), 1),
        timed(lambda: chain_k2(enc), 3), *trunk_work("K2", c32, n2, wbytes),
        f"K2 float32 at {n2}")
    del enc

    # K2 saving zs/us and K3: the training step's main pass
    n3 = BATCH * 2 * N_SAMPLES
    enc = points(n3)
    got = k2._trunk_fwd_grad_cuda(p32, c32, enc, want_zs=True)
    same_twice("K2 float32 saving zs/us", got,
               k2._trunk_fwd_grad_cuda(p32, c32, enc, want_zs=True))
    b16 = k2._trunk_fwd_grad_cuda(p16, mcfg, enc, want_zs=True)
    ref = k2._trunk_fwd_grad_plain(p32, c32, enc, want_zs=True)
    label = f"K2 float32 at {n3}, zs/us True"
    fc.hold_f32(label, ("sigma", "feats", "gx", "zs", "us"), got, b16, ref,
                report)
    err = max_err(got, ref)
    zs, us = got[3], got[4]
    del got, b16, ref
    row("K2zsf32", "trunk_fwd_grad (float32, saving zs/us)", src2, rep2, err,
        timed(lambda: k2._trunk_fwd_grad_cuda(p32, c32, enc, want_zs=True),
              5),
        timed(lambda: k2._trunk_fwd_grad_plain(p32, c32, enc, want_zs=True),
              1),
        timed(lambda: chain_k2(enc), 3), *trunk_work("K2zs", c32, n3, wbytes),
        label)
    cs, cf, cg = fc.cotangents(mcfg, n3, gen, torch.float32)
    got = k2._trunk_bwd_cuda(p32, c32, enc, cs, cf, cg, zs, us)
    same_twice("K3 float32", got,
               k2._trunk_bwd_cuda(p32, c32, enc, cs, cf, cg, zs, us))
    bf = torch.bfloat16
    b16 = k2._trunk_bwd_cuda(p16, mcfg, enc, cs, cf.to(bf), cg, zs.to(bf),
                             us.to(bf))
    ref = k2._trunk_bwd_plain(p32, c32, enc, cs, cf, cg, zs, us)
    label = f"K3 float32 at {n3}"
    fc.hold_f32(label, fc.K3_NAMES, got, b16, ref, report)
    err = max_err(got, ref)
    del got, b16, ref
    hth = torch.randn(2 * n3, feat, device="cuda", generator=gen)
    azb = torch.randn(2 * n3, feat, device="cuda", generator=gen)
    xtb = torch.cat([enc, cg], 0)
    row("K3f32", "trunk_bwd (float32)", "brdfnerf_tpu_torch/csrc/trunk_bwd.cu",
        "brdfnerf_tpu/ops/pallas_trunk_vjp.py:240", err,
        timed(lambda: k2._trunk_bwd_cuda(p32, c32, enc, cs, cf, cg, zs, us),
              5),
        timed(lambda: k2._trunk_bwd_plain(p32, c32, enc, cs, cf, cg, zs, us),
              1),
        timed(lambda: chain_k3(cg, azb, hth, xtb), 3),
        *trunk_work("K3", c32, n3, wbytes), label)
    rows["K3f32"].update(kernel_parts(lambda: k2._trunk_bwd_cuda(
        p32, c32, enc, cs, cf, cg, zs, us)))
    del hth, azb, xtb, zs, us

    # K4 serving and saving zs, and K5, at float32 (split products; the
    # head weights W_f, W_1 as hi and lo planes, W_2 in f32): each twice
    # bit-identical, within fc.F32_BOUND of its exact twin and of its split
    # twin, fc.HEADS_CLOSER times closer to the exact twin than the
    # bfloat16_all kernel; timed beside the exact twin and the f32
    # torch.matmul chain of the same products
    hw32 = k4.pack_head_weights(net, c32, torch.float32)
    hw16 = k4.pack_head_weights(net, mcfg, torch.bfloat16)
    hbytes = sum(v.numel() * v.element_size() for k, v in hw32.items()
                 if k not in k4.HEAD_PLANE_KEYS)
    hid = feat // 2
    wfm, w1m = hw32["wf"], torch.cat([hw32["w1r"], hw32["w1p"]])
    w2r, w2p = hw32["w2r"][:3], hw32["w2p"][:3]

    def chain_heads(h):
        z1 = (h @ wfm.t()) @ w1m.t()
        return z1[:, :hid] @ w2r.t(), z1[:, hid:] @ w2p.t()

    src4, rep4 = ("brdfnerf_tpu_torch/csrc/trunk_heads_fwd.cu",
                  "brdfnerf_tpu/ops/pallas_trunk_heads.py:154")
    for key, n, want_zs in (("K4f32", n2, False), ("K4zsf32", n3, True)):
        enc4 = points(n)
        got = k4._trunk_heads_fwd_cuda(p32, hw32, c32, enc4, want_zs)
        k = 2 + want_zs
        same_twice(f"{key}", got[:k], k4._trunk_heads_fwd_cuda(
            p32, hw32, c32, enc4, want_zs)[:k])
        b16 = k4._trunk_heads_fwd_cuda(p16, hw16, mcfg, enc4, want_zs)
        ref = k4._trunk_heads_fwd_plain(p32, hw32, c32, enc4, want_zs)
        spl = k4._trunk_heads_fwd_split(p32, hw32, c32, enc4, want_zs)
        label = f"K4 float32 at {n}, zs {want_zs}"
        fc.hold_f32(label, ("out", "gx", "zs")[:k], got[:k], b16[:k],
                    ref[:k], report, fc.HEADS_CLOSER, spl[:k])
        err = max_err(got[:k], ref[:k])
        del got, b16, ref, spl
        h = torch.randn(n, feat, device="cuda", generator=gen)
        row(key, "trunk_heads_fwd (float32" + (", saving zs)" if want_zs
                                               else ")"),
            src4, rep4, err,
            timed(lambda: k4._trunk_heads_fwd_cuda(p32, hw32, c32, enc4,
                                                   want_zs), 5),
            timed(lambda: k4._trunk_heads_fwd_plain(p32, hw32, c32, enc4,
                                                    want_zs), 1),
            timed(lambda: (chain_k2(enc4), chain_heads(h)), 3),
            rows["K4zs" if want_zs else "K4"]["_flops"],
            n * (ein * 4 + 8 * 4 + ein * 4
                 + (layers * feat * 4 if want_zs else 0)) + wbytes + hbytes,
            label)
        del h
        if not want_zs:
            del enc4
    zs = k4._trunk_heads_fwd_cuda(p32, hw32, c32, enc4, True)[2]
    cot = torch.randn(n3, k4.HEAD_COLS, device="cuda", generator=gen)
    cot[:, 7] = 0.0
    got = k4._trunk_heads_bwd_cuda(p32, hw32, c32, enc4, cot, cg, zs)
    same_twice("K5 float32", got,
               k4._trunk_heads_bwd_cuda(p32, hw32, c32, enc4, cot, cg, zs))
    b16 = k4._trunk_heads_bwd_cuda(p16, hw16, mcfg, enc4, cot, cg,
                                   zs.to(torch.bfloat16))
    ref = k4._trunk_heads_bwd_plain(p32, hw32, c32, enc4, cot, cg, zs)
    spl = k4._trunk_heads_bwd_split(p32, hw32, c32, enc4, cot, cg, zs)
    label = f"K5 float32 at {n3}"
    fc.hold_f32(label, fc.K5_NAMES, got, b16, ref, report, fc.HEADS_CLOSER,
                spl)
    err = max_err(got, ref)
    del got, b16, ref, spl
    hh = torch.randn(n3, feat, device="cuda", generator=gen)
    cz = torch.randn(n3, 4 * hid, device="cuda", generator=gen)
    hth = torch.randn(2 * n3, feat, device="cuda", generator=gen)
    azb = torch.randn(2 * n3, feat, device="cuda", generator=gen)
    xtb = torch.cat([enc4, cg], 0)

    def chain_k5():
        chain_k3(cg, azb, hth, xtb)
        u = hh                                      # the b_th chain
        m = layers - 3
        for i in range(layers - 1, 0, -1):
            if i == mcfg.skips[0]:
                u = u @ p32["w_skip"][:, lane:]
            else:
                u = u @ p32["w_mid"][m]
                m -= 1
        chain_heads(hh)
        axf = cz @ w1m
        axf @ wfm
        hh.t() @ axf
        hh.t() @ cz

    base = rows["K5"]
    row("K5f32", "trunk_heads_bwd (float32)",
        "brdfnerf_tpu_torch/csrc/trunk_heads_bwd.cu",
        "brdfnerf_tpu/ops/pallas_trunk_heads.py:185", err,
        timed(lambda: k4._trunk_heads_bwd_cuda(p32, hw32, c32, enc4, cot, cg,
                                               zs), 5),
        timed(lambda: k4._trunk_heads_bwd_plain(p32, hw32, c32, enc4, cot,
                                                cg, zs), 1),
        timed(chain_k5, 3), base["_flops"],
        base["_bytes"] + n3 * layers * feat * 2 + wbytes + hbytes, label)
    rows["K5f32"].update(kernel_parts(lambda: k4._trunk_heads_bwd_cuda(
        p32, hw32, c32, enc4, cot, cg, zs)))
    del hh, cz, hth, azb, xtb, zs, cot, enc4, hw32, hw16

    # the mixed bfloat16 contract at the training shape: bf16 operands, f32
    # activations, zs/us saved and read in f32; checked by f32_check at the
    # bfloat16_all instantiations' bound (relative L2 1e-2), then timed
    # beside their twins and the bf16 chains of the bfloat16_all rows
    fc.check_mixed(n3, report=report)
    hw = k4.pack_head_weights(net, cmix, torch.bfloat16)
    out = k2._trunk_fwd_grad_cuda(p16, cmix, enc, want_zs=True)
    zs, us = out[3], out[4]
    assert zs.dtype == us.dtype == torch.float32
    del out
    # the bf16 weights' bytes; f32 feats, zs and us (trunk_work)
    wb16 = sum(v.numel() * v.element_size() for v in p16.values())
    base = rows["K2zs"]
    row("K2zsmix", "trunk_fwd_grad (bfloat16, saving f32 zs/us)", src2,
        rep2, None,
        timed(lambda: k2._trunk_fwd_grad_cuda(p16, cmix, enc, want_zs=True),
              5),
        timed(lambda: k2._trunk_fwd_grad_plain(p16, cmix, enc, want_zs=True),
              1), base["library_ms"], *trunk_work("K2zs", cmix, n3, wb16),
        f"K2 bfloat16 saving f32 zs/us at {n3}")
    base = rows["K3"]
    row("K3mix", "trunk_bwd (bfloat16, f32 zs/us)",
        "brdfnerf_tpu_torch/csrc/trunk_bwd.cu",
        "brdfnerf_tpu/ops/pallas_trunk_vjp.py:240", None,
        timed(lambda: k2._trunk_bwd_cuda(p16, cmix, enc, cs, cf, cg, zs, us),
              5),
        timed(lambda: k2._trunk_bwd_plain(p16, cmix, enc, cs, cf, cg, zs,
                                          us), 1),
        base["library_ms"], *trunk_work("K3", cmix, n3, wb16),
        f"K3 bfloat16 on f32 zs/us at {n3}")
    del zs, us
    out, gx, zs = k4._trunk_heads_fwd_cuda(p16, hw, cmix, enc, want_zs=True)
    del out, gx
    cot = torch.randn(n3, k4.HEAD_COLS, device="cuda", generator=gen)
    cot[:, 7] = 0.0
    src4, rep4 = ("brdfnerf_tpu_torch/csrc/trunk_heads_fwd.cu",
                  "brdfnerf_tpu/ops/pallas_trunk_heads.py:154")
    base = rows["K4zs"]
    row("K4zsmix", "trunk_heads_fwd (bfloat16, saving f32 zs)", src4, rep4,
        None,
        timed(lambda: k4._trunk_heads_fwd_cuda(p16, hw, cmix, enc,
                                               want_zs=True), 5),
        timed(lambda: k4._trunk_heads_fwd_plain(p16, hw, cmix, enc,
                                                want_zs=True), 1),
        base["library_ms"], base["_flops"],
        base["_bytes"] + n3 * layers * feat * 2,
        f"K4 bfloat16 saving f32 zs at {n3}")
    base = rows["K5"]
    row("K5mix", "trunk_heads_bwd (bfloat16, f32 zs)",
        "brdfnerf_tpu_torch/csrc/trunk_heads_bwd.cu",
        "brdfnerf_tpu/ops/pallas_trunk_heads.py:185", None,
        timed(lambda: k4._trunk_heads_bwd_cuda(p16, hw, cmix, enc, cot, cg,
                                               zs), 5),
        timed(lambda: k4._trunk_heads_bwd_plain(p16, hw, cmix, enc, cot, cg,
                                                zs), 1),
        base["library_ms"], base["_flops"],
        base["_bytes"] + n3 * layers * feat * 2,
        f"K5 bfloat16 on f32 zs at {n3}")
    rows["K5mix"].update(kernel_parts(lambda: k4._trunk_heads_bwd_cuda(
        p16, hw, cmix, enc, cot, cg, zs)))
    for key, label in (("K2zsmix", "K2 bfloat16 saving f32 zs/us"),
                       ("K3mix", "K3 bfloat16 on f32 zs/us"),
                       ("K4zsmix", "K4 bfloat16 saving f32 zs"),
                       ("K5mix", "K5 bfloat16 on f32 zs")):
        rows[key]["max_abs_err"] = report[f"{label} at {n3}"]["max_abs"]
    del enc, zs, cot, cs, cf, cg
    # every instantiation again at 192, 640 and 8,448 points (3, 10 and 132
    # tiles: a ragged last wave, a fraction of one, and one tile an SM)
    for n in (192, 640, 8448):
        fc.check_f32(n, report=report)
    fc.check_mixed(192, report=report)
    print("  float32 kernels: largest relative L2 against the exact twins "
          + ", ".join(f"{k} {v['rel_l2']:.2e} ({v['bf16_over_f32']:.0f}x "
                      f"closer than bfloat16_all)"
                      for k, v in report.items() if "bf16_over_f32" in v),
          flush=True)


# the activations the kernels are also built for (besides the polynomial
# sine), the size of tools/act_check.py's check of every instantiation, and
# the poly rows each activation's instantiations are timed beside (same
# products and traffic: their library chain and bound)
ACT_CHECK_N = 8448
ACT_NAMES = {"sin": "exact sine", "relu": "ReLU"}
ACT_ROWS = {"bfloat16_all": {"K1": "K1", "K2": "K2", "K2zs": "K2zs",
                             "K3": "K3", "K4": "K4", "K4zs": "K4zs",
                             "K5": "K5"},
            "bfloat16": {"K2zs": "K2zsmix", "K3": "K3mix",
                         "K4zs": "K4zsmix", "K5": "K5mix"},
            "float32": {"K1": "K1f32", "K2": "K2f32", "K2zs": "K2zsf32",
                        "K3": "K3f32", "K4": "K4f32", "K4zs": "K4zsf32",
                        "K5": "K5f32"}}


def act_kernels(rows, points, gen, report):
    """Phase 3d: every instantiation of K1-K5 built for the exact sine and
    for ReLU.  tools/act_check.py's check at ACT_CHECK_N points (each twice
    bit-identical, against its twin, every dtype), then each at the main
    paths' shapes (K1 327,680 points, K2 and K4 655,360, the training
    instantiations 131,072): twice bit-identical, against its twin at
    act_check's bounds, timed beside its twin; its library chain and bound
    are those of the polynomial row of the same products (ACT_ROWS), whose
    activation the bound does not count."""
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.tools import act_check
    from brdfnerf_tpu_torch.tools import f32_check as fc
    names = ACT_NAMES
    n1, n2 = CHUNK * N_SAMPLES, CHUNK * 2 * N_SAMPLES
    n3 = BATCH * 2 * N_SAMPLES
    for act in act_check.ACT_CONFIGS:
        act_check.check_act(act, ACT_CHECK_N, report=report)
        assert not act_check.MISSES, act_check.MISSES
        for dtype, keys in ACT_ROWS.items():
            cfg, net = act_check.act_model(act, dtype)
            wd, sd = k1.weight_dtype(cfg), k2._saved_dtype(cfg)
            packed = k1.pack_trunk_weights(net, cfg, wd)
            hw = k4.pack_head_weights(net, cfg, wd)
            x1, x2, x3 = points(n1), points(n2), points(n3)
            zs, us = k2._trunk_fwd_grad_cuda(packed, cfg, x3, True)[3:]
            zs4 = k4._trunk_heads_fwd_cuda(packed, hw, cfg, x3, True)[2]
            cs, cf, cg = fc.cotangents(cfg, n3, gen, sd)
            cot = torch.randn(n3, k4.HEAD_COLS, device="cuda", generator=gen)
            cot[:, 7] = 0.0
            bf16 = dtype != "float32"
            bound = act_check.BF16_BOUND if bf16 else fc.F32_BOUND
            calls = {
                "K1": (lambda: k1._trunk_sigma_cuda(packed, cfg, x1, False),
                       lambda: k1._trunk_sigma_plain(packed, cfg, x1, False),
                       ("sigma",), act_check.K1_BOUND, None),
                "K2": (lambda: k2._trunk_fwd_grad_cuda(packed, cfg, x2),
                       lambda: k2._trunk_fwd_grad_plain(packed, cfg, x2),
                       ("sigma", "feats", "gx"), bound, None),
                "K2zs": (lambda: k2._trunk_fwd_grad_cuda(packed, cfg, x3,
                                                         True),
                         lambda: k2._trunk_fwd_grad_plain(packed, cfg, x3,
                                                          True),
                         ("sigma", "feats", "gx", "zs", "us"), bound, None),
                "K3": (lambda: k2._trunk_bwd_cuda(packed, cfg, x3, cs, cf,
                                                  cg, zs, us),
                       lambda: k2._trunk_bwd_plain(packed, cfg, x3, cs, cf,
                                                   cg, zs, us),
                       fc.K3_NAMES, bound,
                       fc.dbsig_scale(packed, cfg, cs, cg, zs)),
                "K4": (lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg,
                                                        x2)[:2],
                       lambda: k4._trunk_heads_fwd_plain(packed, hw, cfg,
                                                         x2)[:2],
                       ("out", "gx"), bound, None),
                "K4zs": (lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg,
                                                          x3, True),
                         lambda: k4._trunk_heads_fwd_plain(packed, hw, cfg,
                                                           x3, True),
                         ("out", "gx", "zs"), bound, None),
                "K5": (lambda: k4._trunk_heads_bwd_cuda(packed, hw, cfg, x3,
                                                        cot, cg, zs4),
                       lambda: k4._trunk_heads_bwd_plain(packed, hw, cfg, x3,
                                                         cot, cg, zs4),
                       fc.K5_NAMES, bound,
                       fc.dbsig_scale(packed, cfg, cot[:, 0], cg, zs4))}
            for kern, base in keys.items():
                kernel, twin, outs, bnd, scale = calls[kern]
                label = f"{kern} {names[act]}, {dtype}"
                got = kernel()
                same_twice(label, got[:len(outs)], kernel()[:len(outs)])
                ref = twin()
                worst, max_abs = 0.0, 0.0
                for name, g_, r_ in zip(outs, got, ref):
                    assert torch.isfinite(g_.float()).all(), (label, name)
                    e = (fc.dbsig_error(g_, r_, scale)
                         if name == "dbsig" and bf16 else rel_l2(g_, r_))
                    # (ReLU: act_check.RELU_KINKED_BOUND where act' flips
                    # reach, see there)
                    b_ = act_check.bound_of(act, kern, name, bnd)
                    assert e <= b_, (label, name, e, b_)
                    worst = max(worst, e)
                    max_abs = max(max_abs, (g_.float() - r_.float()).abs()
                                  .max().item())
                del got, ref
                r = {k: v for k, v in rows[base].items()
                     if not k.startswith("_") and k not in (
                         "launches", "launches_train", "launches_eval",
                         "bf16_over_f32", "uchain_ms", "sweep_ms",
                         "wgrad_ms", "reduce_ms", "library_bf16_ms")}
                r.update(name=f"{rows[base]['name']} [{names[act]}]",
                         act=act, max_abs_err=max_abs, rel_l2=worst,
                         ms=timed(kernel, 5), plain_ms=timed(twin, 1))
                rows[f"{base} {act}"] = r
                print(f"  {label}: relative L2 against its twin {worst:.3e} "
                      f"(bound {bnd:g}); {r['ms']:.3f} ms (polynomial "
                      f"{rows[base]['ms']:.3f}), twin {r['plain_ms']:.1f}",
                      flush=True)
            del x1, x2, x3, zs, us, zs4, cs, cf, cg, cot, calls


# the widths phase: timed steps of each fused run (bfloat16_all and
# float32; bfloat16's are WIDTH_SHORT) and of each unfused one, measured
# first
WIDTH_STEPS = 10
WIDTH_SHORT = 2
WIDTH_UNFUSED = 4


def widths_phase(rows, argv, tmp, gen, peaks, serve, train, check_served,
                 step_check, per_req):
    """Phase `widths`: K1-K5 built for the trunk widths 64, 128 and 256.
    tools/width_check.py's checks (every dtype, each instantiation twice
    bit-identical and held to its twin at the 512 rows' bounds; the exact
    sine and ReLU at 64; 4 layers with the skip at 2 at 64), then per
    width: each instantiation held so again and timed at its main path's
    shape (width_check.kernel_rows, heads_rows: a row of the kernels line
    each), and at bfloat16_all, float32 and bfloat16: the unfused stage-2
    step (--fused_trunk 0 --use_pallas 0; not at bfloat16), one
    16,384-ray request (K1 2 / K2 1 a chunk; not at bfloat16) and one
    with BRDFNERF_FUSED_HEADS set (K1 2 / K4 1 a chunk), each against the
    CPU twins, the fused stage-2 step (K1 2 / K2 1 / K3 1 a step) and the
    fused-heads one (K1 2 / K4 1 / K5 1), each over WIDTH_STEPS timed
    steps (a falling loss; WIDTH_SHORT at bfloat16), and at bfloat16_all
    one step-check point of each."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.models.network import init_network
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.tools import act_check, width_check
    from brdfnerf_tpu_torch.utils.checkpoint import save_checkpoint
    t_phase = time.perf_counter()
    phase("widths")
    width_check.check_all()
    assert not act_check.MISSES, act_check.MISSES
    print(f"  widths: checks {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    fused = dict(zero, K1=2, K2=1, K3=1)
    heads = dict(zero, K1=2, K4=1, K5=1)
    for feat in width_check.WIDTHS:
        t0 = time.perf_counter()
        width_check.kernel_rows(rows, feat, peaks)
        width_check.heads_rows(rows, feat, peaks)
        assert not act_check.MISSES, act_check.MISSES
        print(f"  width {feat}: main-shape rows "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        exp = f"smoke_f{feat}"
        w_args = opts.postprocess(opts.train_parser().parse_args(
            argv + ["--fc_feat", str(feat), "--exp_name", exp]))
        w_dir = os.path.join(tmp, f"run_{exp}")
        opts.dump_opts(w_args, w_dir)
        w_cfg = opts.to_run_config(w_args, device="cuda")
        assert w_cfg.model.feat == feat
        assert w_cfg.render.use_pallas and w_cfg.render.fused_trunk
        save_checkpoint(os.path.join(tmp, "ckpts", exp, "epoch=1.npz"),
                        {"coarse": init_network(w_cfg.model, gen,
                                                device="cuda")}, step=0)
        off = dc.replace(w_cfg.render, use_pallas=False, fused_trunk=False)
        for dtype in ("bfloat16_all", "float32", "bfloat16"):
            m_ = dc.replace(w_cfg.model, compute_dtype=dtype)
            label = f"train step, width {feat}, {dtype}"
            mixed = dtype == "bfloat16"
            steps = WIDTH_SHORT if mixed else WIDTH_STEPS
            scale = 0.1 if dtype == "float32" else 1.0
            r_ = load_renderer(w_dir, 1, compute_dtype=dtype, device="cuda")
            assert r_.cfg.model.feat == feat and r_.cfg.render.use_pallas
            if not mixed:
                # the unfused step first: what the width ran before its
                # kernels
                train(label + ", unfused", zero, mcfg_=m_, rcfg_=off,
                      tcfg_=w_cfg.train, timed_steps=WIDTH_UNFUSED,
                      profiled=False)
                outs, launches = serve(f"request, width {feat}, {dtype}",
                                       dict(zero, K1=2 * per_req,
                                            K2=per_req),
                                       r_, n_req=1, profiled=False)
                rows[f"K1 {dtype} f{feat}"]["launches"] = launches["K1"]
                rows[f"K2 {dtype} f{feat}"]["launches"] = launches["K2"]
                check_served(outs, r_, scale=scale, n_check=256)
                del outs
            trained, launches = train(label, fused, mcfg_=m_,
                                      rcfg_=w_cfg.render, tcfg_=w_cfg.train,
                                      timed_steps=steps, profiled=False)
            rows[f"K2zs {dtype} f{feat}"]["launches"] = launches["K2"]
            rows[f"K3 {dtype} f{feat}"]["launches"] = launches["K3"]
            if dtype == "bfloat16_all":
                step_check(f"width {feat}", trained[-1:],
                           (k2, "_trunk_fwd_grad_cuda",
                            k2._trunk_fwd_grad_plain),
                           (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain),
                           fused, mcfg_=m_, rcfg_=w_cfg.render)
            del trained
            # with the switch: K4 in K2's place in the request, K4 and K5
            # in K2's and K3's in the step
            os.environ[FUSED_HEADS] = "1"
            outs, launches = serve(f"request, width {feat}, {dtype}, fused "
                                   "heads",
                                   dict(zero, K1=2 * per_req, K4=per_req),
                                   r_, n_req=1, profiled=False)
            if not mixed:
                rows[f"K4 {dtype} f{feat}"]["launches"] = launches["K4"]
            check_served(outs, r_, scale=scale, n_check=256)
            del r_, outs
            trained, launches = train(label + ", fused heads", heads,
                                      mcfg_=m_, rcfg_=w_cfg.render,
                                      tcfg_=w_cfg.train, timed_steps=steps,
                                      profiled=False)
            rows[f"K4zs {dtype} f{feat}"]["launches"] = launches["K4"]
            rows[f"K5 {dtype} f{feat}"]["launches"] = launches["K5"]
            if dtype == "bfloat16_all":
                step_check(f"width {feat}, fused heads", trained[-1:],
                           (k4, "_trunk_heads_fwd_cuda",
                            k4._trunk_heads_fwd_plain),
                           (k4, "_trunk_heads_bwd_cuda",
                            k4._trunk_heads_bwd_plain),
                           heads, mcfg_=m_, rcfg_=w_cfg.render)
            del os.environ[FUSED_HEADS], trained
        print(f"  width {feat}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  widths phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the layer-major phase: the timed steps of each of its runs, 12 x 2048
# at bfloat16_all and float32, with the switch off and on, the padded
# width and the wide encoding (on a one-batch store, where the loss must
# fall from the first timed step to the last; the 12 x 2048 bfloat16_all
# run took 10 on the 16-batch store until the K4/K5 runs came), the rays
# of its requests held against the CPU twins and of its step-check point
# (the twins' step on the CPU at 12 x 2048 takes ~1 s a ray), and the
# points of its kernels' checks at 12 x 2048 (and at the other
# LAYER_CONFIGS)
LAYER_SHORT = 2
LAYER_SERVE_CHECK = 64
LAYER_CHECK_RAYS = 32
LAYER_POINTS = 4096
LAYER_POINTS_SMALL = 384
# the layer-major product's edge cases (width_check.LAYER_SIZES): a block
# of one row tile, and at 12 x 2048 a weight gradient of more than one
# split-K slice with a ragged last one
LAYER_POINTS_TILE = 128
LAYER_POINTS_SLICES = 5120


def layers_phase(rows, argv, tmp, gen, peaks, serve, train, check_served,
                 step_check, per_req, bounds, request):
    """Phase `widths, layer-major`: K1-K3 at the shapes the fused family
    does not take (ops/trunk_layers.py, csrc/trunk_layers.cu), and the
    fused family at a padded width.  The libraries' nvcc seconds; each
    layer-major instantiation at every dtype against its twin, twice
    bit-identical (tools/width_check.check_layers: 12 x 2048 on
    LAYER_POINTS_TILE, LAYER_POINTS and LAYER_POINTS_SLICES points; 4 x
    768 at the exact sine and ReLU, 4 x 128 and 8 x 128 with a 144-lane
    encoding and width 96, which the fused family runs at 128, on
    LAYER_POINTS_TILE and LAYER_POINTS_SMALL); the 12 x 2048 rows of the
    kernels line at their main shapes (width_check.layer_rows:
    bfloat16_all, and the
    float32 step's K2 saving zs/us and K3); then the 12 x 2048 flagship
    (the heads, sampling and losses of the flagship, the trunk tensor
    parallelism exists for, on one card): one 16,384-ray request at
    bfloat16_all (K1L 2 / K2L 1 a chunk; a second one profiled) against
    the CPU twins on
    LAYER_SERVE_CHECK rays, the stage-2 step at bfloat16_all (K1L 2 / K2L
    1 / K3L 1 a step, LAYER_SHORT timed on a one-batch store, a falling
    loss, peak memory, one step profiled) and a step-check point on its
    weights, LAYER_CHECK_RAYS
    rays, at the bf16 bounds (`bounds`) times width_check.sum_length_scale
    against the twins on the card
    (the twins on the CPU printed beside: between the card and the CPU
    the twins alone moved the 12 x 2048 loss by 2.3e-3 on an H100, no
    kernel in either); LAYER_SHORT float32 steps and a step-check point on
    their weights at the float32 bounds (`bounds` over ten; also against
    the unfused step on the card); at width 96 (K1-K3 of the fused family
    at 128) and with a 144-lane encoding (24 frequencies; the layer-major
    family at 128) a request and LAYER_SHORT steps each: at width 96 the
    request against the CPU twins, at 144 lanes every K1 and K2 call of
    the request `request` held to its twins on its own inputs
    (held_on_inputs: no render there determines another's sample points).
    Then K4/K5 with BRDFNERF_FUSED_HEADS set: check_layers held
    them above beside K1-K3; the 12 x 2048 rows of the layer-major K4, K4
    saving zs and K5 at bfloat16_all, and K4 saving zs and K5 at float32
    (layer_rows); at 12 x 2048 a request (K1L 2 / K4L 1 a chunk) against
    the CPU twins on LAYER_SERVE_CHECK rays, LAYER_SHORT bfloat16_all steps
    (K1L 2 / K4L 1 / K5L 1; a one-batch store, the loss falling from the
    first timed step to the last; peak memory; one step profiled) and a
    step-check point as the switch-off one, LAYER_SHORT float32 steps and
    a step-check point at the float32 bounds; at width 96 (the fused pair
    at 128, zero-padded) and with the 144-lane encoding (the layer-major
    pair) a request and LAYER_SHORT steps each, the 144-lane request's K1
    and K4 calls held on their own inputs.  Its seconds, and those of the
    K4/K5 work."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.models.network import init_network, init_params
    from brdfnerf_tpu_torch.ops import cuda_build
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.tools import act_check, width_check
    from brdfnerf_tpu_torch.utils.checkpoint import save_checkpoint
    t_phase = time.perf_counter()
    heads_s = 0.0     # the seconds of the K4/K5 work
    phase("widths, layer-major")
    for key, rec in cuda_build.build_log.items():
        if key.startswith("trunk_layers"):
            print(f"  {key}: nvcc {rec['seconds']:.1f} s", flush=True)
    configs = width_check.LAYER_CONFIGS
    width_check.check_layers((LAYER_POINTS_TILE, LAYER_POINTS,
                              LAYER_POINTS_SLICES), configs=configs[:1])
    width_check.check_layers((LAYER_POINTS_TILE, LAYER_POINTS_SMALL),
                             configs=configs[1:])
    assert not act_check.MISSES, act_check.MISSES
    t0 = time.perf_counter()
    print(f"  checks {t0 - t_phase:.1f} s", flush=True)
    width_check.layer_rows(rows, peaks, dtypes=("bfloat16_all",),
                           kinds=("K1", "K2", "K2zs", "K3"))
    width_check.layer_rows(rows, peaks, dtypes=("float32",),
                           kinds=("K2zs", "K3"))
    assert not act_check.MISSES, act_check.MISSES
    t1 = time.perf_counter()
    print(f"  12 x 2048 main-shape rows {t1 - t0:.1f} s", flush=True)
    width_check.layer_rows(rows, peaks, dtypes=("bfloat16_all",),
                           kinds=("K4", "K4zs", "K5"))
    width_check.layer_rows(rows, peaks, dtypes=("float32",),
                           kinds=("K4zs", "K5"))
    assert not act_check.MISSES, act_check.MISSES
    heads_s += time.perf_counter() - t1
    print(f"  12 x 2048 main-shape rows of K4/K5 "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    wide_serve = dict(zero, K1L=2 * per_req, K2L=per_req)
    wide_step = dict(zero, K1L=2, K2L=1, K3L=1)
    heads_serve = dict(zero, K1L=2 * per_req, K4L=per_req)
    heads_step = dict(zero, K1L=2, K4L=1, K5L=1)
    k4_pair = ((k4, "_trunk_heads_fwd_cuda", k4._trunk_heads_fwd_plain),
               (k4, "_trunk_heads_bwd_cuda", k4._trunk_heads_bwd_plain))

    def run_dir(exp, extra):
        w_args = opts.postprocess(opts.train_parser().parse_args(
            argv + extra + ["--exp_name", exp]))
        w_dir = os.path.join(tmp, f"run_{exp}")
        opts.dump_opts(w_args, w_dir)
        w_cfg = opts.to_run_config(w_args, device="cuda")
        assert w_cfg.render.use_pallas and w_cfg.render.fused_trunk
        save_checkpoint(os.path.join(tmp, "ckpts", exp, "epoch=1.npz"),
                        {"coarse": init_network(w_cfg.model, gen,
                                                device="cuda")}, step=0)
        return w_dir, w_cfg

    # the 12 x 2048 trunk
    t0 = time.perf_counter()
    w_dir, w_cfg = run_dir("smoke_12x2048", ["--fc_feat", "2048",
                                             "--fc_layers", "12"])
    m_, off = w_cfg.model, dc.replace(w_cfg.render, use_pallas=False,
                                      fused_trunk=False)
    assert (m_.feat, m_.layers, m_.skips) == (2048, 12, (4,))
    r_ = load_renderer(w_dir, 1, device="cuda")
    outs, launches = serve("request, 12 x 2048, bfloat16_all", wide_serve,
                           r_, n_req=1)
    rows["K1 bfloat16_all f2048"]["launches"] = launches["K1L"]
    rows["K2 bfloat16_all f2048"]["launches"] = launches["K2L"]
    check_served(outs, r_, n_check=LAYER_SERVE_CHECK)
    del outs, r_
    print(f"  12 x 2048 request {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    trained, launches = train("train step, 12 x 2048, bfloat16_all",
                              wide_step, mcfg_=m_, rcfg_=w_cfg.render,
                              tcfg_=w_cfg.train, timed_steps=LAYER_SHORT,
                              store_batches=1)
    rows["K2zs bfloat16_all f2048"]["launches"] = launches["K2L"]
    rows["K3 bfloat16_all f2048"]["launches"] = launches["K3L"]
    print(f"  12 x 2048 steps {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # the bf16 bounds times sum_length_scale (2 at width 2048), as
    # width_check holds these kernels: on an H100 at 700 W the twins on
    # the card sat 0.166 from the twins on the CPU on the well-conditioned
    # rays (two summation orders, no kernel), past the 512 check's 0.1, and
    # the kernels 9.90e-2 from the twins on the card
    scale = width_check.sum_length_scale(m_.feat)
    step_check("12 x 2048, layer-major, bfloat16_all", trained[-1:],
               (k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
               (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain), wide_step,
               mcfg_=m_, rcfg_=w_cfg.render,
               bounds_={k: v * scale for k, v in bounds.items()},
               timed_steps=LAYER_SHORT, n_rays=LAYER_CHECK_RAYS,
               cpu_held=False)
    del trained
    print(f"  12 x 2048 bfloat16_all step check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    m32 = dc.replace(m_, compute_dtype="float32")
    trained, launches = train("train step, 12 x 2048, float32", wide_step,
                              mcfg_=m32, rcfg_=w_cfg.render,
                              tcfg_=w_cfg.train, timed_steps=LAYER_SHORT,
                              profiled=False, store_batches=1)
    rows["K2zs float32 f2048"]["launches"] = launches["K2L"]
    rows["K3 float32 f2048"]["launches"] = launches["K3L"]
    print(f"  12 x 2048 float32 steps {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    step_check("12 x 2048, layer-major, float32", trained[-1:],
               (k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
               (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain), wide_step,
               mcfg_=m32, rcfg_=w_cfg.render,
               bounds_={k: v / 10 for k, v in bounds.items()},
               normal_err=NORMAL_ERR_F32, timed_steps=LAYER_SHORT,
               n_rays=LAYER_CHECK_RAYS, unfused=off)
    del trained
    print(f"  12 x 2048 step check {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the 12 x 2048 trunk with the switch: the layer-major K4 and K5 in
    # K2's and K3's place, the flagship heads in no torch op
    t0 = time.perf_counter()
    os.environ[FUSED_HEADS] = "1"
    try:
        r_ = load_renderer(w_dir, 1, device="cuda")
        outs, launches = serve("request, 12 x 2048, bfloat16_all, fused "
                               "heads", heads_serve, r_, n_req=1,
                               profiled=False)
        rows["K4 bfloat16_all f2048"]["launches"] = launches["K4L"]
        check_served(outs, r_, n_check=LAYER_SERVE_CHECK)
        del outs, r_
        print(f"  12 x 2048 request, fused heads "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t1 = time.perf_counter()
        trained, launches = train(
            "train step, 12 x 2048, bfloat16_all, fused heads", heads_step,
            mcfg_=m_, rcfg_=w_cfg.render, tcfg_=w_cfg.train,
            timed_steps=LAYER_SHORT, store_batches=1)
        rows["K4zs bfloat16_all f2048"]["launches"] = launches["K4L"]
        rows["K5 bfloat16_all f2048"]["launches"] = launches["K5L"]
        step_check("12 x 2048, layer-major, fused heads, bfloat16_all",
                   trained[-1:], *k4_pair, heads_step, mcfg_=m_,
                   rcfg_=w_cfg.render,
                   bounds_={k: v * scale for k, v in bounds.items()},
                   timed_steps=LAYER_SHORT, n_rays=LAYER_CHECK_RAYS,
                   cpu_held=False)
        del trained
        print(f"  12 x 2048 bfloat16_all steps and step check, fused heads "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        t1 = time.perf_counter()
        trained, launches = train(
            "train step, 12 x 2048, float32, fused heads", heads_step,
            mcfg_=m32, rcfg_=w_cfg.render, tcfg_=w_cfg.train,
            timed_steps=LAYER_SHORT, profiled=False, store_batches=1)
        rows["K4zs float32 f2048"]["launches"] = launches["K4L"]
        rows["K5 float32 f2048"]["launches"] = launches["K5L"]
        # held to the twins on the card, as the bfloat16_all point (the
        # switch-off float32 point above holds the trunk's kernels to the
        # twins on the CPU and to the unfused step)
        step_check("12 x 2048, layer-major, fused heads, float32",
                   trained[-1:], *k4_pair, heads_step, mcfg_=m32,
                   rcfg_=w_cfg.render,
                   bounds_={k: v / 10 for k, v in bounds.items()},
                   normal_err=NORMAL_ERR_F32, timed_steps=LAYER_SHORT,
                   n_rays=LAYER_CHECK_RAYS, cpu_held=False)
        del trained
        print(f"  12 x 2048 float32 steps and step check, fused heads "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    finally:
        del os.environ[FUSED_HEADS]
    heads_s += time.perf_counter() - t0

    # a padded width (the fused family at 128) and a 144-lane encoding
    # (the layer-major family at width 128), each with the switch off and
    # on
    t0 = time.perf_counter()
    fused = dict(zero, K1=2 * per_req, K2=per_req)
    fused_step = dict(zero, K1=2, K2=1, K3=1)
    fused_heads = dict(zero, K1=2 * per_req, K4=per_req)
    fused_heads_step = dict(zero, K1=2, K4=1, K5=1)
    for label, feat, freqs, want, want_step, want_h, want_h_step in (
            ("width 96", 96, 0, fused, fused_step, fused_heads,
             fused_heads_step),
            ("a 144-lane encoding", 128, 24, wide_serve, wide_step,
             heads_serve, heads_step)):
        w_dir, w_cfg = run_dir(f"smoke_f{feat}_m{freqs}",
                               ["--fc_feat", str(feat)])
        r_ = load_renderer(w_dir, 1, device="cuda")
        m_ = w_cfg.model
        if freqs:
            # mapping_sizes is the Python API's (the CLIs keep 10)
            m_ = dc.replace(m_, mapping_sizes=(freqs, 4))
            assert m_.xyz_in_dim == 144
            r_ = dc.replace(r_, cfg=dc.replace(r_.cfg, model=m_),
                            net=init_params(m_, gen, device="cuda"))
        outs, _ = serve(f"request, {label}, bfloat16_all", want, r_,
                        n_req=1, profiled=False)
        if freqs:
            # 24 octaves: a render is chaotic (held_on_inputs); on an H100
            # the twins on the card sat 9.37e-3 mean in rgb from the
            # twins on the CPU, no kernel in either
            check_served(outs, r_, n_check=0)
            n_held = held_on_inputs(r_, request, f"request, {label}")
            assert n_held == 3 * per_req, n_held
            print(f"  K1 and K2 held on the request's own inputs: {n_held} "
                  "calls", flush=True)
        else:
            check_served(outs, r_, n_check=256)
        del outs
        train(f"train step, {label}, bfloat16_all", want_step, mcfg_=m_,
              rcfg_=w_cfg.render, tcfg_=w_cfg.train,
              timed_steps=LAYER_SHORT, profiled=False, store_batches=1)
        # with the switch: K4 in K2's place, K4 and K5 in K2's and K3's
        t1 = time.perf_counter()
        os.environ[FUSED_HEADS] = "1"
        try:
            outs, _ = serve(f"request, {label}, bfloat16_all, fused heads",
                            want_h, r_, n_req=1, profiled=False)
            if freqs:
                check_served(outs, r_, n_check=0)
                n_held = held_on_inputs(r_, request,
                                        f"request, {label}, fused heads")
                assert n_held == 3 * per_req, n_held
                print(f"  K1 and K4 held on the request's own inputs: "
                      f"{n_held} calls", flush=True)
            else:
                check_served(outs, r_, n_check=256)
            del outs
            train(f"train step, {label}, bfloat16_all, fused heads",
                  want_h_step, mcfg_=m_, rcfg_=w_cfg.render,
                  tcfg_=w_cfg.train, timed_steps=LAYER_SHORT,
                  profiled=False, store_batches=1)
        finally:
            del os.environ[FUSED_HEADS]
        del r_
        heads_s += time.perf_counter() - t1
    print(f"  width 96 and 144 lanes {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"  K4/K5 (fused heads) work in the phase {heads_s:.1f} s",
          flush=True)
    print(f"  widths, layer-major phase: {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)


def make_store(n_rays: int, rng: np.random.RandomState):
    """Synthetic satellite-style rays [o(3) d(3) near far sun(3)] with their
    targets, in the layout of the JAX package's __graft_entry__._make_batch,
    except that the GT depth's std is nonzero on part of the rays (so the
    GT-depth band of the guided sampler draws)."""
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d = np.tile(np.asarray([[0.05, 0.02, -1.0]], np.float32), (n_rays, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.zeros((n_rays, 1), np.float32)
    far = np.full((n_rays, 1), 2.0, np.float32)
    sun = np.tile(np.asarray([[0.3, 0.2, 0.93]], np.float32), (n_rays, 1))
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    return {
        "rays": np.concatenate([o, d, near, far, sun], axis=1),
        "rgbs": rng.uniform(0, 1, (n_rays, 3)).astype(np.float32),
        "ts": np.zeros((n_rays,), np.int32),
        "depths": np.stack(
            [rng.uniform(0.5, 1.5, n_rays), np.ones(n_rays)],
            axis=1).astype(np.float32),
        "valid_depth": (rng.uniform(0, 1, n_rays) > 0.5).astype(np.int32),
        "depth_std": np.where(rng.uniform(0, 1, n_rays) > 0.3,
                              rng.uniform(0.02, 0.1, n_rays),
                              0.0).astype(np.float32),
        "normals": np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32),
                           (n_rays, 1)),
        "valid_normal": np.ones((n_rays,), np.float32),
    }


# the bf16 contract's error in one sample's analytic normal: bf16's
# relative precision (K2's gx lies 1.6e-3 .. 4.1e-3 in relative L2 from its
# twin's at the trained weights)
NORMAL_ERR = 2.0 ** -8
# ... and the float32 contract's (the split products'): K2's gx lies ~3e-5
# in relative L2 from its exact twin's (tools/f32_check.py), 2^-14 = 6.1e-5
NORMAL_ERR_F32 = 2.0 ** -14


def ill_conditioned(weights, normals, ci, cv, bound, normal_err=NORMAL_ERR):
    """The rays whose step gradient the bf16 contract leaves undetermined at
    `bound`.  weights (n_rays, n_samples) and normals (n_rays, n_samples,
    3) are the compositing weights and the samples' analytic normals; ci,
    cv (n_rays,) the cosines of the summed normal
    normalize(sum_s w_s n_s) with the sun and the view, before RPV clamps
    them to 1e-5.  The BRDF sees a ray's normal only through RPV's Minnaert
    factor M1 = (ci cv (ci + cv) + 1e-5)^(k - 1) of the clamped cosines.
    An error of NORMAL_ERR in each sample's normal moves the summed normal,
    and so each cosine, by up to err = NORMAL_ERR * sum_s w_s /
    |sum_s w_s n_s| (the normalisation amplifies it where the samples'
    normals cancel).  Where both cosines lie above -err (neither held at
    the clamp), d ln M1 / dc ~ 1 / c moves by err / c relative, so the
    ray's gradient is undetermined at `bound` where either cosine lies
    below err / bound; where one cosine is held at the clamp, M1 hardly
    depends on the normal.  normal_err is the contract's error in one
    sample's normal (NORMAL_ERR: bf16's; NORMAL_ERR_F32 at float32).
    Returns a bool tensor (n_rays,)."""
    summed = torch.sum(weights[..., None] * normals, -2)
    err = normal_err * weights.sum(-1) / summed.norm(dim=-1).clamp_min(1e-30)
    return (ci > -err) & (cv > -err) & (torch.minimum(ci, cv) < err / bound)


def rpv_ill_conditioned(res, rgbs, mcfg, rcfg, bound,
                        normal_err=NORMAL_ERR):
    """ill_conditioned on the rays of a training render's result `res`
    (rgbs, mcfg and rcfg unused: brdf_ill_conditioned's signature), on
    every pass that shades with RPV: the coarse one, and the fine one of a
    fine network (--n_importance)."""
    return torch.stack([ill_conditioned(
        res[f"weights_{typ}"], res[f"normal_an_{typ}"],
        res[f"nr_sun_{typ}"].flatten(), res[f"nr_vw_{typ}"].flatten(), bound,
        normal_err) for typ in ("coarse", "fine")
        if f"weights_{typ}" in res]).any(0)


def ill_conditioned_rays(net, mcfg, rcfg, batch, draws, gates, bound,
                         normal_err=NORMAL_ERR):
    """ill_conditioned on the rays of a training batch, read from `net`'s
    render with `draws` (the twins on the CPU: nothing of the kernels)."""
    from brdfnerf_tpu_torch.render.render import RenderInputs, render_rays
    inp = RenderInputs(rays=batch["rays"], ts=batch["ts"],
                       valid_depth=batch["valid_depth"],
                       target_depths=batch["depths"],
                       target_std=batch["depth_std"],
                       cos_irra_on=gates.cos_irra_on)
    with torch.no_grad():
        res = render_rays(net, mcfg, rcfg, inp, train=True, draws=draws)
    return rpv_ill_conditioned(res, batch["rgbs"], mcfg, rcfg, bound,
                               normal_err)


def _ray_brdf(mcfg, rcfg, sun, view, normal, q):
    """The per-ray BRDF that inference_spsbrdf shades with, of the family
    mcfg names, on the per-ray inputs q (albedo and the family's heads,
    weight-summed)."""
    from brdfnerf_tpu_torch.brdf.hapke import hapke_brdf
    from brdfnerf_tpu_torch.brdf.microfacet import microfacet_brdf
    from brdfnerf_tpu_torch.brdf.rpv import rpv_brdf
    if mcfg.roughness and rcfg.apply_brdf:
        return microfacet_brdf(sun, view, normal, q["alb"], q["rough"],
                               f0=mcfg.fresnel_f0)[1]
    if mcfg.rpv and rcfg.apply_brdf:
        rhoc = q["alb"] if mcfg.func_h == 2 else q.get("rhoc")
        return rpv_brdf(sun, view, normal, q["alb"], q.get("k"),
                        q.get("th"), rhoc)[0]
    return hapke_brdf(sun, view, normal, q["alb"], q.get("b"), q.get("c"),
                      q.get("theta"), hpk_scl=mcfg.hpk_scl,
                      shell_hapke=mcfg.shell_hapke)[0]


def brdf_ill_conditioned(res, rgbs, mcfg, rcfg, bound,
                         normal_err=NORMAL_ERR):
    """The rays whose step gradient the contract leaves undetermined at
    `bound`, for any BRDF family, read by autograd from a training
    render's result `res` (the twins on the CPU: nothing of the kernels)
    and the rays' target colours.  The BRDF sees a ray's normals only
    through the summed normal n = normalize(sum_s w_s n_s); an error of
    normal_err in each sample's normal turns n by up to err = normal_err *
    sum_s w_s / |sum_s w_s n_s|.  In float64, the gradient of the ray's
    colour loss with respect to n and to the BRDF's other per-ray inputs
    (albedo, the family's heads), each a block, is taken at n and at n
    turned by err along +-two tangent directions; a ray is undetermined
    where any block moves by more than `bound` of its size (floored at the
    batch's median size of that block, so that a block the ray hardly
    feeds does not count).  Where the BRDF divides by a cosine (RPV's
    Minnaert factor, Hapke's 1 / cos i and H function, Microfacet's
    1 / (|l.n| |v.n|) and GGX's 1 / cos^4), the gradient moves like
    err / cos, so grazing rays are set aside; a clamped cosine moves
    nothing.  Returns a bool tensor (n_rays,)."""
    from brdfnerf_tpu_torch.brdf.common import clip
    f64 = torch.float64
    w = res["weights_coarse"].to(f64)
    summed = torch.sum(w[..., None] * res["normal_an_coarse"].to(f64), -2)
    length = summed.norm(dim=-1).clamp_min(1e-30)
    n = summed / length[:, None]
    err = normal_err * w.sum(-1) / length

    def wsum(v):
        return torch.sum(w[..., None] * v.to(f64), -2)
    pad = mcfg.rgb_padding
    q = {"alb": wsum(res["albedo_coarse"] * (1 + 2 * pad) - pad)}
    for name, key in (("k", "rpv_k"), ("th", "rpv_theta"),
                      ("rhoc", "rpv_rhoc"), ("b", "hpk_b"), ("c", "hpk_c"),
                      ("rough", "roughness")):
        if f"{key}_coarse" in res:
            q[name] = wsum(res[f"{key}_coarse"])
    if "hpk_theta_coarse" in res:
        q["theta"] = wsum(res["hpk_theta_coarse"])[:, 0]
    sun = res["sun_d_coarse"].reshape(-1, 3).to(f64)
    view = res["rays_d_coarse"].reshape(-1, 3).to(f64)
    irr = res["irradiance_coarse"][:, -1, :].to(f64)
    target = torch.as_tensor(rgbs).to(f64)

    def blocks(normal):
        leaves = [normal.detach().clone().requires_grad_(True)] + [
            v.detach().clone().requires_grad_(True) for v in q.values()]
        with torch.enable_grad():
            rgb = clip(irr * _ray_brdf(mcfg, rcfg, sun, view, leaves[0],
                                       dict(zip(q, leaves[1:]))), 0.0, 1.0)
            grads = torch.autograd.grad(((rgb - target) ** 2).sum(), leaves,
                                        allow_unused=True)
        return [torch.zeros_like(v) if g is None else g.reshape(len(v), -1)
                for g, v in zip(grads, leaves)]

    g0 = blocks(n)
    axis = torch.zeros_like(n)
    axis[:, 0] = (n[:, 2].abs() >= 0.9).to(f64)
    axis[:, 2] = (n[:, 2].abs() < 0.9).to(f64)
    t1 = torch.linalg.cross(n, axis)
    t1 = t1 / t1.norm(dim=-1, keepdim=True)
    t2 = torch.linalg.cross(n, t1)
    moved = torch.zeros_like(err)
    for t in (t1, -t1, t2, -t2):
        turned = n + err[:, None] * t
        g1 = blocks(turned / turned.norm(dim=-1, keepdim=True))
        for a0, a1 in zip(g0, g1):
            size = a0.norm(dim=-1)
            floor = torch.maximum(size, size.median()).clamp_min(1e-300)
            moved = torch.maximum(moved, (a1 - a0).norm(dim=-1) / floor)
    return moved > bound


def brdf_ill_conditioned_rays(net, mcfg, rcfg, batch, draws, gates, bound,
                              normal_err=NORMAL_ERR):
    """brdf_ill_conditioned on the rays of a training batch, read from
    `net`'s render with `draws` (the twins on the CPU)."""
    from brdfnerf_tpu_torch.render.render import RenderInputs, render_rays
    inp = RenderInputs(rays=batch["rays"], ts=batch["ts"],
                       valid_depth=batch["valid_depth"],
                       target_depths=batch["depths"],
                       target_std=batch["depth_std"],
                       cos_irra_on=gates.cos_irra_on)
    with torch.no_grad():
        res = render_rays(net, mcfg, rcfg, inp, train=True, draws=draws)
    return brdf_ill_conditioned(res, batch["rgbs"], mcfg, rcfg, bound,
                                normal_err)


# the two-stage workflow through the port's train CLI (phase 8)
AOI_SIZE = 256          # 65,536 rays an image; 2 train + 1 test image
# one epoch of 128 steps at batch 1,024 a stage (256 until the float32
# phases came, whose time this cut pays for in part)
WF_STEPS = 128
WF_SCAN_STEPS = 16
WF_CHUNKS = 2 * -(-AOI_SIZE * AOI_SIZE // CHUNK)   # a validation's chunks


def workflow(root, reset_counts, counts, bare_rays_s, family=None,
             smi="", width=512):
    """Stage 1, then stage 2 handed off from stage 1's last checkpoint,
    through brdfnerf_tpu_torch.cli.train.main on the card at the flagship's
    width, on the port's synthetic AOI; then a resume of stage 2 for 2
    steps, and 16 stage-2 steps with --scan_chunk 8 against 16 with
    --scan_chunk 1.  Checked: launches per step (validation's apart),
    falling losses, checkpoints at the cadence (stage 2's carrying the RPV
    heads), finite validation psnr / ssim / DSM MAE for every validation
    epoch, the resume's step count and learning rate, and the scan's
    per-step losses.  Reported: the AOI build, ingestion and validation
    times, fit's rays/s against phase 6's bare step, and the device's busy
    share over fit's loop.

    With `family` ("hapke" or "microfacet"), the family's workflow instead:
    its shaded AOI (build_aoi(bumpy=True, brdf=HAPKE_GT | MICROFACET_GT)),
    stage 1 and stage 2 (the family's heads) of FAMILY_WF_STEPS each, the
    launches of their steps and validations held, and the eval CLI on
    stage 2 (K1 2 / K2 1 a chunk, finite scores); returns its scores.
    With `width` (64, 128 or 256), the same two stages and eval at that
    trunk width with the flagship's RPV(111) heads on the Lambertian AOI:
    the [kernels] lines name K1 and K2 + K3 at the width."""
    from torch.profiler import ProfilerActivity, profile
    from brdfnerf_tpu_torch.cli import train as cli_train
    from brdfnerf_tpu_torch.data.satellite import (SatelliteConfig,
                                                   SatelliteDataset)
    from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
    from brdfnerf_tpu_torch.parallel import train_step as ts
    from brdfnerf_tpu_torch.train import Trainer

    from brdfnerf_tpu_torch.data import synth_aoi
    t0 = time.perf_counter()
    gt = {None: None, "hapke": synth_aoi.HAPKE_GT,
          "microfacet": synth_aoi.MICROFACET_GT}[family]
    aoi = build_aoi(os.path.join(root, "aoi"), size=AOI_SIZE,
                    **({} if gt is None else dict(bumpy=True, brdf=dict(gt))))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sat = SatelliteConfig(root_dir=aoi["root"], aoi_id=aoi["aoi_id"],
                          mod_alt_bound=True)
    n_rays = SatelliteDataset(sat, "train").store["rays"].shape[0]
    val_ds = SatelliteDataset(sat, "val")
    for i in range(len(val_ds)):
        val_ds.get_image(i)
    ingest_s = time.perf_counter() - t0
    print(f"  AOI {AOI_SIZE} px built in {build_s:.3f} s; {n_rays} training "
          f"rays and {len(val_ds)} validation images ingested in "
          f"{ingest_s:.3f} s", flush=True)
    assert n_rays == 2 * AOI_SIZE * AOI_SIZE

    # hooks, read after each run: every step's loss (a device tensor, no
    # sync) and learning rate, the launches and seconds of validation, and
    # fit's wall time without its epoch ends
    rec = {"loss": [], "lr": [], "val": {}, "val_s": [], "fit_s": 0.0,
           "epoch_end_s": 0.0, "profile": False, "busy": None}
    saved = (ts.compute_losses, ts.Optimizer.step, Trainer.validate,
             Trainer.fit, Trainer._on_epoch_end)

    def compute_losses(*a, **k):
        out = saved[0](*a, **k)
        rec["loss"].append(out[0].detach())
        return out

    def opt_step(self, opt, k):
        rec["lr"].append((k, self.schedule(k)))
        return saved[1](self, opt, k)

    def validate(self, epoch):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved[2](self, epoch)
        torch.cuda.synchronize()
        rec["val_s"].append(time.perf_counter() - t0)
        for k, v in counts().items():
            rec["val"][k] = rec["val"].get(k, 0) + v - before.get(k, 0)
        return out

    def fit(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rec["profile"]:
            rec["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            rec["prof"].start()
            rec["t_prof"] = t0
        out = saved[3](self, *a, **k)
        torch.cuda.synchronize()
        rec["fit_s"] = time.perf_counter() - t0
        return out

    def on_epoch_end(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rec.get("prof") is not None and k.get("final"):
            # the loop's window ends where the final epoch end begins
            wall = t0 - rec["t_prof"]
            rec["prof"].stop()
            dev = sum(ev.self_device_time_total
                      for ev in rec["prof"].key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
            rec["busy"] = (dev / 1e6, wall)
            rec["prof"] = None
        out = saved[4](self, *a, **k)
        torch.cuda.synchronize()
        rec["epoch_end_s"] += time.perf_counter() - t0
        return out

    (ts.compute_losses, ts.Optimizer.step, Trainer.validate, Trainer.fit,
     Trainer._on_epoch_end) = (compute_losses, opt_step, validate, fit,
                               on_epoch_end)
    logs, ckpts = os.path.join(root, "logs"), os.path.join(root, "ckpts")
    base = ["--root_dir", aoi["root"], "--gt_dir", aoi["gt_dir"],
            "--aoi_id", aoi["aoi_id"], "--logs_dir", logs,
            "--ckpts_dir", ckpts, "--model", "spsbrdf-nerf", "--mapping",
            "--fc_feat", str(width), "--fc_layers", "8", "--n_samples",
            str(N_SAMPLES), "--guided_samples", str(N_SAMPLES),
            "--batch_size", str(BATCH), "--lr", "5e-4", "--ds_lambda", "10",
            "--compute_dtype", "bfloat16_all", "--chunk", str(CHUNK)]
    heads = ["--normal", "analystic", "--sun_v", "analystic", "--funcM",
             "1", "--funcF", "1", "--funcH", "1", "--brdf_on", "0",
             "--nr_reg_an_lambda", "0.1", "--hs_lambda", "0.5"]
    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

    def run(label, argv, steps, want_train, want_val, profiled=False,
            kernels=()):
        """One CLI run: the launches of its steps (validation's apart)
        against want_train, validation's against want_val per
        validation, and its [kernels] line naming each of `kernels`;
        returns the steps' losses and learning rates."""
        import contextlib
        import io
        for k in ("loss", "lr", "val_s"):
            rec[k] = []
        rec["val"], rec["epoch_end_s"], rec["profile"] = {}, 0.0, profiled
        reset_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli_train.main(argv) == 0
        wall = time.perf_counter() - t0
        sys.stdout.write(out.getvalue())
        line = [ln for ln in out.getvalue().splitlines()
                if ln.startswith("[kernels]")]
        assert len(line) == 1 and all(k in line[0] for k in kernels), line
        launches = counts()
        n_val = len(rec["val_s"])
        train = {k: v - rec["val"].get(k, 0) for k, v in launches.items()}
        want_v = {k: v * n_val for k, v in want_val.items()}
        print(f"  {label}: {steps} steps, {n_val} validations; launches in "
              f"the steps {train}, in validation {rec['val']}", flush=True)
        assert train == dict(zero, **want_train), train
        assert rec["val"] == dict(zero, **want_v), rec["val"]
        losses = [float(v) for v in rec["loss"]]
        assert len(losses) == steps and all(np.isfinite(losses)), losses
        loop_s = rec["fit_s"] - rec["epoch_end_s"]
        print(f"  {label}: command {wall:.3f} s; fit {rec['fit_s']:.3f} s, "
              f"of which epoch ends (validation, checkpoints) "
              f"{rec['epoch_end_s']:.3f} s; the loop {steps * BATCH / loop_s:.1f}"
              f" rays/s (phase 6's bare step: {bare_rays_s:.1f} rays/s, "
              f"mean); validation seconds "
              f"{[round(v, 3) for v in rec['val_s']]}", flush=True)
        return losses, list(rec["lr"])

    def scalars(exp):
        with open(os.path.join(logs, exp, "scalars.jsonl")) as f:
            return [json.loads(ln) for ln in f]

    def check_outputs(exp, epochs, keys):
        """Checkpoints and optimizer states at every epoch, `keys` among
        the last one's parameters, and finite validation scalars for every
        validation epoch."""
        for e in range(epochs):
            for suffix in (".npz", ".opt.npz"):
                assert os.path.exists(os.path.join(
                    ckpts, exp, f"epoch={e}{suffix}")), (exp, e, suffix)
        with np.load(os.path.join(ckpts, exp,
                                  f"epoch={epochs - 1}.npz")) as z:
            assert all(any(f.startswith(f"coarse/{k}/") for f in z.files)
                       for k in keys), (exp, z.files)
        val = [r for r in scalars(exp) if any(k.startswith("val/")
                                              for k in r)]
        assert len(val) == epochs, (exp, len(val))
        for r in val:
            for m in ("psnr", "ssim", "mae"):
                v = [x for k, x in r.items() if k.startswith(f"val/{m}_")]
                assert v and all(np.isfinite(v)), (exp, m, r)
        print(f"  {exp}: checkpoints at epochs 0..{epochs - 1}; validation "
              + "; ".join(f"step {r['step']}: psnr {r['val/psnr_1']:.3f} "
                          f"ssim {r['val/ssim_1']:.4f} MAE "
                          f"{r['val/mae_1']:.3f} m" for r in val),
              flush=True)

    def falls(label, losses):
        first, last = np.mean(losses[:16]), np.mean(losses[-16:])
        print(f"  {label}: loss mean of the first 16 steps {first:.5f}, of "
              f"the last 16 {last:.5f}", flush=True)
        assert last < first, (label, first, last)

    if family is not None or width != 512:
        scores = family_runs(family, base, run, check_outputs, falls, logs,
                             ckpts, reset_counts, counts, smi, width)
        (ts.compute_losses, ts.Optimizer.step, Trainer.validate, Trainer.fit,
         Trainer._on_epoch_end) = saved
        return scores

    # expected launches, from the code: stage 1 (no analytic normals, no
    # sun visibility) runs K1 once a step for the depth probe and the trunk
    # through cuBLAS; stage 2 runs K1 for the probe and, from its first
    # BRDF step (step > brdf_on * max_steps = 0), once more for the sun
    # march, and K2 (saving zs/us) and K3 once a step.  A validation renders
    # 2 images of WF_CHUNKS / 2 chunks and one cross-section row: per
    # render K1 once (stage 1), or K1 twice and K2 once (stage 2)
    epochs = WF_STEPS * BATCH // n_rays
    s1 = "stage1"
    losses, _ = run(s1, base + ["--exp_name", s1, "--max_train_steps",
                                str(WF_STEPS)], WF_STEPS,
                    {"K1": WF_STEPS}, {"K1": WF_CHUNKS + 1})
    falls(s1, losses)
    check_outputs(s1, epochs, ("fc_net", "sigma_from_xyz", "rgb_from_xyzdir"))
    handoff = os.path.join(ckpts, s1, f"epoch={epochs - 1}.npz")
    s2 = "stage2"
    stage2 = base + heads + ["--in_ckpts", handoff]
    want2 = {"K1": 2 * WF_STEPS - 1, "K2": WF_STEPS, "K3": WF_STEPS}
    val2 = {"K1": 2 * (WF_CHUNKS + 1), "K2": WF_CHUNKS + 1}
    losses, _ = run(s2, stage2 + ["--exp_name", s2, "--max_train_steps",
                                  str(WF_STEPS)], WF_STEPS, want2, val2)
    # step 0 is the Lambertian phase, step 1 on add the BRDF and normal
    # terms
    falls(s2, losses[1:])
    check_outputs(s2, epochs, ("k_from_xyz", "theta_rpv_from_xyz",
                               "rhoc_from_xyz"))

    # resume stage 2 from its last checkpoint for 2 more steps: the step
    # count, Adam's count and the learning rate carry on
    last2 = os.path.join(ckpts, s2, f"epoch={epochs - 1}.npz")
    res = "stage2_resume"
    _, lrs = run(res, base + heads + ["--exp_name", res, "--ckpt_path",
                                      last2, "--max_train_steps",
                                      str(WF_STEPS + 2)], 2,
                 {"K1": 4, "K2": 2, "K3": 2}, val2)
    spe = n_rays // BATCH
    want_lr = [(k, float(np.float32(5e-4 * 0.9 ** (k // spe))))
               for k in (WF_STEPS, WF_STEPS + 1)]
    print(f"  {res}: updates (index, lr) {lrs}; expected {want_lr}",
          flush=True)
    assert lrs == want_lr, (lrs, want_lr)
    rows = [r for r in scalars(res) if "train/loss" in r]
    assert [r["step"] for r in rows] == [WF_STEPS + 1], rows
    out = os.path.join(ckpts, res, f"epoch={(WF_STEPS + 1) // spe}")
    with np.load(out + ".npz") as z, np.load(out + ".opt.npz") as o:
        print(f"  {res}: checkpoint step {int(z['__step__'])}, Adam's "
              f"count {int(o['leaf_0000'])}", flush=True)
        assert int(z["__step__"]) == int(o["leaf_0000"]) == WF_STEPS + 2

    # --scan_chunk 8 against --scan_chunk 1: the same 16 steps (one step of
    # the Lambertian phase, then chunks of 8 and 7); the loop of the latter
    # profiled for the device's busy share.  Bound: every step's loss to
    # 1e-6 relative (the step is expected to be deterministic: bit-equal)
    scan = {}
    for n in (8, 1):
        exp = f"scan{n}"
        scan[n], _ = run(exp, stage2 + [
            "--exp_name", exp, "--max_train_steps", str(WF_SCAN_STEPS),
            "--scan_chunk", str(n)], WF_SCAN_STEPS,
            {"K1": 2 * WF_SCAN_STEPS - 1, "K2": WF_SCAN_STEPS,
             "K3": WF_SCAN_STEPS}, val2, profiled=(n == 1))
    rel = max(abs(a - b) / abs(b) for a, b in zip(scan[8], scan[1]))
    print(f"  scan_chunk 8 vs 1: per-step losses largest relative "
          f"difference {rel:.3e}; bit-identical {scan[8] == scan[1]}",
          flush=True)
    assert rel <= 1e-6, (scan[8], scan[1])
    dev_s, wall_s = rec["busy"]
    print(f"  scan1's loop ({WF_SCAN_STEPS} steps, profiled): device busy "
          f"{dev_s:.3f} of {wall_s:.3f} s ({dev_s / wall_s:.1%})",
          flush=True)

    # stage 2 as a user who changes nothing runs it: no --compute_dtype,
    # the CLI's default float32, handed off from stage 1; its [kernels]
    # line names K1 and K2 + K3 (their float32 instantiations), and it
    # launches them as stage 2 does
    f32 = "stage2_float32"
    default = [a for i, a in enumerate(stage2)
               if "--compute_dtype" not in stage2[max(i - 1, 0):i + 1]]
    assert "--compute_dtype" not in default
    losses, _ = run(f32, default + ["--exp_name", f32, "--max_train_steps",
                                    str(WF_SCAN_STEPS)], WF_SCAN_STEPS,
                    {"K1": 2 * WF_SCAN_STEPS - 1, "K2": WF_SCAN_STEPS,
                     "K3": WF_SCAN_STEPS}, val2,
                    kernels=("compute_dtype='float32'", "K1 (the sigma-only",
                             "K2 + K3"))
    print(f"  {f32}: losses {[round(v, 5) for v in losses]}", flush=True)

    # the same at the exact sine (--fast_sin 0) and ReLU (--siren 0), handed
    # off from stage 1: the [kernels] line names K1 and K2 + K3 (their
    # float32 instantiations built for the activation), and the run
    # launches them as stage 2 does
    for act, flag, name in (("sin", ["--fast_sin", "0"], "the exact sine"),
                            ("relu", ["--siren", "0"], "ReLU")):
        exp = f"stage2_float32_{act}"
        losses, _ = run(exp, default + ["--exp_name", exp,
                                        "--max_train_steps",
                                        str(WF_SCAN_STEPS)] + flag,
                        WF_SCAN_STEPS,
                        {"K1": 2 * WF_SCAN_STEPS - 1, "K2": WF_SCAN_STEPS,
                         "K3": WF_SCAN_STEPS}, val2,
                        kernels=("compute_dtype='float32'",
                                 "K1 (the sigma-only", "K2 + K3", name))
        print(f"  {exp}: losses {[round(v, 5) for v in losses]}",
              flush=True)
    (ts.compute_losses, ts.Optimizer.step, Trainer.validate, Trainer.fit,
     Trainer._on_epoch_end) = saved
    return os.path.join(logs, s2), epochs - 1, os.path.join(logs, f32)


# the families' workflow (phase 12): FAMILY_WF_STEPS steps a stage, the
# family's stage-2 heads (the flagship's with RPV's replaced) and flags
FAMILY_WF_STEPS = 32
FAMILY_FLAGS = {"hapke": ["--b", "--c", "--theta", "--hpk_scl", "1"],
                "microfacet": ["--roughness"]}
FAMILY_KEYS = {"hapke": ("b_from_xyz", "c_from_xyz", "theta_from_xyz"),
               "microfacet": ("roughness_from_xyz",)}
# ... and the flagship's RPV(111) heads (the width-64 workflow)
RPV_FLAGS = ["--funcM", "1", "--funcF", "1", "--funcH", "1"]
RPV_KEYS = ("k_from_xyz", "theta_rpv_from_xyz", "rhoc_from_xyz")


def family_runs(family, base, run, check_outputs, falls, logs, ckpts,
                reset_counts, counts, smi, width=512):
    """Stage 1 and stage 2 of `family` (None: the RPV(111) heads at trunk
    width `width`) through the train CLI on its AOI (workflow's run,
    check_outputs and falls), then the eval CLI on stage 2's checkpoint;
    returns the eval's scores.  At a width other than 512 (the RPV heads)
    also stage 2 again with BRDFNERF_FUSED_HEADS set at --brdf_on 0.5
    (K4/K5 take RPV without theta; the BRDF from step FAMILY_WF_STEPS / 2
    on) and the eval CLI on it, K4 in K2's place and K5 in K3's."""
    from brdfnerf_tpu_torch.cli import eval as cli_eval
    steps = FAMILY_WF_STEPS
    common = base + (["--hpk_scl", "1"] if family == "hapke" else [])
    name = family or f"width {width}"
    tag = family or f"f{width}"
    s1, s2 = f"{tag}_stage1", f"{tag}_stage2"
    # launches, from the code, as workflow's: stage 1 K1 once a step and
    # once a validation chunk; stage 2 K1 for the probe and, from step 1
    # (the first BRDF step), the sun march, K2 and K3 once a step; its
    # validation K1 twice and K2 once a chunk.  One validation a run (its
    # steps end inside the first epoch)
    losses, _ = run(s1, common + ["--exp_name", s1, "--max_train_steps",
                                  str(steps)], steps, {"K1": steps},
                    {"K1": WF_CHUNKS + 1})
    falls(s1, losses)
    check_outputs(s1, 1, ("fc_net", "sigma_from_xyz", "rgb_from_xyzdir"))
    heads = (["--normal", "analystic", "--sun_v", "analystic", "--brdf_on",
              "0", "--nr_reg_an_lambda", "0.1", "--hs_lambda", "0.5"]
             + FAMILY_FLAGS.get(family, RPV_FLAGS))
    losses, _ = run(s2, common + heads + [
        "--exp_name", s2, "--max_train_steps", str(steps), "--in_ckpts",
        os.path.join(ckpts, s1, "epoch=0.npz")], steps,
        {"K1": 2 * steps - 1, "K2": steps, "K3": steps},
        {"K1": 2 * (WF_CHUNKS + 1), "K2": WF_CHUNKS + 1},
        kernels=("K1 (the sigma-only", "K2 + K3", f"width {width}"))
    falls(s2, losses[1:])
    check_outputs(s2, 1, FAMILY_KEYS.get(family, RPV_KEYS))
    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

    def evaluate_stage(label, stage, want):
        reset_counts()
        scores = {}
        saved = cli_eval.evaluate

        def evaluate(*a, **k):
            scores.update(saved(*a, **k))
            return scores
        cli_eval.evaluate = evaluate
        try:
            rc, _, seconds = run_cli(f"eval, {label}", cli_eval.main, [
                "--logs_dir", os.path.join(logs, stage), "--epoch_number",
                "0"], smi)
        finally:
            cli_eval.evaluate = saved
        launches = counts()
        print(f"  eval, {label}: launches {launches} over {WF_CHUNKS} "
              f"chunks (want {want}); stage 2 after {steps} steps: PSNR "
              f"{scores.get('psnr')} dB, SSIM {scores.get('ssim')}, DSM "
              f"MAE {scores.get('mae')} m; {seconds:.3f} s ({smi})",
              flush=True)
        assert rc == 0 and launches == want, launches
        assert all(np.isfinite(scores[k]) for k in ("psnr", "ssim", "mae")),\
            scores
        return scores

    scores = evaluate_stage(name, s2, dict(zero, K1=2 * WF_CHUNKS,
                                           K2=WF_CHUNKS))
    if family is None and width != 512:
        # with the switch: the BRDF without theta from step steps / 2 on
        # (--brdf_on 0.5; K4/K5 take no theta), K1 once a step before it
        # and twice after, K2 / K3 before it, K4 / K5 after; validation
        # and eval in the final phase, K4 in K2's place
        s2h = f"{tag}_stage2_heads"
        brdf_steps = steps - 1 - steps // 2
        i = heads.index("--brdf_on")
        heads_half = heads[:i] + ["--brdf_on", "0.5"] + heads[i + 2:]
        os.environ[FUSED_HEADS] = "1"
        try:
            losses, _ = run(s2h, common + heads_half + [
                "--exp_name", s2h, "--max_train_steps", str(steps),
                "--in_ckpts", os.path.join(ckpts, s1, "epoch=0.npz")],
                steps, {"K1": steps + brdf_steps,
                        "K2": steps - brdf_steps, "K3": steps - brdf_steps,
                        "K4": brdf_steps, "K5": brdf_steps},
                {"K1": 2 * (WF_CHUNKS + 1), "K4": WF_CHUNKS + 1},
                kernels=("K4 + K5 in their place", f"width {width}"))
            # the BRDF's first step changes the loss's terms: finite here,
            # and the widths phase holds the fused-heads step's fall
            assert all(np.isfinite(losses)), losses
            check_outputs(s2h, 1, RPV_KEYS)
            evaluate_stage(f"{name}, fused heads", s2h,
                           dict(zero, K1=2 * WF_CHUNKS, K4=WF_CHUNKS))
        finally:
            del os.environ[FUSED_HEADS]
    return scores


def run_cli(label, fn, argv, smi):
    """A CLI's main on the card, its standard output kept (and printed
    indented, after its seconds and the card's name and power limit
    `smi`); returns (exit code, output, seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    print(f"  {label} ({seconds:.3f} s, {smi}):\n    "
          + "\n    ".join(text.strip().splitlines()), flush=True)
    return rc, text, seconds


def host_traffic(fn):
    """One call of fn under torch.profiler: its wall ms, device ms, the
    device-to-host and host-to-device copies, and the host's waits on the
    device (cudaStreamSynchronize / cudaDeviceSynchronize calls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, d2h, h2d, syncs = 0.0, 0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms += ev.self_device_time_total / 1e3
            if "DtoH" in ev.key:
                d2h += ev.count
            elif "HtoD" in ev.key:
                h2d += ev.count
        elif ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += ev.count
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "d2h": d2h, "h2d": h2d,
            "syncs": syncs}


def eval_phase(root, run_dir, epoch, reset_counts, counts, smi, rows,
               run_f32):
    """The evaluation side through the port's CLIs on the card, on the
    workflow's stage-2 run (the flagship at bfloat16_all, 2 validation
    images of AOI_SIZE**2 rays): cli/eval.main on the last checkpoint
    (launches, the files the JAX CLI writes, scores against the stage's
    last validation of the same weights), the same weights under the
    flagship's brdf_on 0.5 with BRDFNERF_FUSED_HEADS off and on (the fused
    heads take RPV without theta), one image through the block render
    against the chunk loop (bit-identical; wall time, device-to-host
    copies and host waits of each), create_dsm, brf_probe --param_probe
    and convert_ckpt npz -> ckpt -> npz (bit-equal, and the converted
    checkpoint scores the same); then the eval CLI on the workflow's
    float32 stage-2 run (run_f32, the CLIs' default dtype): K1 and K2 in
    their float32 instantiations, and its [kernels] line says so."""
    import glob
    from brdfnerf_tpu_torch.cli import brf_probe as cli_brf
    from brdfnerf_tpu_torch.cli import convert_ckpt as cli_conv
    from brdfnerf_tpu_torch.cli import create_dsm as cli_dsm
    from brdfnerf_tpu_torch.cli import eval as cli_eval
    from brdfnerf_tpu_torch.serve import load_renderer

    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        val = [json.loads(ln) for ln in f if '"val/psnr_1"' in ln][-1]
    # the eval CLI's means run over the test image alone (is_val: image 1)
    last_val = {k: val[f"val/{k}_1"] for k in ("psnr", "ssim", "mae")}
    scores = {}
    saved = cli_eval.evaluate

    def evaluate(*a, **k):
        scores["last"] = saved(*a, **k)
        return scores["last"]

    def eval_run(label, run, extra, want, epoch_=epoch, kernels=()):
        reset_counts()
        rc, text, seconds = run_cli(label, cli_eval.main,
                                    ["--logs_dir", run, "--epoch_number",
                                     str(epoch_)] + extra, smi)
        launches = counts()
        print(f"  {label}: launches {launches} over {WF_CHUNKS} chunks "
              f"(want {dict(zero, **want)}); {seconds:.3f} s ({smi})",
              flush=True)
        assert rc == 0 and launches == dict(zero, **want), launches
        line = [ln for ln in text.splitlines() if ln.startswith("[kernels]")]
        assert len(line) == 1 and all(k in line[0] for k in kernels), line
        return dict(scores["last"]), launches

    cli_eval.evaluate = evaluate
    try:
        # launches from the code: a chunk runs K1 for the sigma probe and
        # for the sun march, and K2 (serving instantiation, no zs) for the
        # main pass, or K4 in its place with the fused heads; 2 images of
        # WF_CHUNKS / 2 chunks at --chunk CHUNK
        ev, launches = eval_run("eval", run_dir, [],
                                {"K1": 2 * WF_CHUNKS, "K2": WF_CHUNKS})
        rows["K1"]["launches_eval"] = launches["K1"]
        rows["K2"]["launches_eval"] = launches["K2"]
        out = os.path.join(run_dir, f"eval_epoch{epoch}")
        for pattern, n in (("*_rgb.tif", 2), ("*_depth.tif", 2),
                           ("dsm/*_dsm.tif", 2),
                           (f"rdsm/*_rdsm_epoch{epoch}.tif", 2),
                           (f"rdsm_diff/*_rdsm_diff_epoch{epoch}.tif", 2)):
            found = glob.glob(os.path.join(out, pattern))
            assert len(found) == n, (pattern, found)
        # validation and eval render the same image through the same block
        # render with the same draws and the same weights (f32 round trip
        # of the checkpoint): equal, or within 1e-4 dB / 1e-5 / 1e-5 m
        print(f"  eval {ev}; stage 2's last validation {last_val}",
              flush=True)
        for k, tol in (("psnr", 1e-4), ("ssim", 1e-5), ("mae", 1e-5)):
            assert np.isfinite(ev[k]) and abs(ev[k] - last_val[k]) <= tol, (
                k, ev[k], last_val[k])
        print(f"  eval equals the last validation bit for bit: "
              f"{all(ev[k] == last_val[k] for k in last_val)}", flush=True)

        # the fused heads take the flagship head set, RPV without theta
        # (apply_theta is off at brdf_on 0.5, the flagship's value; stage 2
        # trains with brdf_on 0, whose eval applies theta: eval.py:383-384,
        # so the switch would leave K2 in place there).  The same weights
        # under the flagship's brdf_on, evaluated with the switch off and on
        from brdfnerf_tpu_torch.cli.opts import dump_opts, load_opts
        run = load_opts(run_dir)
        flag = os.path.join(root, "flagship")
        flag_opts = load_opts(run_dir)
        flag_opts.brdf_on = 0.5
        dump_opts(flag_opts, flag)
        flag_ev, _ = eval_run("eval, brdf_on 0.5", flag, [],
                              {"K1": 2 * WF_CHUNKS, "K2": WF_CHUNKS})
        os.environ[FUSED_HEADS] = "1"
        try:
            fused, launches = eval_run(
                "eval, brdf_on 0.5, fused heads", flag,
                ["--output_dir", os.path.join(root, "eval_fused")],
                {"K1": 2 * WF_CHUNKS, "K4": WF_CHUNKS})
        finally:
            del os.environ[FUSED_HEADS]
        rows["K4"]["launches_eval"] = launches["K4"]
        # the cross-path bounds of tests/test_torch_port_cli.py
        print(f"  eval at brdf_on 0.5: switch off {flag_ev}, fused heads "
              f"{fused}", flush=True)
        for k, tol in (("psnr", 0.5), ("ssim", 0.02), ("mae", 0.05)):
            assert (np.isfinite(fused[k])
                    and abs(fused[k] - flag_ev[k]) <= tol), (k, fused[k],
                                                             flag_ev[k])

        # npz -> ckpt -> npz at the flagship's width; the .ckpt, alone in a
        # checkpoints directory, evaluates to the same scores
        npz = os.path.join(run.ckpts_dir, run.exp_name, f"epoch={epoch}.npz")
        conv = os.path.join(root, "converted")
        os.makedirs(conv, exist_ok=True)
        ck = os.path.join(conv, f"epoch={epoch}.ckpt")
        back = os.path.join(root, "back.npz")
        for argv in (["--input", npz, "--output", ck],
                     ["--input", ck, "--output", back]):
            rc, _, _ = run_cli("convert_ckpt", cli_conv.main, argv, smi)
            assert rc == 0
        with np.load(npz) as a, np.load(back) as b:
            assert sorted(a.files) == sorted(b.files), (a.files, b.files)
            same = all(np.array_equal(a[k], b[k]) for k in a.files)
        print(f"  npz -> ckpt -> npz: {len(a.files)} arrays, bit-equal "
              f"{same}", flush=True)
        assert same
        conv_ev, _ = eval_run("eval of the converted .ckpt", run_dir,
                              ["--checkpoints_dir", conv, "--output_dir",
                               os.path.join(root, "eval_ckpt")],
                              {"K1": 2 * WF_CHUNKS, "K2": WF_CHUNKS})
        print(f"  converted checkpoint {conv_ev}", flush=True)
        assert conv_ev == ev, (conv_ev, ev)

        # the float32 stage-2 run (its checkpoint of epoch 0), at its own
        # dtype: K1 twice and K2 once a chunk, float32 instantiations
        ev32, launches = eval_run(
            "eval, float32 run", run_f32, [],
            {"K1": 2 * WF_CHUNKS, "K2": WF_CHUNKS}, epoch_=0,
            kernels=("compute_dtype='float32'", "K1 (the sigma-only",
                     "K2 (the trunk"))
        rows["K1f32"]["launches_eval"] = launches["K1"]
        rows["K2f32"]["launches_eval"] = launches["K2"]
        print(f"  eval of the float32 run {ev32}", flush=True)
        assert all(np.isfinite(v) for v in ev32.values()), ev32
    finally:
        cli_eval.evaluate = saved

    # one validation image through the block render and the chunk loop, in
    # turns (block, loop, loop, block); outputs bit-identical
    renderer = load_renderer(run_dir, epoch)
    sample = renderer.get_image(1)
    n = sample["rays"].shape[0]

    def render(loop):
        if loop:
            os.environ["BRDFNERF_NO_SCAN_RENDER"] = "1"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = renderer.render_image(sample)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            os.environ.pop("BRDFNERF_NO_SCAN_RENDER", None)

    outs, secs = {}, {"block": [], "loop": []}
    for loop in (False, True, True, False):
        name = "loop" if loop else "block"
        outs[name], s = render(loop)
        secs[name].append(s)
    a, b = outs["block"], outs["loop"]
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
    print(f"  block render vs chunk loop: {len(a)} outputs bit-identical on "
          f"{n} rays ({smi})", flush=True)
    for name, loop in (("block", False), ("loop", True)):
        if loop:
            os.environ["BRDFNERF_NO_SCAN_RENDER"] = "1"
        try:
            tr = host_traffic(lambda: renderer.render_image(sample))
        finally:
            os.environ.pop("BRDFNERF_NO_SCAN_RENDER", None)
        best = min(secs[name])
        print(f"  {name}: wall {[round(s, 4) for s in secs[name]]} s, "
              f"{n / best:.1f} rays/s (faster run); profiled image: wall "
              f"{tr['wall_ms']:.2f} ms, device {tr['device_ms']:.2f} ms "
              f"(busy {tr['device_ms'] / tr['wall_ms']:.1%}), device-to-host "
              f"copies {tr['d2h']}, host-to-device {tr['h2d']}, host waits "
              f"(stream/device synchronize) {tr['syncs']} ({smi})",
              flush=True)

    # create_dsm: the most-nadir view under the most-nadir sun
    dsm_dir = os.path.join(root, "dsm")
    rc, text, _ = run_cli("create_dsm", cli_dsm.main,
                          ["--logs_dir", run_dir, "--epoch_number",
                           str(epoch), "--output_dir", dsm_dir], smi)
    mae = [float(ln.split()[2]) for ln in text.splitlines()
           if ln.startswith("DSM MAE")]
    assert rc == 0 and glob.glob(os.path.join(dsm_dir, "*_dsm.tif"))
    assert len(mae) == 1 and np.isfinite(mae[0]), text

    # brf_probe with the parameter readout, on image 1's centre pixel
    brf_dir = os.path.join(root, "brf")
    rc, text, _ = run_cli("brf_probe", cli_brf.main,
                          ["--logs_dir", run_dir, "--epoch_number",
                           str(epoch), "--param_probe", "--output_dir",
                           brf_dir], smi)
    txt = glob.glob(os.path.join(brf_dir, "brf_*.txt"))
    assert rc == 0 and len(txt) == 1, txt
    curve = np.loadtxt(txt[0])
    print(f"  brf_probe: {curve.shape[0]} rows; BRF from "
          f"{curve[:, 1:].min():.4f} to {curve[:, 1:].max():.4f}",
          flush=True)
    assert curve.shape == (33, 4) and np.isfinite(curve).all(), curve.shape
    return ev


DEFAULT_IMPORTANCE = 64     # the fine network's samples (--n_importance)


# the blender path and the host data paths (phase 15): a scene in the
# lego layout, cut from lego's 100 train / 100 val / 200 test frames to
# BLENDER_SCENE's, at lego's 800 x 800 RGBA and --img_wh 400 400
BLENDER_SCENE = {"train": 20, "val": 2, "test": 2}
BLENDER_FRAME, BLENDER_WH = 800, 400
# the model the blender run trains (variant, layers, width, skips, siren,
# positional encoding, samples, batch): vanilla NeRF at the CLI's defaults
BLENDER_MODEL = ("nerf", 8, 512, (4,), False, True, 64, 1024)
BLENDER_STEPS = 300
BLENDER_PSNR_GAIN = 3.0       # dB over the run (tests/test_misc.py's e2e)
SAT_SIZE = 128                # the generated dataset's AOI, in pixels
SAT_TILTS = ((0.0, 0.0), (0.1, 0.05), (-0.08, 0.1), (0.06, -0.09),
             (-0.05, -0.04))  # five full scenes: 3 train + 2 test crops
SAT_STEPS = 16
TWIN_PROCS = 4                # the PNG twin's processes


def _cli_number(text, pattern):
    """The float of the last match of `pattern` (one group) in a CLI's
    output."""
    import re
    found = re.findall(pattern, text)
    assert found, (pattern, text[-2000:])
    return float(found[-1].replace(",", ""))


def blender_train(root, scene, reset_counts, counts, smi):
    """The train CLI on the blender scene: vanilla NeRF at the CLI's
    defaults (8 x 512, skip 4, 64 samples, batch 1,024, float32) with ReLU
    and positional encoding; no kernel; the train PSNR rises by
    BLENDER_PSNR_GAIN dB; validation writes its panels.  Returns (run_dir,
    psnrs, ingestion s, train rays/s, the CLI's s)."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli import train as cli_train
    from brdfnerf_tpu_torch.utils import png
    none = {k: 0 for k in counts()}
    logs, ckpts = os.path.join(root, "logs"), os.path.join(root, "ckpts")
    argv = ["--data", "blender", "--model", "nerf", "--siren", "0",
            "--mapping", "--root_dir", scene, "--img_wh", str(BLENDER_WH),
            str(BLENDER_WH),
            "--exp_name", "blender", "--logs_dir", logs, "--ckpts_dir",
            ckpts, "--max_train_steps", str(BLENDER_STEPS)]
    cfg = opts.to_run_config(opts.postprocess(
        opts.train_parser().parse_args(argv)), device="cuda")
    m = cfg.model
    assert (m.variant, m.layers, m.feat, m.skips, m.siren, m.mapping,
            cfg.render.n_samples, cfg.train.batch_size) == BLENDER_MODEL, cfg
    reset_counts()
    rc, text, train_s = run_cli("train CLI, blender", cli_train.main, argv,
                                smi)
    assert rc == 0 and counts() == none, counts()
    psnrs = [float(ln.split(" psnr ")[1].split()[0])
             for ln in text.splitlines() if ln.startswith("step ")]
    assert psnrs[-1] >= psnrs[0] + BLENDER_PSNR_GAIN, psnrs
    ingest_s = _cli_number(text, r"ingested in ([0-9.]+) s")
    train_rays_s = _cli_number(text, r"psnr [0-9.]+ ([0-9,]+) rays/s")
    run_dir = os.path.join(logs, "blender")
    for i in range(BLENDER_SCENE["val"]):
        panel = png.read_png(os.path.join(run_dir, f"val_{i}_epoch0.png"))
        assert panel.shape == (3 * BLENDER_WH + 2 * 2, BLENDER_WH, 3), \
            panel.shape
    return run_dir, psnrs, ingest_s, train_rays_s, train_s


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data_torch_port")


def digest(arr) -> str:
    """SHA-256 of an array's bytes, a bool array's as 0 / 1, as
    tests/make_image_fixtures.py hashes Pillow's arrays."""
    import hashlib
    a = np.ascontiguousarray(arr)
    if a.dtype == bool:
        a = a.astype(np.uint8)
    return hashlib.sha256(a.tobytes()).hexdigest()


@contextlib.contextmanager
def host_twins():
    """The host C decoders' entry points swapped for their NumPy twins, to
    hold one against the other on the same files."""
    from brdfnerf_tpu_torch.utils import ccitt, jpeg, png
    saved = (jpeg.decode, jpeg.raw_planes, ccitt.decode, png._unfilter_c)
    jpeg.decode, jpeg.raw_planes = jpeg.decode_plain, jpeg.raw_planes_plain
    ccitt.decode = ccitt.decode_plain
    png._unfilter_c = (lambda raw, h, w, c, path:
                       png.unfilter_plain(raw, h, w, c))
    try:
        yield
    finally:
        jpeg.decode, jpeg.raw_planes, ccitt.decode, png._unfilter_c = saved


def image_fixtures(smi):
    """The committed image fixtures (tests/data_torch_port, written by
    Pillow: JPEG-in-TIFF YCbCr 4:2:0 tiled and greyscale, Group 4 and
    Group 3 2-D masks, an Adam7 16-bit RGBA and a palette PNG) decoded by
    the host C libraries (utils/jpeg, utils/ccitt, png's unfilter), each
    equal to its NumPy twin's decode and of the SHA-256 of Pillow's array
    in manifest.json.  Returns the seconds the check took."""
    from brdfnerf_tpu_torch.ops.cuda_build import build_log
    from brdfnerf_tpu_torch.utils import geotiff, png
    t_all = time.perf_counter()
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)

    def read(path):
        if path.endswith(".png"):
            return png.read_png(path)
        return geotiff.read_pixels(path)

    names = sorted(n for n in manifest if not n.startswith("_"))
    for name in names:
        want, path = manifest[name], os.path.join(FIXTURES, name)
        got = read(path)                 # the first call builds the library
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            read(path)
            ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        with host_twins():
            twin = read(path)
        twin_ms = (time.perf_counter() - t0) * 1e3
        assert got.dtype == twin.dtype and np.array_equal(got, twin), name
        assert (str(got.dtype), list(got.shape)) == (want["dtype"],
                                                     want["shape"]), name
        assert digest(got) == want["sha256"], (name, "not Pillow's array")
        print(f"  {name} ({want['pil_mode']}, {got.shape} {got.dtype}, "
              f"{want['bytes']:,} B): host C decode {min(ms):.3f} ms (best "
              f"of 3), NumPy twin {twin_ms:.1f} ms, equal; SHA-256 equal to "
              f"Pillow's; {smi}", flush=True)
    built = {k: round(v["seconds"], 3) for k, v in build_log.items()
             if k.startswith("host:")}
    took = time.perf_counter() - t_all
    print(f"  image fixtures: {len(names)} files in {took:.3f} s (host "
          f"library builds in it, s: {built}); {smi}", flush=True)
    return took


def blender_phase(root, reset_counts, counts, smi):
    """The reference's data and output paths without PIL or cv2: the
    blender dataset with vanilla NeRF through the train and eval CLIs, and
    the satellite workflow at --img_downscale 2 from a dataset that the
    port's generate_dataset wrote.  No kernel runs on either path (the
    nerf and sat-nerf variants run their trunks in plain torch, as the JAX
    package runs them without a Pallas kernel): every count stays 0."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from brdfnerf_tpu_torch import dataset_gen
    from brdfnerf_tpu_torch.cli import eval as cli_eval
    from brdfnerf_tpu_torch.cli import generate_dataset as cli_gen
    from brdfnerf_tpu_torch.cli import train as cli_train
    from brdfnerf_tpu_torch.data import synth_aoi
    from brdfnerf_tpu_torch.data.blender import BlenderDataset
    from brdfnerf_tpu_torch.data.synth_blender import write_scene
    from brdfnerf_tpu_torch.render.render import chunk_draws
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.utils import png, viz
    none = {k: 0 for k in counts()}

    # the image formats the JAX package reads through PIL, from the
    # committed fixtures
    image_fixtures(smi)

    # the scene, and the host C unfilter against its NumPy twin on every
    # frame (the twin in TWIN_PROCS processes beside the train CLI: it
    # walks 1,599 diagonals a frame)
    t0 = time.perf_counter()
    scene = os.path.join(root, "scene")
    paths = write_scene(scene, BLENDER_SCENE, size=BLENDER_FRAME)
    frames = [p for split in paths.values() for p in split]
    write_s = time.perf_counter() - t0
    bufs = []
    for p in frames:
        with open(p, "rb") as fh:
            bufs.append(fh.read())
    t0 = time.perf_counter()
    decoded = [png.decode_image(b, p)[0] for b, p in zip(bufs, frames)]
    decode_s = time.perf_counter() - t0
    inflated = [(q.rows, q.stride // q.bpp, q.bpp, q.raw)
                for b, p in zip(bufs, frames)
                for q in png.scanlines(b, p)[1]]
    kinds = {int(k) for _, w_, c_, raw in inflated
             for k in np.frombuffer(raw, np.uint8)[::w_ * c_ + 1]}
    assert kinds == set(range(5)), kinds
    t_twin = time.perf_counter()
    pool = cf.ProcessPoolExecutor(TWIN_PROCS,
                                  mp_context=mp.get_context("spawn"))
    try:
        twins = pool.map(png.unfilter_plain, [r[3] for r in inflated],
                         *zip(*[r[:3] for r in inflated]))
        run_dir, psnrs, ingest_s, train_rays_s, train_s = blender_train(
            root, scene, reset_counts, counts, smi)
        twins = list(twins)
    finally:
        pool.shutdown()
    twin_s = time.perf_counter() - t_twin
    f = BLENDER_FRAME
    for img, twin, p in zip(decoded, twins, frames):
        assert img.shape == (f, f, 4), (p, img.shape)
        assert np.array_equal(img.reshape(f, -1), twin), p
    print(f"  scene: {len(frames)} frames of {f} x {f} RGBA ({BLENDER_SCENE}"
          f"; lego: 100 / 100 / 200) written in {write_s:.3f} s; decoded "
          f"in {decode_s:.3f} s ({decode_s / len(frames) * 1e3:.2f} ms a "
          f"frame), equal to the NumPy twin's rows (done {twin_s:.3f} s "
          f"after they were sent, beside the train CLI); filter types "
          f"{sorted(kinds)}; {smi}", flush=True)

    # serving: 16,384-ray requests of a val image, and 1,024 of its rays
    # through the card against the CPU twin (the serving check's bounds)
    r = load_renderer(run_dir, 0)
    rays = BlenderDataset(scene, "val", img_wh=(BLENDER_WH,) * 2).get_image(
        0)["rays"]
    req = rays[:REQ_SIDE * REQ_SIDE]
    req_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = r.render_image({"rays": req})
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
    assert all(np.isfinite(v).all() for v in out.values())
    small = rays[::len(rays) // 1024][:1024]
    draws = chunk_draws(r.cfg.model, r.render_config(), len(small),
                        torch.device("cpu"), seed=7)
    a = dc.replace(r, chunk=len(small)).render_image({"rays": small},
                                                     draws=draws)
    b = dc.replace(r, net=copy.deepcopy(r.net).cpu(),
                   device=torch.device("cpu"), chunk=len(small)).render_image(
        {"rays": small}, draws=draws)
    check = {}
    for k in ("rgb_coarse", "depth_coarse"):
        d = np.abs(a[k] - b[k]).reshape(len(small), -1).max(-1)
        check[k] = (float(d.mean()), float(np.quantile(d, 0.99)))
    print(f"  blender render, card vs CPU twin on 1,024 rays: "
          + "; ".join(f"{k} mean {v[0]:.3e} p99 {v[1]:.3e}"
                      for k, v in check.items()), flush=True)
    assert check["depth_coarse"][0] < 1e-2 and check["rgb_coarse"][0] < 1e-2
    assert check["rgb_coarse"][1] < 0.1, check

    # the eval CLI: scores and panels; each panel decodes to its array
    written = {}
    save_png = viz.save_png

    def record(path, img):
        written[path] = np.array(img)
        return save_png(path, img)
    viz.save_png = record
    reset_counts()
    try:
        rc, text, eval_s = run_cli("eval CLI, blender", cli_eval.main,
                                   ["--logs_dir", run_dir, "--epoch_number",
                                    "0"], smi)
    finally:
        viz.save_png = save_png
    assert rc == 0 and counts() == none, counts()
    assert np.isfinite(_cli_number(text, r"mean: psnr ([0-9.]+)"))
    assert len(written) == BLENDER_SCENE["val"], sorted(written)
    for path, img in written.items():
        assert path.endswith("_panels.png") and np.array_equal(
            png.read_png(path), img), path
    print(f"  blender (NVIDIA card {smi}): ingestion {ingest_s:.3f} s "
          f"({BLENDER_SCENE['train']} + {BLENDER_SCENE['val']} frames); "
          f"train {train_rays_s:,.1f} rays/s; request "
          f"{len(req) / min(req_s):,.1f} rays/s (fastest of 3, "
          f"{len(req)} rays); train CLI {train_s:.3f} s, eval CLI "
          f"{eval_s:.3f} s; train psnr {psnrs[0]:.2f} -> {psnrs[-1]:.2f}",
          flush=True)

    # the satellite workflow at --img_downscale 2 on a dataset that the
    # port's generate_dataset wrote from full scenes of a synthetic AOI
    t0 = time.perf_counter()
    aoi = synth_aoi.build_aoi(os.path.join(root, "aoi"), size=SAT_SIZE)
    imgs = os.path.join(root, "full_scenes")
    synth_aoi.write_full_scenes(imgs, size=SAT_SIZE, tilts=SAT_TILTS)
    out = os.path.join(root, "generated")
    rc, _, gen_s = run_cli("generate_dataset CLI", cli_gen.main, [
        "--aoi_id", aoi["aoi_id"], "--dsm_dir", aoi["gt_dir"], "--img_dir",
        imgs, "--out_dir", out, "--utm_zone", str(synth_aoi.ZONE),
        "--run_ba"], smi)
    assert rc == 0
    base = os.path.join(out, f"dataset{aoi['aoi_id']}")
    gen_root = os.path.join(base, "root_dir", aoi["aoi_id"])
    masks = dataset_gen.generate_footprint_masks(gen_root, "full_00.json")
    assert len(masks) == len(SAT_TILTS)
    host_s = time.perf_counter() - t0
    logs = os.path.join(root, "sat_logs")
    reset_counts()
    rc, text, _ = run_cli("train CLI, --img_downscale 2", cli_train.main, [
        "--model", "sat-nerf", "--root_dir", gen_root, "--img_dir",
        os.path.join(base, aoi["aoi_id"], "RGB-crops", aoi["aoi_id"],
                     "scled"),
        "--img_downscale", "2", "--aoi_id", aoi["aoi_id"], "--gt_dir",
        os.path.join(base, aoi["aoi_id"], "Truth"), "--exp_name", "ds2",
        "--logs_dir", logs, "--ckpts_dir", os.path.join(root, "sat_ckpts"),
        "--max_train_steps", str(SAT_STEPS)], smi)
    assert rc == 0 and counts() == none, counts()
    n_rays = int(_cli_number(text, r"\[data\] ([0-9]+) training rays"))
    want = 0
    for name in open(os.path.join(gen_root, "train.txt")).read().split():
        with open(os.path.join(gen_root, name)) as f:
            meta = json.load(f)
        want += int(meta["height"] // 2) * int(meta["width"] // 2)
    assert n_rays == want, (n_rays, want)
    rc, text, _ = run_cli("eval CLI, --img_downscale 2", cli_eval.main, [
        "--logs_dir", os.path.join(logs, "ds2"), "--epoch_number", "0"],
        smi)
    assert rc == 0 and counts() == none, counts()
    ev = os.path.join(logs, "ds2", "eval_epoch0")
    panels = [f for f in os.listdir(ev) if f.endswith("_panels.png")]
    assert len(panels) == 3, panels
    for f in panels:
        assert png.read_png(os.path.join(ev, f)).dtype == np.uint8
    assert np.isfinite(_cli_number(text, r"mean: psnr [0-9.]+ ssim [0-9.]+ "
                                         r"mae ([0-9.]+)"))
    print(f"  generated dataset ({len(SAT_TILTS)} full scenes of "
          f"{3 * SAT_SIZE} px, AOI {SAT_SIZE} px; generate_dataset "
          f"{gen_s:.3f} s, with the AOI, scenes and masks {host_s:.3f} s): "
          f"{n_rays} training rays at --img_downscale 2", flush=True)


def defaults_phase(root, argv, v_base, learned, gen, requests, serve, train,
                   check_served, step_check, draws, bounds, per_req, rows,
                   smi):
    """The `variants, defaults` phase (see main): `requests`, `serve`,
    `train`, `check_served`, `step_check` and the step check's `draws` and
    `bounds` are main's."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.data.batcher import DeviceRayBatcher
    from brdfnerf_tpu_torch.data.satellite import (SatelliteConfig,
                                                   SatelliteDataset)
    from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
    from brdfnerf_tpu_torch.models.network import init_params
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.parallel import train_step as ts
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.utils.checkpoint import save_checkpoint
    f32 = ["--compute_dtype", "float32"]
    fine = ["--n_importance", str(DEFAULT_IMPORTANCE)]
    sps = argv + f32

    def run(name, flags, base=sps):
        """The run's config, a run directory and a seeded checkpoint of
        its parameters (coarse, [fine], [t]); returns (cfg, run_dir)."""
        exp = "smoke_defaults_" + name.replace(" ", "_")
        r_args = opts.postprocess(opts.train_parser().parse_args(
            base + flags + ["--exp_name", exp]))
        r_dir = os.path.join(root, f"run_{exp}")
        opts.dump_opts(r_args, r_dir)
        r_cfg = opts.to_run_config(r_args, device="cuda")
        params = init_params(r_cfg.model, gen, r_cfg.render.n_importance,
                             device="cuda")
        save_checkpoint(os.path.join(root, "ckpts", exp, "epoch=1.npz"),
                        params, step=0)
        return r_cfg, r_dir

    def request(name, r_dir, want, compared=("rgb_coarse", "depth_coarse",
                                             "normal_an_coarse")):
        r_ = load_renderer(r_dir, 1, device="cuda")
        outs, launches = serve(f"request, {name}", want, r_, n_req=1,
                               profiled=False)
        check_served(outs, r_, scale=0.1, keys3=(), keys1=(), n_check=256,
                     compared=compared)
        return r_, outs

    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    k123 = lambda k2_: dict(zero, K1=2, K2=k2_, K3=k2_)   # noqa: E731

    # spsbrdf-nerf with a fine network: 64 + 64 coarse samples, 64 fine
    # ones, 192 a ray through K2 (and K3) on the fine network's weights
    cfg_f, dir_f = run("fine", fine)
    assert cfg_f.render.n_importance == DEFAULT_IMPORTANCE
    r_, _ = request("fine", dir_f, dict(zero, K1=2 * per_req, K2=2 * per_req))
    assert isinstance(r_.net, torch.nn.Module) and r_.net.fine is not None
    del r_
    trained32, launches = train(
        "train step, fine", k123(2), mcfg_=cfg_f.model, rcfg_=cfg_f.render,
        tcfg_=cfg_f.train, timed_steps=VARIANT_STEPS, store_batches=1)
    rows["K2zsf32"]["launches_defaults"] = launches["K2"]
    rows["K3f32"]["launches_defaults"] = launches["K3"]
    os.environ[FUSED_HEADS] = "1"
    train("train step, fine, fused heads", dict(zero, K1=2, K4=2, K5=2),
          mcfg_=cfg_f.model, rcfg_=cfg_f.render, tcfg_=cfg_f.train,
          timed_steps=VARIANT_STEPS, profiled=False, store_batches=1)
    del os.environ[FUSED_HEADS]
    # step checks of K2/K3 in the step on both networks' points, held to
    # their twins as the flagship's step check, every gradient of both
    # networks.  The fine network's samples are the coarse weights' inverse
    # CDF, which a ulp of those weights moves at a step of the CDF, so
    # every render of a point takes the fine samples of the kernels' step
    # (step_check: fine_samples, fixed_fine); drawn anew by each side, the
    # twins alone, card against CPU, lay 0.131 apart in relative L2 on
    # the fine network's gradients at bfloat16_all (an H100, the weights
    # after 7 steps).  float32 at bounds ten times tighter
    draws["pdf"] = torch.rand(CHECK_RAYS, DEFAULT_IMPORTANCE,
                              generator=torch.Generator().manual_seed(12))
    pair = ((k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
            (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain))
    step_check("fine, float32", trained32[-1:], *pair, k123(2),
               mcfg_=cfg_f.model, rcfg_=cfg_f.render,
               bounds_={k: v / 10 for k, v in bounds.items()},
               normal_err=NORMAL_ERR_F32, timed_steps=VARIANT_STEPS)
    del trained32
    bf_f = dc.replace(cfg_f.model, compute_dtype="bfloat16_all")
    trained, launches = train(
        "train step, fine, bfloat16_all", k123(2), mcfg_=bf_f,
        rcfg_=cfg_f.render, tcfg_=cfg_f.train, timed_steps=VARIANT_STEPS,
        store_batches=1)
    rows["K2zs"]["launches_defaults"] = launches["K2"]
    rows["K3"]["launches_defaults"] = launches["K3"]
    step_check("fine, bfloat16_all", trained[-1:], *pair, k123(2),
               mcfg_=bf_f, rcfg_=cfg_f.render, timed_steps=VARIANT_STEPS)
    del trained, draws["pdf"]

    # spsbrdf-nerf with beta: the beta head on K2's features and the t
    # table; with the switch K4/K5 refuse the t-embedding
    cfg_b, dir_b = run("beta", ["--beta"])
    r_, outs = request("beta", dir_b, dict(zero, K1=2 * per_req, K2=per_req))
    other = r_.render_image({"rays": requests[0]}, t=3)
    gap = float(np.abs(other["beta_coarse"] - outs[0]["beta_coarse"]).max())
    print(f"  beta_coarse at t = 3 against t = 0: largest difference "
          f"{gap:.3e}", flush=True)
    assert gap > 0 and np.isfinite(other["beta_coarse"]).all()
    del r_, outs, other
    train("train step, beta", k123(1), mcfg_=cfg_b.model,
          rcfg_=cfg_b.render, tcfg_=cfg_b.train, timed_steps=VARIANT_STEPS,
          profiled=False, store_batches=1)
    os.environ[FUSED_HEADS] = "1"
    train("train step, beta, fused heads set", k123(1), mcfg_=cfg_b.model,
          rcfg_=cfg_b.render, tcfg_=cfg_b.train, timed_steps=1,
          profiled=False)
    del os.environ[FUSED_HEADS]

    # multi_brdf (the BRDF per sample), normal_at_surface (one analytic
    # normal a ray, by autograd through the unfused trunk: no K2/K3) and
    # density noise
    for name, flags, step_want, chunk_want in (
            ("multi_brdf", ["--MultiBRDF", "1"], k123(1),
             dict(zero, K1=2 * per_req, K2=per_req)),
            ("normal_at_surface", ["--normal_at_surface"], k123(0),
             dict(zero, K1=2 * per_req)),
            ("noise", ["--noise_std", "1"], k123(1),
             dict(zero, K1=2 * per_req, K2=per_req))):
        cfg_v, dir_v = run(name, flags)
        request(name, dir_v, chunk_want)
        train(f"train step, {name}", step_want, mcfg_=cfg_v.model,
              rcfg_=cfg_v.render, tcfg_=cfg_v.train,
              timed_steps=VARIANT_STEPS, profiled=False, store_batches=1)

    # sat-nerf with beta and the keypoint store of a synthetic AOI with
    # tie points (--ds_lambda 10: the keypoint render and its depth loss),
    # and sps-nerf with beta: no kernel, as in the JAX package
    info = build_aoi(os.path.join(root, "aoi_kp"), with_keypoints=True)
    kp = SatelliteDataset(SatelliteConfig(
        root_dir=info["root"], aoi_id=info["aoi_id"], sparse_depth=True),
        split="train").depth_store
    print(f"  keypoint store: {kp['rays'].shape[0]} tie-point rays",
          flush=True)
    for name, model in (("sat-nerf, beta", "sat-nerf"),
                        ("sps-nerf, beta", "sps-nerf")):
        cfg_v, dir_v = run(name, ["--model", model, "--beta", "--ds_lambda",
                                  "10"] + learned, base=v_base)
        assert cfg_v.model.beta and cfg_v.train.ds_lambda == 10
        request(name, dir_v, zero, compared=("rgb_coarse", "depth_coarse"))
        kp_store = kp if model == "sat-nerf" else None
        trained, _ = train(f"train step, {name}", zero, mcfg_=cfg_v.model,
                           rcfg_=cfg_v.render, tcfg_=cfg_v.train,
                           timed_steps=VARIANT_STEPS, profiled=False,
                           store_batches=1, kp_store=kp_store)
        if kp_store is None:
            continue
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                 make_store(BATCH, np.random.RandomState(0)).items()}
        batch.update(kp_rays=torch.as_tensor(kp["rays"], device="cuda"),
                     kp_depths=torch.as_tensor(kp["depths"], device="cuda"),
                     kp_ts=torch.as_tensor(kp["ts"], device="cuda"))
        with torch.no_grad():
            _, (terms, _) = ts.compute_losses(
                trained[-1], cfg_v.model, cfg_v.render, cfg_v.train, batch,
                ts.gates_from_step(0, ts.GateSchedule(1e18, 1e18, -1.0, 1,
                                                      0)),
                generator=torch.Generator(device="cuda").manual_seed(0))
        kp_ds = float(terms["kp_coarse_ds"])
        print(f"  keypoint depth term kp_coarse_ds {kp_ds:.6e} ({smi})",
              flush=True)
        assert np.isfinite(kp_ds) and kp_ds > 0
        del trained
        # the keypoint sub-batch is gathered on the device from its own
        # store: a step sends one more index vector and nothing else, and
        # copies nothing more back
        traffic = {}
        for with_kp in (False, True):
            state, opt = ts.create_train_state(cfg_v.model, cfg_v.train, 1,
                                               device="cuda")
            step = ts.make_fused_train_step(
                cfg_v.model, cfg_v.render, cfg_v.train, opt,
                ts.GateSchedule(1e18, 1e18, -1.0, 1, 0), has_kp=with_kp)
            main = DeviceRayBatcher(make_store(BATCH, np.random.RandomState(
                0)), BATCH, seed=0, device="cuda")
            kp_b = DeviceRayBatcher(kp, min(BATCH, kp["rays"].shape[0]),
                                    seed=7, device="cuda")
            held = [state]

            def one():
                kp_args = (dict(kp_store=kp_b.store,
                                kp_idx=kp_b.next_index_tensor())
                           if with_kp else {})
                held[0], _ = step(held[0], main.store,
                                  main.next_index_tensor(), 0, **kp_args)
            one()
            traffic[with_kp] = host_traffic(one)
            del held, state, opt
        print(f"  a sat-nerf step's host traffic without / with the "
              f"keypoint store: {traffic[False]} / {traffic[True]}",
              flush=True)
        assert (traffic[True]["h2d"] <= traffic[False]["h2d"] + 1
                and traffic[True]["d2h"] == traffic[False]["d2h"]), traffic


# int8 serving (phase 16): the flagship run's requests at compute_dtype
# int8 against its bfloat16_all requests of phase 5, on the same weights.
# The ranges hold the int8 quantization's effect on a request, set about
# 2-5 times either side of its reading on an H100 at the flagship's width
# (PERF.md sections 2 and 5): below the range the quantization did not run,
# above it the int8 layer is off
INT8_PER_CHUNK = 18         # int8 products a chunk: 9 in each sigma pass
INT8_AT_SURFACE = 27        # ... with normal_at_surface: 9 in the main pass
INT8_RGB_MEAN = (1e-3, 1e-2)    # mean per-ray largest |d rgb| (4.49e-3)
INT8_DEPTH_MEAN = (4e-4, 5e-3)  # mean per-ray |d depth| (1.81e-3)
# the eval's scores against bfloat16_all's (gaps 3.3e-4 dB, 2.7e-5, 1e-6 m)
INT8_SCORES = (("psnr", 0.05), ("ssim", 1e-3), ("mae", 1e-3))


def int8_phase(root, run_dir, wf_run, wf_epoch, wf_scores, requests, refs,
               check_served, reset_counts, counts, smi, rows, per_req):
    """Phase 16, serving at int8 through the port's entry points: requests
    at int8 with BRDFNERF_FUSED_HEADS off and on against the bfloat16_all
    requests of phases 5 / 5b (refs: request 0's outputs, same weights and
    rays), timed in turns with a bfloat16_all request (bf16, int8, int8,
    bf16); launches held: no K1 (the sigma passes run the int8 trunk),
    K2 (K4 with the switch) on the bfloat16_all twin for the main pass,
    INT8_PER_CHUNK int8 products a chunk; 256 rays against the CPU twins
    (check_served at the bf16 bounds); a request with normal_at_surface
    (no K2: INT8_AT_SURFACE int8 products a chunk); then the eval CLI at
    --compute_dtype int8 on the workflow's stage-2 run, its scores against
    the bfloat16_all eval's (wf_scores) within INT8_SCORES."""
    from brdfnerf_tpu_torch.cli import eval as cli_eval
    from brdfnerf_tpu_torch.models import network as tnet
    from brdfnerf_tpu_torch.serve import load_renderer
    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    n = requests[0].shape[0]

    def request(r, rays):
        reset_counts()
        tnet.INT8_MM.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = r.render_image({"rays": rays})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts(), tnet.INT8_MM.launches

    def gaps(a, b):
        got = {}
        for k in ("rgb_coarse", "depth_coarse", "normal_an_coarse"):
            d = np.abs(a[k] - b[k]).reshape(len(a[k]), -1).max(-1)
            got[k] = (float(d.mean()), float(np.quantile(d, 0.99)),
                      float(d.max()))
        return got

    rb = load_renderer(run_dir, 1, device="cuda")
    r8 = load_renderer(run_dir, 1, compute_dtype="int8", device="cuda")
    assert r8.cfg.model.compute_dtype == "int8"
    assert r8.cfg.render.use_pallas and r8.cfg.render.fused_trunk
    for heads in (False, True):
        label = "int8" + (", fused heads" if heads else "")
        if heads:
            os.environ[FUSED_HEADS] = "1"
        try:
            secs = {"bf16": [], "int8": []}
            for name, r in (("bf16", rb), ("int8", r8), ("int8", r8),
                            ("bf16", rb)):
                out, dt, launches, n8 = request(r, requests[0])
                secs[name].append(dt)
                if name == "bf16":
                    continue
                want = dict(zero, **({"K4": per_req} if heads
                                     else {"K2": per_req}))
                print(f"  request, {label}: launches {launches}, int8 "
                      f"products {n8} over {per_req} chunks", flush=True)
                assert launches == want, launches
                assert n8 == INT8_PER_CHUNK * per_req, n8
                out8 = out
            print(f"  request, {label}: bfloat16_all {n / min(secs['bf16']):.1f}"
                  f" rays/s, int8 {n / min(secs['int8']):.1f} rays/s (faster "
                  f"of two each, in turns; seconds {secs}) ({smi})",
                  flush=True)
            for k, v in out8.items():
                assert np.isfinite(v).all(), k
            g = gaps(out8, refs["heads" if heads else "bf16"])
            for k, (mean, p99, mx) in g.items():
                print(f"  {label} vs the bfloat16_all request of phase "
                      f"{'5b' if heads else '5'}, {k}: per-ray largest |d| "
                      f"mean {mean:.3e} p99 {p99:.3e} max {mx:.3e}",
                      flush=True)
            lo, hi = INT8_RGB_MEAN
            assert lo <= g["rgb_coarse"][0] <= hi, g["rgb_coarse"]
            lo, hi = INT8_DEPTH_MEAN
            assert lo <= g["depth_coarse"][0] <= hi, g["depth_coarse"]
            rows["K4" if heads else "K2"]["launches_int8"] = want[
                "K4" if heads else "K2"]
            rows["K1"].setdefault("launches_int8", 0)
            if not heads:
                # 256 rays through the card against the CPU twins (the
                # sigma passes' int8 products on the CPU too)
                check_served([out8], r8, n_check=256)
        finally:
            os.environ.pop(FUSED_HEADS, None)
    del rb
    r8s = load_renderer(run_dir, 1, compute_dtype="int8",
                        normal_at_surface=True, device="cuda")
    out, dt, launches, n8 = request(r8s, requests[0])
    print(f"  request, int8, normal_at_surface: launches {launches}, int8 "
          f"products {n8}; {n / dt:.1f} rays/s ({smi})", flush=True)
    assert launches == zero and n8 == INT8_AT_SURFACE * per_req, (launches,
                                                                  n8)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    del r8, r8s

    reset_counts()
    tnet.INT8_MM.launches = 0
    scores = {}
    saved = cli_eval.evaluate

    def evaluate(*a, **k):
        scores["int8"] = saved(*a, **k)
        return scores["int8"]

    cli_eval.evaluate = evaluate
    try:
        rc, text, seconds = run_cli(
            "eval, int8", cli_eval.main,
            ["--logs_dir", wf_run, "--epoch_number", str(wf_epoch),
             "--compute_dtype", "int8", "--output_dir",
             os.path.join(root, "eval_int8")], smi)
    finally:
        cli_eval.evaluate = saved
    launches, n8 = counts(), tnet.INT8_MM.launches
    print(f"  eval, int8: launches {launches}, int8 products {n8} over "
          f"{WF_CHUNKS} chunks; scores {scores['int8']}; bfloat16_all "
          f"{wf_scores} ({smi})", flush=True)
    assert rc == 0 and launches == dict(zero, K2=WF_CHUNKS), launches
    assert n8 == INT8_PER_CHUNK * WF_CHUNKS, n8
    line = [ln for ln in text.splitlines() if ln.startswith("[kernels]")]
    assert len(line) == 1 and "int8 products" in line[0], line
    for k, tol in INT8_SCORES:
        assert np.isfinite(scores["int8"][k]), k
        assert abs(scores["int8"][k] - wf_scores[k]) <= tol, (
            k, scores["int8"][k], wf_scores[k])
    rows["K2"]["launches_int8_eval"] = launches["K2"]


# data parallelism (phase 17)
DP_STEPS = 8                # timed steps of each run, in turns
# a split request against the one-replica request: atol = rtol, the JAX
# package's sharded render bound (tests/test_sharding.py:106)
SPLIT_TOL = 1e-5


def free_cache():
    """Hand this process's cached, unused device memory back to CUDA
    before NCCL or another process on the card allocates outside it:
    after the 12 x 2048 runs torch's cache held 78.23 of the H100's 79.18
    GiB, and the data-parallel phase's first NCCL collective, and on
    another run a spawned tensor-parallel rank, failed with CUDA out of
    memory."""
    print(f"  device memory: allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB; the cache freed",
          flush=True)
    torch.cuda.empty_cache()


def dp_phase(root, wf_run, requests, refs, smi, rows, reset_counts, counts,
             per_req):
    """Phase 17, data parallelism on the one card: the flagship fused step
    (bfloat16_all, batch BATCH) on a mesh of one NCCL rank (the world size
    --n_devices 1 runs) against the one-device step, two steps bit for
    bit (loss, metrics, every gradient and parameter); the two timed in
    turns (one device, mesh, mesh, one device; DP_STEPS steps each,
    launches K1 2 / K2 1 / K3 1 a step on the mesh); one step on two gloo
    ranks sharing the card (NCCL refuses two ranks on one device; spawned
    processes) at float32 against the one-device step on the global batch
    at tools/dp_check's bounds (the JAX package's
    tests/test_sharding.py:100-104: loss within 1e-5 of max(1, |loss|),
    each gradient within atol 5e-6 + rtol 5e-5 of its largest magnitude;
    float32, whose kernels sit ~500 times closer to exact products than
    bfloat16_all's, so that the split batch's other summation order stays
    under the bound); the train CLI with --n_devices 1 --sharded_store 1
    --scale_global_batch 1 for 8 steps on the workflow's AOI;
    load_renderer(n_devices=1) against phase 5's request bit for bit; and
    the split render of a multi-device server: two replicas sharing the
    card, each chunk's rays and draws in two blocks rendered from two
    threads (parallel/train_step.render_blocks), against phase 5's
    request at SPLIT_TOL, K1 2 / K2 1 a chunk on each replica."""
    from brdfnerf_tpu_torch.cli import opts as opts_mod
    from brdfnerf_tpu_torch.cli import train as cli_train
    from brdfnerf_tpu_torch.data.batcher import DeviceRayBatcher
    from brdfnerf_tpu_torch.parallel import train_step as ts
    from brdfnerf_tpu_torch.parallel.mesh import init_mesh, new_store_path
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.tools import dp_check
    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    p = dp_check.flagship_payload("bfloat16_all", 512, BATCH)
    n_store = p["store"]["rays"].shape[0]
    p["idx"].append(np.random.RandomState(5).permutation(n_store)[
        :BATCH].astype(np.int32))
    one = dp_check.run_steps(None, p, device="cuda")
    free_cache()
    t0 = time.perf_counter()
    mesh = init_mesh(0, 1, new_store_path(root), "cuda:0")
    print(f"  a mesh of one rank: backend {mesh.backend}, joined in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    assert mesh.backend == "nccl"
    try:
        got = dp_check.run_steps(mesh, p)
        same = (one["loss"] == got["loss"]
                and one["metrics"] == got["metrics"]
                and all(np.array_equal(one["grads"][k], got["grads"][k])
                        for k in one["grads"])
                and all(np.array_equal(one["params"][k], got["params"][k])
                        for k in one["params"]))
        print(f"  2 flagship steps, one NCCL rank vs one device: losses "
              f"{got['loss']} vs {one['loss']}; bit for bit {same}",
              flush=True)
        assert same

        mcfg, rcfg, tcfg = p["mcfg"], p["rcfg"], p["tcfg"]
        sched = ts.GateSchedule(**p["sched"])
        store = make_store(STORE_BATCHES * BATCH, np.random.RandomState(0))
        per = {}

        def timed(on_mesh):
            m = mesh if on_mesh else None
            batcher = DeviceRayBatcher(store, BATCH, seed=0, device="cuda",
                                       mesh=m)
            state, optimizer = ts.create_train_state(
                mcfg, tcfg, batcher.steps_per_epoch, seed=0, device="cuda")
            step = ts.make_fused_train_step(mcfg, rcfg, tcfg, optimizer,
                                            sched, mesh=m)
            for _ in range(WARM_STEPS):
                state, _ = step(state, batcher.store,
                                batcher.next_index_tensor(), 0)
            torch.cuda.synchronize()
            reset_counts()
            ms, losses = [], []
            for _ in range(DP_STEPS):
                t0 = time.perf_counter()
                state, met = step(state, batcher.store,
                                  batcher.next_index_tensor(), 0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
            per.setdefault(on_mesh, []).append((ms, counts(), losses))

        for on_mesh in (False, True, True, False):
            timed(on_mesh)
        for on_mesh, runs in per.items():
            best = min(min(r[0]) for r in runs)
            mean = np.mean([np.mean(r[0]) for r in runs])
            print(f"  {'mesh of one NCCL rank' if on_mesh else 'one device'}"
                  f": ms/step fastest {best:.3f}, mean {mean:.3f}; train "
                  f"rays/s {BATCH / best * 1e3:.1f} (fastest step), "
                  f"{BATCH / mean * 1e3:.1f} (mean) ({smi})", flush=True)
        assert per[True][0][2] == per[False][0][2], "mesh losses differ"
        launches = per[True][0][1]
        assert launches == dict(zero, K1=2 * DP_STEPS, K2=DP_STEPS,
                                K3=DP_STEPS), launches
        rows["K1"]["launches_dp"] = launches["K1"]
        rows["K2zs"]["launches_dp"] = launches["K2"]
        rows["K3"]["launches_dp"] = launches["K3"]
    finally:
        mesh.close()

    t0 = time.perf_counter()
    p32 = dp_check.flagship_payload("float32", 512, BATCH)
    one32 = dp_check.run_steps(None, p32, device="cuda")
    two = dp_check.on_ranks(p32, 2, "cuda", backend="gloo",
                            devices=["cuda:0", "cuda:0"], store_dir=root)
    c = dp_check.compare(one32, two)
    top = sorted(c["grad_rel"].items(), key=lambda kv: -kv[1])[:3]
    print(f"  one float32 step on two gloo ranks sharing the card vs one "
          f"device: loss {c['loss'][1]:.7f} vs {c['loss'][0]:.7f} (relative "
          f"{c['loss_rel']:.2e}); largest gradient differences over their "
          f"scales {[(k, f'{v:.2e}') for k, v in top]}; held {c['held']}; "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start "
          f"({smi})", flush=True)
    assert c["held"], c["worst"]

    args = opts_mod.load_opts(wf_run)
    logs = os.path.join(root, "logs")
    argv = ["--root_dir", args.root_dir, "--gt_dir", args.gt_dir,
            "--aoi_id", args.aoi_id, "--logs_dir", logs, "--ckpts_dir",
            os.path.join(root, "ckpts"), "--model", "spsbrdf-nerf",
            "--mapping", "--fc_feat", "512", "--fc_layers", "8",
            "--n_samples", str(N_SAMPLES), "--guided_samples",
            str(N_SAMPLES), "--batch_size", str(BATCH), "--lr", "5e-4",
            "--ds_lambda", "10", "--compute_dtype", "bfloat16_all",
            "--chunk", str(CHUNK), "--normal", "analystic", "--sun_v",
            "analystic", "--funcM", "1", "--funcF", "1", "--funcH", "1",
            "--brdf_on", "0", "--nr_reg_an_lambda", "0.1", "--hs_lambda",
            "0.5", "--exp_name", "dp", "--max_train_steps", "8",
            "--eval_every_n_epochs", "0", "--n_devices", "1",
            "--sharded_store", "1", "--scale_global_batch", "1"]
    reset_counts()
    rc, text, seconds = run_cli("train CLI, --n_devices 1", cli_train.main,
                                argv, smi)
    launches = counts()
    assert rc == 0 and "[mesh] 1 data-parallel rank(s), nccl on cuda" in text
    # the steps' K3 (validation renders run no backward); the final
    # validation's chunks add K1 and K2 launches
    assert launches["K3"] == 8 and launches["K1"] >= 16, launches
    with open(os.path.join(logs, "dp", "scalars.jsonl")) as f:
        loss = [json.loads(ln) for ln in f]
    loss = [r["train/loss"] for r in loss if "train/loss" in r]
    assert loss and all(np.isfinite(loss)), loss
    assert os.path.exists(os.path.join(root, "ckpts", "dp", "epoch=0.npz"))

    r1 = load_renderer(refs["run_dir"], 1, n_devices=1, device="cuda")
    out = r1.render_image({"rays": requests[0]})
    same = all(np.array_equal(out[k], refs["bf16"][k]) for k in out)
    print(f"  load_renderer(n_devices=1) vs phase 5's request: bit for bit "
          f"{same}", flush=True)
    assert same and sorted(out) == sorted(refs["bf16"])

    r1.replicas = [(r1.device, r1.net),
                   (r1.device, copy.deepcopy(r1.net))]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = r1.render_image({"rays": requests[0]})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    gap = {k: float(np.max(np.abs(out[k] - refs["bf16"][k])
                           - SPLIT_TOL * np.abs(refs["bf16"][k])))
           for k in out}
    worst = max(gap, key=gap.get)
    print(f"  two replicas sharing the card vs phase 5's request: launches "
          f"{launches}; largest |d| - {SPLIT_TOL:g} |ref| {gap[worst]:.3e} "
          f"({worst}); {requests[0].shape[0] / dt:.1f} rays/s ({smi})",
          flush=True)
    assert sorted(out) == sorted(refs["bf16"])
    assert gap[worst] <= SPLIT_TOL, (worst, gap[worst])
    assert launches == dict(zero, K1=4 * per_req, K2=2 * per_req), launches
    rows["K1"]["launches_split"] = launches["K1"]
    rows["K2"]["launches_split"] = launches["K2"]


# tensor parallelism (phase 18): rays of the 12 x 2048 step, few enough
# that its host-staged all-reduces take seconds
TP_BATCH = 64


def tp_phase(root, smi, rows, reset_counts, counts):
    """Phase 18, tensor parallelism on the one card: one float32 step of
    the 12 x 2048 trunk, skip 4 (tools/tp_check.run: RPV(111), analytic
    normals with their regularization, hard surface and depth losses, the
    sun march, 64 + 64 samples, TP_BATCH rays) on a (1, 2) mesh of two
    gloo ranks sharing the card (NCCL refuses two ranks on one device; the
    second rank a spawned process) against the one-device unfused step on
    the same whole weights, global batch and draws, at the JAX package's
    TP bounds (tests/test_tensor_parallel.py: loss rtol 2e-4; parameters
    rtol 2e-4 / atol 2e-6 but for tp_check.FLIP_SHARE of a tensor's
    elements, within 2 * lr; every gradient within 2e-4 of its largest
    magnitude); each rank holds its share of the trunk's bytes (half of
    every weight); K1-K5 launched 0 times by the one-device step, by this
    process and by the ranks (row key launches_tp); the model group's
    collectives printed (calls, bytes, seconds on the host's clock, gloo
    staging through the host: they measure the host, not NCCL); and the
    [kernels] line of the flagship 8 x 512 train CLI with --n_devices 2
    --tp 2 names tensor parallelism."""
    from brdfnerf_tpu_torch.cli import opts as opts_mod
    from brdfnerf_tpu_torch.cli import train as cli_train
    from brdfnerf_tpu_torch.tools import tp_check
    os.makedirs(root, exist_ok=True)
    reset_counts()
    free_cache()
    t0 = time.perf_counter()
    c = tp_check.run(1, 2, "float32", 2048, 12, TP_BATCH, "cuda",
                     backend="gloo", devices=["cuda:0", "cuda:0"],
                     store_dir=root)
    seconds = time.perf_counter() - t0
    here = counts()
    launches = {k: here[k] + c["launches_mesh"][k] for k in here}
    col = c["collectives"]
    print(f"  one float32 step of the 12 x 2048 trunk ({TP_BATCH} rays) on a "
          f"(1, 2) mesh of gloo ranks sharing the card vs one device: loss "
          f"{c['loss'][1]:.7f} vs {c['loss'][0]:.7f} (relative "
          f"{c['loss_rel']:.2e}); worst gradient {c['worst_grad'][0]} at "
          f"{c['worst_grad'][1]:.2e} of its scale; worst parameter "
          f"{c['worst_param'][0]}: {c['worst_param'][1][0]:.2e} of its "
          f"elements past the bound, largest |d| "
          f"{c['worst_param'][1][1]:.2e}; held {c['held']}", flush=True)
    print(f"  trunk bytes: {c['trunk_bytes_rank']:,} a rank (its share "
          f"{c['trunk_bytes_share']:,}) of one device's "
          f"{c['trunk_bytes_one']:,}; launches {launches} (one device "
          f"{c['launches_one']}, the ranks {c['launches_mesh']}); the model "
          f"group's collectives on rank 0: {col['calls']} calls, "
          f"{col['bytes']:,} bytes in, {col['seconds']:.3f} s; one-device "
          f"step {c['seconds_one']:.3f} s, the mesh's "
          f"{c['seconds_mesh']:.3f} s with the ranks' start; the check "
          f"{seconds:.1f} s ({smi})", flush=True)
    assert c["bytes_held"] and 2 * c["trunk_bytes_rank"] < (
        c["trunk_bytes_one"] * 1.001), c["trunk_bytes_rank"]
    assert not any(launches.values()), launches
    assert c["held"], (c["loss_rel"], c["worst_grad"], c["worst_param"])
    for key, r in rows.items():
        r["launches_tp"] = launches[key[:2]]

    args = opts_mod.postprocess(opts_mod.train_parser().parse_args(
        ["--root_dir", root, "--exp_name", "tp", "--model", "spsbrdf-nerf",
         "--mapping", "--fc_feat", "512", "--fc_layers", "8", "--normal",
         "analystic", "--sun_v", "analystic", "--funcM", "1", "--funcF",
         "1", "--funcH", "1", "--compute_dtype", "bfloat16_all",
         "--n_devices", "2", "--tp", "2"]))
    cuda = torch.device("cuda")
    line = cli_train.kernels_line(opts_mod.to_run_config(args, device=cuda),
                                  cuda, tp=args.tp)
    print(f"  the flagship's train CLI with --n_devices 2 --tp 2: {line}",
          flush=True)
    assert line.startswith("[kernels] none: tensor parallelism (--tp 2)")


def main():
    phase("device")
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}",
          flush=True)
    # the reference precision: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.data.batcher import DeviceRayBatcher
    from brdfnerf_tpu_torch.models.network import init_network
    from brdfnerf_tpu_torch.ops import cuda_build
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.ops import trunk_layers as kl
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    from brdfnerf_tpu_torch.parallel import train_step as ts
    from brdfnerf_tpu_torch.render import render as render_mod
    from brdfnerf_tpu_torch.render.render import chunk_draws
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.tools import f32_check as fc
    from brdfnerf_tpu_torch.tools import act_check
    from brdfnerf_tpu_torch.tools import width_check
    from brdfnerf_tpu_torch.tools.bwd_check import ptxas_summary
    from brdfnerf_tpu_torch.tools.width_check import (bound_ms,
                                                      matmul_chains,
                                                      trunk_work)
    peaks = width_check.peaks_of(kind)
    from brdfnerf_tpu_torch.utils.checkpoint import save_checkpoint

    phase("build")
    t0 = time.perf_counter()
    # every kernel library, for each activation (the polynomial sine, the
    # exact sine, ReLU: one -DTRUNK_ACT build each), one nvcc a library,
    # all started together
    cuda_build.build(act_check.libraries() + width_check.libraries())
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in cuda_build.build_log.items():
        # nvcc's seconds; per kernel function: registers (the count at
        # launch; the consumer warps raise theirs with setmaxnreg), spills,
        # the stack frame (sinf's slow path would show here) and static
        # shared memory (the dynamic share is set at launch)
        frames = sorted({ln.split("ptxas info    :")[-1].strip()[:60]
                         for ln in rec["log"].splitlines()
                         if "stack frame" in ln})
        print(f"  {name}: nvcc {rec['seconds']:.1f} s; stack frames and "
              f"spills {frames}", flush=True)
        for fn in ptxas_summary(rec["log"]):
            print(f"    {fn['name'][:60]}: {fn['registers']} registers, "
                  f"spills {fn['spill_stores']} B stored / "
                  f"{fn['spill_loads']} B loaded, static smem {fn['smem']} B",
                  flush=True)

    # ------------------------------------------------ the flagship run
    tmp = tempfile.TemporaryDirectory()
    argv = ["--root_dir", tmp.name, "--exp_name", "smoke",
            "--ckpts_dir", os.path.join(tmp.name, "ckpts"),
            "--model", "spsbrdf-nerf", "--fc_layers", "8", "--fc_feat",
            "512", "--mapping", "--siren", "1", "--fast_sin", "1",
            "--compute_dtype", "bfloat16_all", "--normal", "analystic",
            "--sun_v", "analystic", "--funcM", "1", "--funcF", "1",
            "--funcH", "1", "--dim_RPV", "1", "--brdf_on", "0.5",
            "--n_samples", str(N_SAMPLES), "--guided_samples",
            str(N_SAMPLES), "--chunk", str(CHUNK),
            # the flagship's TrainConfig (__graft_entry__._flagship_configs)
            "--lr", "5e-4", "--batch_size", str(BATCH), "--ds_lambda", "10",
            "--nr_reg_an_lambda", "0.1", "--hs_lambda", "0.5"]
    args = opts.postprocess(opts.train_parser().parse_args(argv))
    run_dir = os.path.join(tmp.name, "run")
    opts.dump_opts(args, run_dir)
    cfg = opts.to_run_config(args, device="cuda")
    assert cfg.render.use_pallas and cfg.render.fused_trunk, cfg.render
    assert cfg.render.apply_brdf and not cfg.render.apply_theta, cfg.render
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = init_network(cfg.model, gen, device="cuda")
    save_checkpoint(os.path.join(tmp.name, "ckpts", "smoke", "epoch=1.npz"),
                    {"coarse": net}, step=0)

    phase("kernels")
    mcfg = cfg.model
    packed = k1.pack_trunk_weights(net, mcfg, torch.bfloat16)
    wbytes = sum(v.numel() * v.element_size() for v in packed.values())
    ein = mcfg.xyz_in_dim
    feat = mcfg.feat
    rows = {}
    chain_fwd, chain_k2, chain_k3_of = matmul_chains(packed, mcfg, k1.LANE)

    def points(n):
        xyz = torch.rand(n, 3, device="cuda", generator=gen) * 2 - 1
        return positional_encoding(xyz, mcfg.mapping_sizes[0], fast=True,
                                   pad_to=k1.LANE)

    # K1: two sigma-only passes per chunk, CHUNK * N_SAMPLES points each,
    # and per train step, BATCH * N_SAMPLES points each
    n1 = CHUNK * N_SAMPLES
    enc = points(n1)
    err = k1_check("K1", k1, packed, mcfg, enc, False)
    err = max(err, k1_check(f"K1 at {BATCH * N_SAMPLES} points", k1, packed,
                            mcfg, points(BATCH * N_SAMPLES), False))
    encb, encl = k1.split_bf16(enc)
    rows["K1"] = {
        "name": "trunk_sigma", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_sigma.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_mlp.py:114",
        "max_abs_err": err,
        "ms": timed(lambda: k1._trunk_sigma_cuda(packed, mcfg, enc, False),
                    10),
        "plain_ms": timed(lambda: k1._trunk_sigma_plain(packed, mcfg, enc,
                                                        False), 2),
        # K1's fidelity: the hi and the lo chain, summed
        "library_ms": timed(lambda: chain_fwd(encb)[0] + chain_fwd(encl)[0],
                            10),
        "library_bf16_ms": timed(lambda: chain_fwd(encb), 10)}
    k1_flops, k1_bytes = trunk_work("K1", mcfg, n1, wbytes)
    rows["K1"]["bound_ms"], rows["K1"]["bound_by"] = bound_ms(
        k1_flops, k1_bytes, peaks)
    # the split issues every product twice
    rows["K1"]["bound_split_ms"], _ = bound_ms(2 * k1_flops, k1_bytes, peaks)
    del enc, encb, encl

    # K2: the main pass, CHUNK * 2 * N_SAMPLES points
    n2 = CHUNK * 2 * N_SAMPLES
    enc = points(n2)
    out_k = k2._trunk_fwd_grad_cuda(packed, mcfg, enc)
    same_twice("K2", out_k, k2._trunk_fwd_grad_cuda(packed, mcfg, enc))
    out_p = k2._trunk_fwd_grad_plain(packed, mcfg, enc)
    torch.cuda.synchronize()
    errs = []
    for name, got, ref in zip(("sigma", "feats", "gx"), out_k, out_p):
        e = diff(f"K2 {name}", got, ref)
        errs.append(e["max"])
        # both sides round the same operands to bf16; the tensor cores sum
        # in another order than the twin's f32 matmul, which flips a few
        # bf16 roundings, and each flip perturbs the next layer by far more
        # than an ulp, so the flips cascade through the 8 layers (measured
        # on 65,536 points: sigma mean 1.0e-4, feats mean 2.9e-4, gx mean
        # 1.1e-4 at scale 0.72), bounded by K1's all-elements difference
        assert torch.isfinite(got.float()).all(), name
        assert e["max"] <= 5e-2 * e["scale"], name
        assert e["mean"] <= 1e-3 * e["scale"], name
    assert out_k[2][:, ein:].abs().max().item() == 0.0, "gx padded lanes"
    del out_k, out_p
    encb = enc.to(torch.bfloat16)
    rows["K2"] = {
        "name": "trunk_fwd_grad", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_fwd_grad.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_trunk_vjp.py:205",
        "max_abs_err": max(errs),
        "ms": timed(lambda: k2._trunk_fwd_grad_cuda(packed, mcfg, enc), 5),
        "plain_ms": timed(lambda: k2._trunk_fwd_grad_plain(packed, mcfg,
                                                           enc), 1),
        "library_ms": timed(lambda: chain_k2(encb), 5)}
    rows["K2"]["bound_ms"], rows["K2"]["bound_by"] = bound_ms(
        *trunk_work("K2", mcfg, n2, wbytes), peaks)
    del enc, encb

    # K2 saving zs/us, and K3, at the train step's main pass: BATCH *
    # 2 * N_SAMPLES points
    n3 = BATCH * 2 * N_SAMPLES
    enc = points(n3)
    out_k = k2._trunk_fwd_grad_cuda(packed, mcfg, enc, want_zs=True)
    same_twice("K2 saving zs/us", out_k,
               k2._trunk_fwd_grad_cuda(packed, mcfg, enc, want_zs=True))
    out_p = k2._trunk_fwd_grad_plain(packed, mcfg, enc, want_zs=True)
    plain_k = k2._trunk_fwd_grad_cuda(packed, mcfg, enc)
    torch.cuda.synchronize()
    errs = []
    for name, got, ref in zip(("sigma", "feats", "gx", "zs", "us"), out_k,
                              out_p):
        e = diff(f"K2+zs/us {name}", got, ref)
        errs.append(e["max"])
        # as K2 above; zs/us are bf16 roundings of the same cascading values
        assert torch.isfinite(got.float()).all(), name
        assert e["max"] <= 5e-2 * e["scale"], name
        assert e["mean"] <= 1e-3 * e["scale"], name
        assert e["rel"] <= 1e-2, name
    # the saving instantiation computes what the serving one does
    for name, a_, b_ in zip(("sigma", "feats", "gx"), out_k, plain_k):
        assert torch.equal(a_, b_), f"K2 with zs/us changes {name}"
    del plain_k, out_p
    k2_nozs_ms = timed(lambda: k2._trunk_fwd_grad_cuda(packed, mcfg, enc), 5)
    zs, us = out_k[3], out_k[4]
    del out_k
    cs = torch.randn(n3, device="cuda", generator=gen)
    cf = (torch.randn(n3, feat, device="cuda", generator=gen)
          * 0.1).to(torch.bfloat16)
    cg = torch.zeros(n3, k1.LANE, device="cuda")
    cg[:, :ein] = torch.randn(n3, ein, device="cuda", generator=gen)
    got = k2._trunk_bwd_cuda(packed, mcfg, enc, cs, cf, cg, zs, us)
    again = k2._trunk_bwd_cuda(packed, mcfg, enc, cs, cf, cg, zs, us)
    ref = k2._trunk_bwd_plain(packed, mcfg, enc, cs, cf, cg, zs, us)
    torch.cuda.synchronize()
    k3_err, k3_rel = 0.0, 0.0
    for name, g_, r_, a_ in zip(("dw0", "db0", "dwm", "dbm", "dwst", "dwsb",
                                 "dbs", "dwsig", "dbsig"), got, ref, again):
        e = diff(f"K3 {name}", g_, r_)
        k3_err = max(k3_err, e["max"])
        k3_rel = max(k3_rel, 0.0 if name == "dbsig" else e["rel"])
        assert torch.isfinite(g_).all(), name
        # deterministic: a fixed summation order, no atomics
        assert torch.equal(g_, a_), f"K3 {name} differs between launches"
        if name == "dbsig":
            dbsig_held("K3", g_, r_, fc.dbsig_scale(packed, mcfg, cs, cg,
                                                    zs))
            continue
        # a grad is a sum over all points; the kernel and the twin round
        # the same operands to bf16, but their f32 sums run in other
        # orders, which flips some of the downstream bf16 roundings, as in
        # K2 (measured on the card: relative L2 1.6e-3 .. 3.6e-3 per
        # tensor)
        assert e["rel"] <= 1e-2, f"K3 {name} relative L2 {e['rel']:.3e}"
    del got, again, ref
    rows["K2zs"] = {
        "name": "trunk_fwd_grad (saving zs/us)", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_fwd_grad.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_trunk_vjp.py:205",
        "max_abs_err": max(errs),
        "ms": timed(lambda: k2._trunk_fwd_grad_cuda(packed, mcfg, enc,
                                                    want_zs=True), 5),
        "plain_ms": timed(lambda: k2._trunk_fwd_grad_plain(
            packed, mcfg, enc, want_zs=True), 1)}
    rows["K2zs"]["bound_ms"], rows["K2zs"]["bound_by"] = bound_ms(
        *trunk_work("K2zs", mcfg, n3, wbytes), peaks)
    encb = enc.to(torch.bfloat16)
    rows["K2zs"]["library_ms"] = timed(lambda: chain_k2(encb), 5)

    # the yardstick of K3: the same products as bf16 torch.matmul calls --
    # the tangent chain, the a chain, and each layer's dW as
    # [h; th]^T [a_z; b_tz] over both halves of K (operands made once)
    cgb = cg.to(torch.bfloat16)
    hth = torch.randn(2 * n3, feat, device="cuda",
                      generator=gen).to(torch.bfloat16)
    azb = torch.randn(2 * n3, feat, device="cuda",
                      generator=gen).to(torch.bfloat16)
    xtb = torch.cat([encb, cgb], 0)

    def chain_k3():
        chain_k3_of(cgb, azb, hth, xtb)

    # reads zs, us, cf, x, cg, cs and the weights; writes the f32 grads
    k3_flops, k3_bytes = trunk_work("K3", mcfg, n3, wbytes)
    rows["K3"] = {
        "name": "trunk_bwd", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_bwd.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_trunk_vjp.py:240",
        "max_abs_err": k3_err,
        "ms": timed(lambda: k2._trunk_bwd_cuda(packed, mcfg, enc, cs, cf, cg,
                                               zs, us), 5),
        "plain_ms": timed(lambda: k2._trunk_bwd_plain(packed, mcfg, enc, cs,
                                                      cf, cg, zs, us), 1),
        "library_ms": timed(chain_k3, 5)}
    rows["K3"]["bound_ms"], rows["K3"]["bound_by"] = bound_ms(
        k3_flops, k3_bytes, peaks)
    rows["K3"]["_flops"], rows["K3"]["_bytes"] = k3_flops, k3_bytes
    rows["K3"].update(kernel_parts(lambda: k2._trunk_bwd_cuda(
        packed, mcfg, enc, cs, cf, cg, zs, us)))
    heads_kernels(rows, mcfg, net, packed, wbytes, points, chain_k2,
                  chain_k3, peaks, gen)
    del enc, encb, cgb, hth, azb, xtb, zs, us, cs, cf, cg
    backward_small(192, mcfg, net, packed, points, gen)
    forward_small(192, mcfg, net, packed, points)
    phase("kernels, float32")
    f32_kernels(rows, mcfg, net, points, peaks, gen)
    phase("kernels, activations")
    act_kernels(rows, points, gen, {})
    # every sweep instantiation (K3 and K5: each activation at every
    # dtype) launched twice more at the training step's 131,072 points,
    # bit-identical
    act_check.sweeps_twice(BATCH * 2 * N_SAMPLES)
    for r in rows.values():
        print(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
              f"by {r['bound_by']}, twin {r['plain_ms']:.1f}, matmul chain "
              f"{r['library_ms']:.3f})" + "".join(
                  f", {k[:-3]} {r[k]:.3f}" for k in (
                      "bound_split_ms", "library_bf16_ms", "uchain_ms",
                      "sweep_ms", "wgrad_ms", "reduce_ms") if k in r),
              flush=True)
    print(f"  K3 largest relative L2 against its twin {k3_rel:.3e}; K2 "
          f"at {n3} points without zs/us {k2_nozs_ms:.3f} ms", flush=True)

    requests = []
    for q in range(N_REQUESTS):
        rng = torch.Generator().manual_seed(100 + q)
        n = REQ_SIDE * REQ_SIDE
        o = torch.rand(n, 3, generator=rng) * 2 - 1
        d = torch.tensor([[0.05, 0.02, -1.0]]).expand(n, 3)
        d = d / d.norm(dim=-1, keepdim=True)
        sun = torch.tensor([[0.3, 0.2, 0.93]]).expand(n, 3)
        sun = sun / sun.norm(dim=-1, keepdim=True)
        requests.append(torch.cat([o, d, torch.zeros(n, 1),
                                   torch.full((n, 1), 2.0), sun], 1).numpy())
    kernels = {"K1": k1.TRUNK_SIGMA, "K2": k2.TRUNK_FWD_GRAD,
               "K3": k2.TRUNK_BWD, "K4": k4.TRUNK_HEADS_FWD,
               "K5": k4.TRUNK_HEADS_BWD}
    # the layer-major family's K1-K5 (ops/trunk_layers.py): counted as
    # K1L..K5L where they launched, so that every other phase's expected
    # counts (K1-K5) also say that none of them did
    wide = {"K1L": kl.TRUNK_SIGMA_WIDE, "K2L": kl.TRUNK_FWD_GRAD_WIDE,
            "K3L": kl.TRUNK_BWD_WIDE, "K4L": kl.TRUNK_HEADS_FWD_WIDE,
            "K5L": kl.TRUNK_HEADS_BWD_WIDE}
    chunks = N_REQUESTS * -(-REQ_SIDE * REQ_SIDE // CHUNK)
    renderer = load_renderer(run_dir, 1, device="cuda")
    assert renderer.chunk == CHUNK

    def reset_counts():
        for k in list(kernels.values()) + list(wide.values()):
            k.launches = 0

    def counts():
        return dict({k: v.launches for k, v in kernels.items()},
                    **{k: v.launches for k, v in wide.items() if v.launches})

    def serve(label, want, r=None, n_req=N_REQUESTS, profiled=True):
        """The first n_req requests through renderer r (the bfloat16_all one
        by default), launch counts checked; one profiled; returns the
        outputs."""
        r = renderer if r is None else r
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        seconds, outs = [], []
        for rays in requests[:n_req]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(r.render_image({"rays": rays}))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = counts()
        peak_mem = torch.cuda.max_memory_allocated()
        print(f"  launches {launches} over {chunks * n_req // N_REQUESTS} "
              f"chunks", flush=True)
        assert launches == want, launches
        rays_per_s = REQ_SIDE * REQ_SIDE / min(seconds)
        print(f"  request seconds {[round(s, 4) for s in seconds]}; "
              f"{rays_per_s:.1f} rays/s (fastest request); "
              f"{n_req * REQ_SIDE * REQ_SIDE / sum(seconds):.1f} rays/s "
              f"(all); peak memory {peak_mem / 2**30:.2f} GiB", flush=True)
        if profiled:
            profile_device(lambda: r.render_image({"rays": requests[1]}),
                           label)
        return outs, launches

    def check_served(outs, r=None, scale=1.0, keys3=FLAGSHIP_KEYS3,
                     keys1=("sun_coarse",), n_check=1024,
                     compared=("rgb_coarse", "depth_coarse",
                               "normal_an_coarse")):
        """Outputs finite and of their shapes (keys3: (n, 3) maps, keys1:
        (n, 1) maps), and n_check rays (none at 0) against the CPU twins
        (the `compared` keys), at the bf16 contract's bounds times
        `scale`."""
        r = renderer if r is None else r
        n = REQ_SIDE * REQ_SIDE
        for out in outs:
            assert out["rgb_coarse"].shape == (n, 3)
            assert out["depth_coarse"].shape == (n,)
            for k in keys3:
                assert out[k].shape == (n, 3), k
            for k in keys1:
                assert out[k].shape == (n, 1), k
            for k, v in out.items():
                assert np.isfinite(v).all(), k
        if not n_check:
            return
        # n_check rays through the kernels on the card and through the
        # plain twins (the Pallas kernels' arithmetic) on the CPU, same
        # weights and draws
        small = requests[0][:n_check]
        # every draw the render takes (chunk_draws: the stratified, guided
        # and sun-march uniforms as before; the fine pass's and the density
        # noise where the run has them)
        draws = chunk_draws(r.cfg.model, r.render_config(), len(small),
                            torch.device("cpu"), seed=7)
        a = dc.replace(r, chunk=len(small)).render_image(
            {"rays": small}, draws=draws)
        cpu = dc.replace(r, net=copy.deepcopy(r.net).cpu(),
                         device=torch.device("cpu"), chunk=len(small))
        b = cpu.render_image({"rays": small}, draws=draws)
        typs = ("coarse", "fine") if "rgb_fine" in a else ("coarse",)
        check = {}
        for k in compared + tuple(f"{k}_fine" for k in ("rgb", "depth")
                                  if len(typs) > 1):
            d = np.abs(a[k] - b[k]).reshape(len(small), -1).max(-1)
            check[k] = (float(d.mean()), float(np.quantile(d, 0.99)))
            print(f"  kernels vs twins {k}: mean {check[k][0]:.3e} "
                  f"p99 {check[k][1]:.3e}", flush=True)
        # the kernels' summation order moves the probe's depth and with it
        # the guided samples a little (the fine pass's samples too); the
        # siren trunk amplifies a moved sample on isolated rays
        for typ in typs:
            assert (check[f"depth_{typ}"][0] < 1e-2 * scale
                    and check[f"rgb_{typ}"][0] < 1e-2 * scale), typ
            assert check[f"rgb_{typ}"][1] < 0.1 * scale, typ

    phase("serving")
    outs, launches = serve("request", {"K1": 2 * chunks, "K2": chunks,
                                       "K3": 0, "K4": 0, "K5": 0})
    rows["K1"]["launches"] = launches["K1"]
    rows["K2"]["launches"] = launches["K2"]
    # request 0 at bfloat16_all, which phases 16 and 17 compare against
    refs = {"run_dir": run_dir, "bf16": outs[0]}

    phase("check")
    check_served(outs)
    del outs

    # the same requests with the flagship heads inside the kernel pair:
    # K4 takes K2's place, and the head block runs in no torch op
    phase("serving, fused heads")
    os.environ[FUSED_HEADS] = "1"
    outs, launches = serve("request, fused heads",
                           {"K1": 2 * chunks, "K2": 0, "K3": 0,
                            "K4": chunks, "K5": 0})
    rows["K4"]["launches"] = launches["K4"]
    refs["heads"] = outs[0]
    check_served(outs)
    del os.environ[FUSED_HEADS]
    del renderer, outs

    # the same requests at float32, the CLIs' default compute dtype: K1 and
    # K2 in their float32 instantiations (split products)
    phase("serving, float32")
    renderer32 = load_renderer(run_dir, 1, compute_dtype="float32",
                               device="cuda")
    assert renderer32.cfg.model.compute_dtype == "float32"
    assert renderer32.cfg.render.use_pallas
    assert renderer32.cfg.render.fused_trunk
    outs, launches = serve("request, float32",
                           {"K1": 2 * chunks, "K2": chunks, "K3": 0,
                            "K4": 0, "K5": 0}, renderer32)
    rows["K1f32"]["launches"] = launches["K1"]
    rows["K2f32"]["launches"] = launches["K2"]
    # the float32 contract's bounds, a tenth of the bf16 ones, as the step
    # check's below (its kernels sit ~500 times closer to their twins)
    check_served(outs, renderer32, scale=0.1)
    del renderer32, outs

    rcfg, tcfg = cfg.render, cfg.train
    # the gates' epoch is one step long, so that from step WARM_STEPS on
    # every gate of the JAX package's bench.py holds (cos_irra off, ds,
    # nrrg and hard-surface on, no beta warm-up); the optimizer's epoch is
    # the store's 16 steps
    sched = ts.GateSchedule(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                            steps_per_epoch=1, first_beta_epoch=0)
    assert ts.gates_from_step(WARM_STEPS, sched) == ts.TrainGates(
        cos_irra_on=False, ds_on=True, nrrg_on=True, beta_warmup=False,
        hs_on=True)

    bare_rays_s = {}

    def train(label, want, mcfg_=None, rcfg_=None, timed_steps=TIMED_STEPS,
              profiled=True, tcfg_=None, store_batches=STORE_BATCHES,
              kp_store=None):
        """WARM_STEPS + timed_steps flagship steps from a fresh seeded
        state (at model config mcfg_, render config rcfg_ and train config
        tcfg_, the bfloat16_all flagship's by default) on a store of
        store_batches batches, launch counts checked per step and, over 10
        steps or more, a falling loss (on a one-batch store, every step on
        the same rays: the last timed step's loss under the first's); one
        step profiled (if `profiled`).  The parameters hold a fine network
        where rcfg_.n_importance > 0 and the t table where mcfg_.beta;
        kp_store: sat-nerf's keypoint store (rays, depths, ts), of which
        each step gathers a sub-batch on the device.  Returns the weights
        after each of the last CHECK_POINTS timed steps (the last: after
        all of them) and the launch counts."""
        mcfg_ = mcfg if mcfg_ is None else mcfg_
        rcfg_ = rcfg if rcfg_ is None else rcfg_
        tcfg_ = tcfg if tcfg_ is None else tcfg_
        batcher = DeviceRayBatcher(
            make_store(store_batches * BATCH, np.random.RandomState(0)),
            BATCH, seed=0, device="cuda")
        spe = batcher.steps_per_epoch
        assert spe == store_batches
        state, optimizer = ts.create_train_state(
            mcfg_, tcfg_, spe, seed=0, n_importance=rcfg_.n_importance,
            device="cuda")
        step = ts.make_fused_train_step(mcfg_, rcfg_, tcfg_, optimizer,
                                        sched, has_kp=kp_store is not None)
        seed = 0
        kp = None
        if kp_store is not None:
            kp = DeviceRayBatcher(
                kp_store, min(BATCH, kp_store["rays"].shape[0]), seed=7,
                device="cuda")

        def one_step(state):
            kp_args = (dict(kp_store=kp.store, kp_idx=kp.next_index_tensor())
                       if kp else {})
            return step(state, batcher.store, batcher.next_index_tensor(),
                        seed, **kp_args)

        for _ in range(WARM_STEPS):
            state, m = one_step(state)
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, trained = [], [], []
        for i in range(timed_steps):
            t0 = time.perf_counter()
            state, m = one_step(state)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            if i >= timed_steps - CHECK_POINTS:
                trained.append(copy.deepcopy(state.params))
        launches = counts()
        peak_mem = torch.cuda.max_memory_allocated()
        print(f"  launches {launches} over {timed_steps} steps", flush=True)
        assert launches == {k: v * timed_steps for k, v in want.items()}, \
            launches
        assert state.step == WARM_STEPS + timed_steps
        bare_rays_s[label] = BATCH * len(step_ms) / sum(step_ms) * 1e3
        print(f"  ms/step fastest {min(step_ms):.3f}, mean "
              f"{sum(step_ms) / len(step_ms):.3f}; train rays/s "
              f"{BATCH / min(step_ms) * 1e3:.1f} (fastest step), "
              f"{BATCH * len(step_ms) / sum(step_ms) * 1e3:.1f} (mean); peak "
              f"memory {peak_mem / 2**30:.2f} GiB", flush=True)
        print(f"  loss {[round(v, 5) for v in losses]}", flush=True)
        print(f"  last metrics "
              f"{({k: round(float(v), 5) for k, v in m.items()})}",
              flush=True)
        assert all(np.isfinite(losses)), losses
        if timed_steps >= 10:
            first, last = np.mean(losses[:5]), np.mean(losses[-5:])
            print(f"  loss mean of the first five timed steps {first:.5f}, "
                  f"of the last five {last:.5f}", flush=True)
            assert last < first, (first, last)
        elif store_batches == 1:
            assert losses[-1] < losses[0], losses
        if profiled:
            state, _ = one_step(state)
            profile_device(lambda: one_step(state), label)
        return trained, launches

    # one step's parameter gradients on CHECK_RAYS rays at flagship width:
    # the kernels on the card against the twins, same weights, batch, gates
    # and draws: the gates after the timed steps, and the weights after each
    # of the last CHECK_POINTS timed steps (the last: after all of them).
    # The step's gradient is ill-conditioned on some rays: where a ray's
    # summed normal meets the sun or the view near grazing incidence, RPV's
    # Minnaert factor's derivatives grow like 1 / cos, and the normal's
    # turn under the bf16 contract (K2's gx against its twin, amplified
    # where the samples' normals cancel) changes that ray's gradient by
    # O(1).  Measured on the card at the weights after step 35 of the
    # switch-off run: one ray of 128 (cos i 1.2e-3, its samples' normals
    # summing to 0.06) carried 99.98% of the sigma cotangent's gap, and the
    # twins alone, card against CPU, reached 0.41 and 0.645 at other
    # weights (tools/step_check_points.py, PERF.md).  So at each point the
    # whole batch is run and printed, its backward comparison held to its
    # bound; then every comparison is held to its bound on the rays that
    # rpv_ill_conditioned leaves, reading the twins' render on the CPU from
    # the same pass that gives the CPU gradients on the whole batch (at
    # least half of them).  A miss is reported at the end of the run, which then
    # exits 1.
    bounds = {"backward kernel vs its twin": 1e-2,
              "both kernels vs their twins": 0.1,
              "all kernels vs twins on the CPU": 0.1,
              "every twin, on the card vs on the CPU": 0.1}
    # the comparison that holds on every ray: the same forward values
    whole_batch = ("backward kernel vs its twin",)
    step_failures = []
    s = make_store(CHECK_RAYS, np.random.RandomState(1))
    gates = ts.gates_from_step(WARM_STEPS + TIMED_STEPS, sched)
    rng = torch.Generator().manual_seed(11)
    n_sun = rcfg.sun_march_count(rcfg.n_samples + rcfg.effective_guided)
    draws = {"z": torch.rand(CHECK_RAYS, rcfg.n_samples, generator=rng),
             "guided": torch.rand(CHECK_RAYS, rcfg.effective_guided,
                                  generator=rng),
             "guided_gt": torch.rand(CHECK_RAYS, rcfg.effective_guided,
                                     generator=rng),
             "sun": torch.rand(CHECK_RAYS, n_sun, generator=rng)}

    def fine_samples(net_, mcfg_, rcfg_):
        """The fine pass's samples (CHECK_RAYS, n_importance) of the step
        through the kernels on the card on the whole batch, as sample_pdf
        draws them on that step's coarse weights; None without a fine
        network."""
        if rcfg_.n_importance == 0:
            return None
        real, got = render_mod.sample_pdf, []

        def record(*a, **kw):
            got.append(real(*a, **kw).detach().cpu())
            return got[-1].to(a[0].device)
        render_mod.sample_pdf = record
        try:
            grads_on(net_, "cuda", np.arange(CHECK_RAYS), mcfg_,
                     rcfg_=rcfg_)
        finally:
            render_mod.sample_pdf = real
        (fine_z,) = got
        return fine_z

    def grads_on(net_, dev, rays, mcfg_, bias_terms=None, rcfg_=None,
                 fine_z=None, results=None):
        """The step's loss and every parameter's gradient on `rays` (with a
        fine network, on the fine samples fine_z: fixed_fine); with
        bias_terms (a list), also (network name, the L2 norm of the sigma
        head's bias gradient's per-point terms) of each of the step's
        backward calls, appended (fused_trunk_vjp._run_bwd /
        fused_trunk_heads._run_bwd_h wrapped for the call); with results
        (a list), the step's training render, detached, appended
        (train_step.render_rays wrapped for the call)."""
        batch = {k: torch.as_tensor(v[rays], device=dev)
                 for k, v in s.items()}
        rows_ = torch.as_tensor(rays)
        net_.zero_grad(set_to_none=True)
        run_bwd, run_bwd_h = k2._run_bwd, k4._run_bwd_h
        owner = pack_owners(net_)

        def terms(cfg_, packed_, c_s, c_g, zs_):
            n_p = zs_.shape[0]
            cs_p = torch.zeros(n_p, dtype=torch.float32, device=zs_.device)
            cs_p[:c_s.shape[0]] = c_s
            cg_p = k1.pad_rows_lanes(c_g, n_p, packed_["w0"].shape[1])
            bias_terms.append((owner[packed_["b0"].data_ptr()],
                               fc.dbsig_scale(packed_, cfg_, cs_p, cg_p,
                                              zs_)))

        if bias_terms is not None:
            def rec_bwd(cfg_, packed_, x_, cs_, cf_, cg_, zs_, us_):
                terms(cfg_, packed_, cs_, cg_, zs_)
                return run_bwd(cfg_, packed_, x_, cs_, cf_, cg_, zs_, us_)

            def rec_bwd_h(cfg_, packed_, hw_, x_, cot_, cg_, zs_):
                terms(cfg_, packed_, cot_[:, 0], cg_, zs_)
                return run_bwd_h(cfg_, packed_, hw_, x_, cot_, cg_, zs_)
            k2._run_bwd, k4._run_bwd_h = rec_bwd, rec_bwd_h
        render = ts.render_rays
        if results is not None:
            def rec_render(*a, **kw):
                out = render(*a, **kw)
                if not results:
                    results.append({k: v.detach() for k, v in out.items()
                                    if torch.is_tensor(v)})
                return out
            ts.render_rays = rec_render
        try:
            with fixed_fine(fine_z, rays):
                loss, _ = ts.compute_losses(
                    net_, mcfg_, rcfg if rcfg_ is None else rcfg_, tcfg,
                    batch, gates,
                    draws={k: v[rows_].to(dev) for k, v in draws.items()})
            loss.backward()
        finally:
            k2._run_bwd, k4._run_bwd_h = run_bwd, run_bwd_h
            ts.render_rays = render
        return loss.item(), {k: p.grad.detach().cpu()
                             for k, p in net_.named_parameters()
                             if p.grad is not None}

    def step_check(path, nets, fwd, bwd, want, mcfg_=None, bounds_=None,
                   normal_err=NORMAL_ERR, rcfg_=None,
                   criterion=rpv_ill_conditioned, timed_steps=TIMED_STEPS,
                   n_rays=CHECK_RAYS, unfused=None, cpu_held=True):
        """At mcfg_ and rcfg_ (the bfloat16_all flagship's by default) with
        bounds_ (`bounds` by default), the contract's normal error
        normal_err and the set-aside `criterion` (RPV's by default):
        at each weights of `nets`, on the whole batch and then on its
        well-conditioned rays: the step with every kernel; with the
        backward kernel, then both kernels of the differentiated trunk,
        swapped for their twins on the card (K1 still the kernel: it
        separates what each changes from what K1 changes upstream); with
        K1's twin too; and on the CPU.  `fwd` and `bwd` are (module, kernel
        name, twin) of the pair.  Each comparison's largest relative L2 is
        held to its bound at every point (on the whole batch, those of
        whole_batch); misses go to step_failures.  With a fine network,
        every render at a point (the criterion's too) takes the fine
        samples of the step through the kernels on the whole batch
        (fine_samples, fixed_fine).  One pass of the twins on the CPU on
        the whole batch gives both its gradients and the render that the
        criterion reads (criterion(res, rgbs, mcfg, rcfg, bound,
        normal_err)).  timed_steps: the training run's, for the printed
        step.  n_rays: the batch, the first n_rays of the CHECK_RAYS
        (where the twins' step on the CPU would not fit more).  unfused: a
        render config with the kernels off; where given, the kernels' step
        is also held to the unfused step on the card (autograd's double
        backward through plain torch) on the well-conditioned rays, at the
        bound of the comparison with the twins on the CPU.  cpu_held False:
        the comparisons with the twins on the CPU are printed and not
        held; instead every kernel is held to every twin on the card (the
        gradients at the CPU comparison's bound, the loss at its 1e-3), and
        the twins on the CPU run on the whole batch alone."""
        mcfg_ = mcfg if mcfg_ is None else mcfg_
        rcfg_ = rcfg if rcfg_ is None else rcfg_
        bounds_ = bounds if bounds_ is None else bounds_
        for pt, net_ in enumerate(nets):
            net_cpu = copy.deepcopy(net_).cpu()
            step = WARM_STEPS + timed_steps - len(nets) + 1 + pt
            last = pt == len(nets) - 1
            fine_z = fine_samples(net_, mcfg_, rcfg_)
            whole, res_cpu = np.arange(n_rays), []
            cpu_whole = grads_on(net_cpu, "cpu", whole, mcfg_, rcfg_=rcfg_,
                                 fine_z=fine_z, results=res_cpu)
            bad = criterion(res_cpu[0], torch.as_tensor(s["rgbs"][whole]),
                            mcfg_, rcfg_, max(bounds_.values()), normal_err)
            kept = np.flatnonzero(~bad.numpy())
            print(f"  weights after step {step}: {int(bad.sum())} of "
                  f"{n_rays} rays ill-conditioned "
                  f"{np.flatnonzero(bad.numpy()).tolist()}", flush=True)
            if not len(kept) >= n_rays // 2:
                step_failures.append(
                    f"{path}, weights after step {step}: {len(kept)} "
                    f"well-conditioned rays < {n_rays // 2}")
            for rays, held in ((whole, whole_batch),
                               (kept, tuple(bounds_))):
                reset_counts()
                bias_terms = []
                loss_k, g_k = grads_on(net_, "cuda", rays, mcfg_,
                                       bias_terms, rcfg_, fine_z)
                assert counts() == want, counts()
                # the sigma head's bias gradient is one sum of terms of
                # either sign, held as the kernel checks hold it (dbsig_held)
                # to its bound of its terms' L2 norm in the step's backward
                # call, where its relative error against the sum is
                # unbounded as the terms cancel (printed beside); with a
                # fine network, each network's on its own call's terms
                bias_scales = sigma_bias_scales(bias_terms)
                assert set(bias_scales) == {k for k in g_k
                                            if k.endswith(SIGMA_BIAS)}
                k1_twin = (k1, "_trunk_sigma_cuda", k1._trunk_sigma_plain)
                saved = [(m, name, getattr(m, name))
                         for m, name, _ in (fwd, bwd, k1_twin)]
                setattr(*bwd)
                loss_b, g_b = grads_on(net_, "cuda", rays, mcfg_,
                                       rcfg_=rcfg_, fine_z=fine_z)
                setattr(*fwd)
                loss_fb, g_fb = grads_on(net_, "cuda", rays, mcfg_,
                                         rcfg_=rcfg_, fine_z=fine_z)
                setattr(*k1_twin)
                loss_t, g_t = grads_on(net_, "cuda", rays, mcfg_,
                                       rcfg_=rcfg_, fine_z=fine_z)
                for m, name, fn in saved:
                    setattr(m, name, fn)
                # the twins on the CPU: the whole batch's pass above, and
                # on the kept rays where they are held
                loss_p, g_p = (cpu_whole if rays is whole else grads_on(
                    net_cpu, "cpu", rays, mcfg_, rcfg_=rcfg_,
                    fine_z=fine_z) if cpu_held else (None, None))
                comparisons = [c for c in zip(bounds_, (g_k, g_k, g_k, g_t),
                                              (g_b, g_fb, g_p, g_p))
                               if c[2] is not None]
                held_here = held
                if not cpu_held:
                    label_c = "all kernels vs twins on the card"
                    comparisons.append((label_c, g_k, g_t))
                    held_here = tuple(k for k in held if "CPU" not in k)
                    if rays is not whole:
                        held_here += (label_c,)
                    bounds_ = dict(bounds_, **{
                        label_c: bounds_["all kernels vs twins on the CPU"]})
                if unfused is not None and rays is not whole:
                    reset_counts()
                    loss_u, g_u = grads_on(net_, "cuda", rays, mcfg_,
                                           rcfg_=unfused, fine_z=fine_z)
                    assert not any(counts().values()), counts()
                    label_u = "kernels vs the unfused step on the card"
                    comparisons.append((label_u, g_k, g_u))
                    held_here += (label_u,)
                    bounds_ = dict(bounds_, **{
                        label_u: bounds_["all kernels vs twins on the CPU"]})
                    print(f"    the unfused step on the card: loss "
                          f"{loss_u:.6f}", flush=True)
                print(f"   {len(rays)} rays: loss: kernels {loss_k:.6f}; "
                      f"backward's twin on the card {loss_b:.6f}; both "
                      f"twins on the card {loss_fb:.6f}; every twin on the "
                      f"card {loss_t:.6f}; twins on the CPU "
                      + ("not run" if loss_p is None else f"{loss_p:.6f}"),
                      flush=True)
                if last and len(held) > 1:
                    print("    gradient norms: " + ", ".join(
                        f"{k} {v.norm().item():.3e}"
                        for k, v in g_k.items()), flush=True)
                for label, got, ref in comparisons:
                    rels = {k: rel_l2(got[k], ref[k]) for k in ref}
                    bias_rel = {k: rels[k] for k in bias_scales}
                    for k, scale_ in bias_scales.items():
                        rels[k] = (got[k] - ref[k]).norm().item() / scale_
                    top = sorted(rels.items(), key=lambda kv: -kv[1])
                    worst_k, worst = top[0]
                    print(f"    gradient relative L2, {label}: largest "
                          f"{worst:.2e} (bound {bounds_[label]:g}"
                          f"{'' if label in held_here else ', not held'}); "
                          + ", ".join(f"{k} {v:.2e}" for k, v in (
                              rels.items() if last and len(held) > 1
                              else top[:2]))
                          + "".join(
                              f"; {k} of its terms' norm {rels[k]:.2e} "
                              f"(relative to the sum {bias_rel[k]:.2e})"
                              for k in bias_scales), flush=True)
                    if label in held_here and not worst <= bounds_[label]:
                        step_failures.append(
                            f"{path}, weights after step {step}, "
                            f"{len(rays)} rays: {label} {worst:.3e} > "
                            f"{bounds_[label]:g} ({worst_k})")
                assert all(torch.isfinite(v).all() for v in g_k.values())
                # the backward kernel moves no forward value
                assert abs(loss_b - loss_k) <= 1e-6 * abs(loss_k), (loss_b,
                                                                    loss_k)
                loss_r = loss_p if cpu_held else loss_t
                assert abs(loss_k - loss_r) <= 1e-3 * abs(loss_r), (loss_k,
                                                                    loss_r)

    per_req = chunks // N_REQUESTS
    widths_phase(rows, argv, tmp.name, gen, peaks, serve, train,
                 check_served, step_check, per_req)
    layers_phase(rows, argv, tmp.name, gen, peaks, serve, train,
                 check_served, step_check, per_req, bounds, requests[0])

    phase("training")
    # per step: the probe and the sun march (K1), the main pass with zs/us
    # (K2) and its backward (K3: one call, a sweep, a weight-gradient
    # and a reduce kernel)
    trained, launches = train("train step", {"K1": 2, "K2": 1, "K3": 1,
                                             "K4": 0, "K5": 0})
    rows["K2zs"]["launches"] = launches["K2"]
    rows["K3"]["launches"] = launches["K3"]
    rows["K1"]["launches_train"] = launches["K1"]

    phase("step check")
    # K3 in the step, on the cotangents the step gives it: as K3 alone
    # above, 1e-2.  K2's outputs differ from its twin's by 4e-4 (sigma) ..
    # 4e-3 (gx) in relative L2, the bf16 contract's cascade of rounding
    # flips (any two summation orders give as much), and the loss passes
    # them through -normalize(gx), the compositing weights and RPV, so the
    # whole step is held at 0.1
    step_check("switch off", trained,
               (k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
               (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain),
               {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K5": 0})

    phase("training, fused heads")
    os.environ[FUSED_HEADS] = "1"
    # per step: K1 twice, K4 saving zs for the main pass and K5 for its
    # backward (one call: the b_th chain, a sweep, a weight-gradient and a
    # reduce kernel)
    trained, launches = train("train step, fused heads",
                              {"K1": 2, "K2": 0, "K3": 0, "K4": 1, "K5": 1})
    rows["K4zs"]["launches"] = launches["K4"]
    rows["K5"]["launches"] = launches["K5"]

    phase("step check, fused heads")
    # this run's own weights after its last timed steps; K5 in the step at
    # K3's bound, K4's trunk and chain are K2's
    step_check("fused heads", trained,
               (k4, "_trunk_heads_fwd_cuda", k4._trunk_heads_fwd_plain),
               (k4, "_trunk_heads_bwd_cuda", k4._trunk_heads_bwd_plain),
               {"K1": 2, "K2": 0, "K3": 0, "K4": 1, "K5": 1})
    del os.environ[FUSED_HEADS], trained

    # the stage-2 step at float32, the train CLI's default: K1, K2 saving
    # f32 zs/us and K3 in their float32 instantiations; beside it the same
    # step with the fused kernels off, the unfused f32 autograd path (what
    # a float32 run took before they were ported)
    phase("training, float32")
    c32 = dc.replace(mcfg, compute_dtype="float32")
    trained, launches = train("train step, float32",
                              {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K5": 0},
                              mcfg_=c32)
    rows["K2zsf32"]["launches"] = launches["K2"]
    rows["K3f32"]["launches"] = launches["K3"]
    rows["K1f32"]["launches_train"] = launches["K1"]
    phase("training, float32, unfused")
    train("train step, float32, unfused",
          {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}, mcfg_=c32,
          rcfg_=dc.replace(rcfg, use_pallas=False, fused_trunk=False),
          timed_steps=UNFUSED_STEPS)
    print(f"  float32 step, mean rays/s: kernels "
          f"{bare_rays_s['train step, float32']:.1f}, unfused "
          f"{bare_rays_s['train step, float32, unfused']:.1f} ({smi})",
          flush=True)

    phase("step check, float32")
    # the float32 contract: the kernels' products are within ~2^-17 of
    # exact f32 products (tools/f32_check.py: every output 5e-6 .. 3e-5 in
    # relative L2 from its twin, ~500 times closer than the bfloat16_all
    # kernels), so every bound is ten times tighter than the bf16 one, and
    # the rays set aside are those whose gradient an error of
    # NORMAL_ERR_F32 in a sample's normal leaves undetermined
    bounds32 = {k: v / 10 for k, v in bounds.items()}
    step_check("float32", trained,
               (k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
               (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain),
               {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K5": 0}, mcfg_=c32,
               bounds_=bounds32, normal_err=NORMAL_ERR_F32)
    del trained

    # the mixed bfloat16 contract (bf16 operands, f32 activations, zs/us
    # saved in f32), with the switch off and on: K2 -> K3, K4 -> K5
    phase("training, bfloat16")
    cmix = dc.replace(mcfg, compute_dtype="bfloat16")
    _, launches = train("train step, bfloat16",
                        {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K5": 0},
                        mcfg_=cmix, timed_steps=MIX_STEPS)
    rows["K2zsmix"]["launches"] = launches["K2"]
    rows["K3mix"]["launches"] = launches["K3"]
    os.environ[FUSED_HEADS] = "1"
    _, launches = train("train step, bfloat16, fused heads",
                        {"K1": 2, "K2": 0, "K3": 0, "K4": 1, "K5": 1},
                        mcfg_=cmix, timed_steps=MIX_STEPS)
    del os.environ[FUSED_HEADS]
    rows["K4zsmix"]["launches"] = launches["K4"]
    rows["K5mix"]["launches"] = launches["K5"]

    # float32 with the switch on: K1 and K4 in their float32
    # instantiations serve, K4 saving f32 zs and K5 train; one request,
    # the stage-2 step and one step-check point at the float32 bounds
    phase("serving, float32, fused heads")
    per_req = chunks // N_REQUESTS
    os.environ[FUSED_HEADS] = "1"
    renderer32 = load_renderer(run_dir, 1, compute_dtype="float32",
                               device="cuda")
    outs, launches = serve("request, float32, fused heads",
                           {"K1": 2 * per_req, "K2": 0, "K3": 0,
                            "K4": per_req, "K5": 0}, renderer32, n_req=1)
    rows["K4f32"]["launches"] = launches["K4"]
    check_served(outs, renderer32, scale=0.1)
    del renderer32, outs
    phase("training, float32, fused heads")
    trained, launches = train("train step, float32, fused heads",
                              {"K1": 2, "K2": 0, "K3": 0, "K4": 1, "K5": 1},
                              mcfg_=c32, timed_steps=ACT_STEPS)
    rows["K4zsf32"]["launches"] = launches["K4"]
    rows["K5f32"]["launches"] = launches["K5"]
    phase("step check, float32, fused heads")
    step_check("float32, fused heads", trained[-1:],
               (k4, "_trunk_heads_fwd_cuda", k4._trunk_heads_fwd_plain),
               (k4, "_trunk_heads_bwd_cuda", k4._trunk_heads_bwd_plain),
               {"K1": 2, "K2": 0, "K3": 0, "K4": 1, "K5": 1}, mcfg_=c32,
               bounds_=bounds32, normal_err=NORMAL_ERR_F32)
    del os.environ[FUSED_HEADS], trained

    # the exact sine (--fast_sin 0) and ReLU (--siren 0): every kernel
    # built for the activation on a main path.  bfloat16_all: one request
    # with the switch off (K1, K2) and on (K4), the stage-2 step over
    # ACT_STEPS timed steps off (K2 saving zs/us, K3) and on (K4 saving zs,
    # K5) with a falling loss; float32: one request off (K2) and on (K4),
    # ACT_SHORT steps off and on; bfloat16: ACT_SHORT steps off and on
    names = ACT_NAMES
    for act, flag in (("sin", ["--fast_sin", "0"]),
                      ("relu", ["--siren", "0"])):
        phase(f"serving and training, {names[act]}")
        a_args = opts.postprocess(opts.train_parser().parse_args(
            argv + ["--exp_name", f"smoke_{act}"] + flag))
        a_dir = os.path.join(tmp.name, f"run_{act}")
        opts.dump_opts(a_args, a_dir)
        a_cfg = opts.to_run_config(a_args, device="cuda")
        assert k1.act_of(a_cfg.model) == act and a_cfg.render.fused_trunk
        save_checkpoint(os.path.join(tmp.name, "ckpts", f"smoke_{act}",
                                     "epoch=1.npz"),
                        {"coarse": init_network(a_cfg.model, gen,
                                                device="cuda")}, step=0)

        def count(dtype, kern, n):
            key = ACT_ROWS[dtype][kern] + f" {act}"
            rows[key]["launches"] = rows[key].get("launches", 0) + n

        for dtype in ("bfloat16_all", "float32"):
            r_ = load_renderer(a_dir, 1, compute_dtype=dtype, device="cuda")
            assert k1.act_of(r_.cfg.model) == act
            for heads in (False, True):
                if heads:
                    os.environ[FUSED_HEADS] = "1"
                _, launches = serve(
                    f"request, {names[act]}, {dtype}"
                    + (", fused heads" if heads else ""),
                    {"K1": 2 * per_req, "K2": 0 if heads else per_req,
                     "K3": 0, "K4": per_req if heads else 0, "K5": 0}, r_,
                    n_req=1, profiled=False)
                os.environ.pop(FUSED_HEADS, None)
                count(dtype, "K4" if heads else "K2",
                      launches["K4" if heads else "K2"])
                if not heads:
                    count(dtype, "K1", launches["K1"])
            del r_
        for dtype, steps in (("bfloat16_all", ACT_STEPS),
                             ("float32", ACT_SHORT),
                             ("bfloat16", ACT_SHORT)):
            a_m = dc.replace(a_cfg.model, compute_dtype=dtype)
            for heads in (False, True):
                if heads:
                    os.environ[FUSED_HEADS] = "1"
                _, launches = train(
                    f"train step, {names[act]}, {dtype}"
                    + (", fused heads" if heads else ""),
                    {"K1": 2, "K2": 0 if heads else 1,
                     "K3": 0 if heads else 1, "K4": int(heads),
                     "K5": int(heads)}, mcfg_=a_m, timed_steps=steps,
                    profiled=False)
                os.environ.pop(FUSED_HEADS, None)
                pair = ("K4zs", "K5") if heads else ("K2zs", "K3")
                for kern, k in zip(pair, ("K4", "K5") if heads
                                   else ("K2", "K3")):
                    count(dtype, kern, launches[k])

    # the Hapke and Microfacet families on the kernel path: the flagship's
    # configuration with the family's heads in place of RPV(111), at
    # bfloat16_all and at float32.  The heads and the per-ray BRDF change;
    # the trunk runs K1 (probe, sun march), K2 and K3 as the flagship's
    # does, and K4/K5 take the RPV(111) heads alone, so they launch 0 with
    # the switch set.  Per family and dtype: one request against the CPU
    # twins, WARM_STEPS + FAMILY_STEPS timed steps (a falling loss), one
    # step with the switch set, one step-check point with the family's
    # set-aside criterion (brdf_ill_conditioned); Hapke also 4 stage-1
    # steps with --shell_hapke 3 (no sun march in stage 1: K1 once)
    rpv_at = argv.index("--funcM")
    assert argv[rpv_at:rpv_at + 10] == ["--funcM", "1", "--funcF", "1",
                                        "--funcH", "1", "--dim_RPV", "1",
                                        "--brdf_on", "0.5"]
    families = {
        "hapke": (["--b", "--c", "--theta", "--brdf_on", "0"],
                  ("albedo_coarse", "normal_an_coarse", "hpk_b_coarse",
                   "hpk_c_coarse", "irradiance_coarse"),
                  ("sun_coarse", "hpk_theta_coarse")),
        "microfacet": (["--roughness", "--brdf_on", "0.5"],
                       ("albedo_coarse", "normal_an_coarse",
                        "irradiance_coarse"),
                       ("sun_coarse", "roughness_coarse"))}
    stage2 = {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K5": 0}
    for family, (flags, keys3, keys1) in families.items():
        phase(f"family, {family}")
        f_args = opts.postprocess(opts.train_parser().parse_args(
            argv[:rpv_at] + flags + argv[rpv_at + 10:]
            + ["--exp_name", f"smoke_{family}"]))
        f_dir = os.path.join(tmp.name, f"run_{family}")
        opts.dump_opts(f_args, f_dir)
        f_cfg = opts.to_run_config(f_args, device="cuda")
        f_rcfg = f_cfg.render
        assert f_rcfg.use_pallas and f_rcfg.fused_trunk and f_rcfg.apply_brdf
        assert not f_cfg.model.rpv
        assert f_rcfg.apply_theta == (family == "hapke")
        save_checkpoint(os.path.join(tmp.name, "ckpts", f"smoke_{family}",
                                     "epoch=1.npz"),
                        {"coarse": init_network(f_cfg.model, gen,
                                                device="cuda")}, step=0)
        for dtype in ("bfloat16_all", "float32"):
            f32 = dtype == "float32"
            r_ = load_renderer(f_dir, 1, compute_dtype=dtype, device="cuda")
            outs, launches = serve(
                f"request, {family}, {dtype}",
                {"K1": 2 * per_req, "K2": per_req, "K3": 0, "K4": 0,
                 "K5": 0}, r_, n_req=1)
            check_served(outs, r_, scale=0.1 if f32 else 1.0, keys3=keys3,
                         keys1=keys1)
            del r_, outs
            f_m = dc.replace(f_cfg.model, compute_dtype=dtype)
            trained, launches = train(
                f"train step, {family}, {dtype}", stage2, mcfg_=f_m,
                rcfg_=f_rcfg, timed_steps=FAMILY_STEPS)
            for k, key in zip(("K1", "K2", "K3"),
                              ("K1f32", "K2zsf32", "K3f32") if f32
                              else ("K1", "K2zs", "K3")):
                rows[key]["launches_families"] = (
                    rows[key].get("launches_families", 0) + launches[k])
            os.environ[FUSED_HEADS] = "1"
            train(f"train step, {family}, {dtype}, fused heads set",
                  stage2, mcfg_=f_m, rcfg_=f_rcfg, timed_steps=1,
                  profiled=False)
            del os.environ[FUSED_HEADS]
            step_check(f"{family}, {dtype}", trained[-1:],
                       (k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
                       (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain),
                       stage2, mcfg_=f_m, rcfg_=f_rcfg,
                       bounds_=bounds32 if f32 else bounds,
                       normal_err=NORMAL_ERR_F32 if f32 else NORMAL_ERR,
                       criterion=brdf_ill_conditioned)
            del trained
            if family == "hapke":
                train(f"stage-1 step, hapke shell 3, {dtype}",
                      {"K1": 1, "K2": 1, "K3": 1, "K4": 0, "K5": 0},
                      mcfg_=dc.replace(f_m, shell_hapke=3),
                      rcfg_=dc.replace(f_rcfg, apply_brdf=False,
                                       apply_theta=False),
                      timed_steps=4, profiled=False)
        print(f"  {family}: mean train rays/s bfloat16_all "
              f"{bare_rays_s[f'train step, {family}, bfloat16_all']:.1f} "
              f"(RPV {bare_rays_s['train step']:.1f}), float32 "
              f"{bare_rays_s[f'train step, {family}, float32']:.1f} (RPV "
              f"{bare_rays_s['train step, float32']:.1f}) ({smi})",
              flush=True)

    # the nerf, s-nerf, sat-nerf and sps-nerf variants (beta off) at 8 x 512
    # and float32 (the CLI's default), and spsbrdf-nerf with the learned
    # sun: the JAX package runs the variants' trunk in XLA with no Pallas
    # kernel, so the port's is plain torch and K1-K5 launch 0; spsbrdf with
    # the learned sun runs K1 for the probe alone (its sun visibility is
    # the head, no march), K2 and K3, and its solar-correction pass in
    # plain torch.  Each: one request against the CPU twins (256 rays, at
    # the float32 bounds) and WARM_STEPS + VARIANT_STEPS steps on a
    # one-batch store (the loss falls)
    phase("variants")
    learned = ["--sc_lambda", "0.05", "--sun_v", "learned"]
    sun_at = argv.index("--sun_v")
    variants = {
        "nerf": (["--model", "nerf", "--siren", "0"], (), ()),
        "s-nerf": (["--model", "s-nerf"] + learned,
                   ("albedo_coarse", "sky_coarse"), ("sun_coarse",)),
        "sat-nerf": (["--model", "sat-nerf"] + learned,
                     ("albedo_coarse", "sky_coarse"), ("sun_coarse",)),
        "sps-nerf": (["--model", "sps-nerf", "--ds_lambda", "10"] + learned,
                     ("albedo_coarse", "sky_coarse"), ("sun_coarse",)),
    }
    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    v_base = argv[:argv.index("--model")] + [
        "--fc_layers", "8", "--fc_feat", "512", "--mapping", "--n_samples",
        str(N_SAMPLES), "--guided_samples", str(N_SAMPLES), "--chunk",
        str(CHUNK), "--lr", "5e-4", "--batch_size", str(BATCH)]
    for name, (flags, keys3, keys1) in list(variants.items()) + [
            ("spsbrdf, learned sun", (
                argv[:sun_at] + argv[sun_at + 2:] + learned, FLAGSHIP_KEYS3,
                ("sun_coarse",)))]:
        exp = "smoke_" + name.replace(" ", "").replace(",", "_")
        v_args = opts.postprocess(opts.train_parser().parse_args(
            (flags if name.startswith("spsbrdf") else v_base + flags)
            + ["--exp_name", exp]))
        v_dir = os.path.join(tmp.name, f"run_{exp}")
        opts.dump_opts(v_args, v_dir)
        v_cfg = opts.to_run_config(v_args, device="cuda")
        sps = name.startswith("spsbrdf")
        assert v_cfg.model.variant == ("spsbrdf-nerf" if sps else name)
        assert not v_cfg.model.beta and v_cfg.train.sc_lambda == (
            0.0 if name == "nerf" else 0.05)
        save_checkpoint(os.path.join(tmp.name, "ckpts", exp, "epoch=1.npz"),
                        {"coarse": init_network(v_cfg.model, gen,
                                                device="cuda")}, step=0)
        r_ = load_renderer(v_dir, 1, device="cuda")
        outs, _ = serve(f"request, {name}",
                        dict(zero, K1=per_req, K2=per_req) if sps else zero,
                        r_, n_req=1, profiled=False)
        check_served(outs, r_, scale=0.1, keys3=keys3, keys1=keys1,
                     n_check=256,
                     compared=("rgb_coarse", "depth_coarse")
                     + (("normal_an_coarse",) if sps else ()))
        del r_, outs
        trained, _ = train(
            f"train step, {name}", dict(zero, K1=1, K2=1, K3=1) if sps
            else zero, mcfg_=v_cfg.model, rcfg_=v_cfg.render,
            tcfg_=v_cfg.train, timed_steps=VARIANT_STEPS, profiled=False,
            store_batches=1)
        del trained

    # the variants at their own defaults (ROADMAP.md Queue 1 item 9b), at
    # 8 x 512 and float32 unless noted: spsbrdf-nerf with a fine network
    # (--n_importance 64: K2/K3 on each network, K4/K5 twice with the
    # switch; one step-check point at bfloat16_all), with beta (the
    # t-embedding: K4/K5 refuse it with the switch set), with multi_brdf,
    # with normal_at_surface (no K2/K3), with density noise; sat-nerf with
    # beta and the keypoint store (no kernel; a kp_ term), sps-nerf with
    # beta.  Each: one request against the CPU twins (256 rays, the
    # float32 bounds) and WARM_STEPS + VARIANT_STEPS steps on a one-batch
    # store (the loss falls), launches held per chunk and per step
    phase("variants, defaults")
    t_defaults = time.perf_counter()
    defaults_phase(tmp.name, argv, v_base, learned, gen, requests, serve,
                   train, check_served, step_check, draws, bounds, per_req,
                   rows, smi)
    print(f"  the defaults phase took {time.perf_counter() - t_defaults:.1f}"
          " s", flush=True)

    phase("workflow")
    run_dir, epoch, run_f32 = workflow(os.path.join(tmp.name, "workflow"),
                                       reset_counts, counts,
                                       bare_rays_s["train step"])

    phase("eval")
    wf_scores = eval_phase(os.path.join(tmp.name, "eval"), run_dir, epoch,
                           reset_counts, counts, smi, rows, run_f32)

    # int8 serving (Queue 1 item 10) on the flagship run's weights and on
    # the workflow's stage-2 run
    phase("serving, int8")
    t_int8 = time.perf_counter()
    int8_phase(os.path.join(tmp.name, "int8"), refs["run_dir"], run_dir,
               epoch, wf_scores, requests, refs, check_served, reset_counts,
               counts, smi, rows, per_req)
    print(f"  the int8 phase took {time.perf_counter() - t_int8:.1f} s",
          flush=True)
    # data parallelism (Queue 1 item 11 without tensor parallelism)
    phase("data parallel")
    t_dp = time.perf_counter()
    dp_phase(os.path.join(tmp.name, "dp"), run_dir, requests, refs, smi,
             rows, reset_counts, counts, per_req)
    print(f"  the data-parallel phase took {time.perf_counter() - t_dp:.1f}"
          " s", flush=True)
    del refs
    # tensor parallelism (Queue 1 item 11b): the 12 x 2048 trunk on two
    # ranks sharing the card
    phase("tensor parallel")
    t_tp = time.perf_counter()
    tp_phase(os.path.join(tmp.name, "tp"), smi, rows, reset_counts, counts)
    print(f"  the tensor-parallel phase took "
          f"{time.perf_counter() - t_tp:.1f} s", flush=True)

    # each family's two-stage workflow on its shaded AOI through the train
    # CLI, and the eval CLI on its stage 2
    for family in ("hapke", "microfacet"):
        phase(f"workflow, {family}")
        workflow(os.path.join(tmp.name, f"workflow_{family}"), reset_counts,
                 counts, bare_rays_s["train step"], family=family, smi=smi)
    # the two-stage workflow at width 64 (the repo's small runs' width)
    # through the train and eval CLIs, on K1-K3 built for it
    phase("workflow, width 64")
    t_w64 = time.perf_counter()
    workflow(os.path.join(tmp.name, "workflow_f64"), reset_counts, counts,
             bare_rays_s["train step"], smi=smi, width=64)
    print(f"  the width-64 workflow took {time.perf_counter() - t_w64:.1f} s",
          flush=True)
    # the blender dataset with vanilla NeRF, the panels, generate_dataset
    # and --img_downscale 2: host code, no kernel
    phase("blender, host data")
    t_bl = time.perf_counter()
    blender_phase(os.path.join(tmp.name, "blender"), reset_counts, counts,
                  smi)
    print(f"  the blender and host data phase took "
          f"{time.perf_counter() - t_bl:.1f} s", flush=True)

    phase("end")
    tmp.cleanup()
    if step_failures:
        print("step check: " + str(len(step_failures)) + " comparisons "
              "missed their bounds:\n  " + "\n  ".join(step_failures),
              file=sys.stderr, flush=True)
        return 1
    # every row's "launches" counts its own path's run (K1's and K2's:
    # serving; K2 saving zs/us and K3: training; K4's: serving with the
    # fused heads; K4 saving zs/us and K5: training with them); K1 runs on
    # every path; "launches_eval": the eval CLI's run (K4's with the fused
    # heads)
    # every instantiation in the line was launched on a main path
    idle = [r["name"] for r in rows.values() if not r.get("launches")]
    assert not idle, f"never launched on a main path: {idle}"
    keys = ("name", "route", "source", "replaces", "act", "width", "dtype",
            "points", "launches", "launches_int8", "launches_int8_eval",
            "launches_dp", "launches_split", "launches_tp", "max_abs_err",
            "ms", "plain_ms",
            "bound_ms", "bound_by",
            "library_ms", "launches_train", "launches_eval",
            "launches_families", "launches_defaults",
            "bound_split_ms", "rel_l2", "bf16_over_f32",
            "library_bf16_ms", "uchain_ms", "sweep_ms", "wgrad_ms",
            "reduce_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
