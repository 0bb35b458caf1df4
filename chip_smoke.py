"""Smoke run of the port on one NVIDIA GPU: build the CUDA kernels from the
checkout's sources, hold each against its plain PyTorch twin at the main
paths' shapes, then serve and train the flagship spsbrdf-nerf model through
the port's own entry points and check what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device   - require CUDA; print the card's name and power limit
  2. build    - nvcc for sm_90a, one process per kernel source, in parallel
  3. kernels  - K1 (trunk + sigma) at 327,680 points and K2 (trunk + sigma
                gradient) at 655,360 points, the serving shapes; K2 saving
                zs/us and K3 (the trunk's second-order backward) at 131,072
                points, the training step's; bfloat16_all with the
                polynomial sine, each against its twin; times of kernel,
                twin and a chain of torch.matmul calls for the same products
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
                kernels on the card against the same step through the twins
                on the CPU
Then one JSON line of every ported kernel, the card's line, and the last
line {"ok": true, "device": {...}}.
"""

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
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}
N_SAMPLES = 64          # stratified and guided samples per ray
CHUNK = 5120            # rays per render chunk (opts --chunk default)
REQ_SIDE = 128          # a request is a 128 x 128 image
N_REQUESTS = 3
BATCH = 1024            # rays per train step (the flagship's batch)
STORE_BATCHES = 16      # the ray store holds 16 batches
WARM_STEPS = 3          # from step 3 on every gate of bench.py holds
TIMED_STEPS = 32        # two passes over the store
CHECK_RAYS = 128        # rays of the whole-step kernels-vs-twins check


def phase(name):
    print(f"== {name}", flush=True)


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


def rel_l2(got, ref):
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def trunk_macs(cfg, ein):
    """Multiply-adds per point of the trunk + sigma head, at the real
    (unpadded) encoding width."""
    f, layers = cfg.feat, cfg.layers
    return ein * f + (layers - 2) * f * f + (ein + f) * f + f


def bound_ms(flops, nbytes, peaks):
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


GROUPS = (("K1 trunk_sigma", ("trunk_sigma_kernel",)),
          ("K2 trunk_fwd_grad", ("trunk_fwd_grad_kernel",)),
          ("K3 trunk_bwd sweep", ("trunk_bwd_sweep_kernel",)),
          ("K3 trunk_bwd wgrad", ("trunk_bwd_wgrad_kernel",)),
          ("optimizer (Adam)", ("adam",)),
          ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_")),
          ("elementwise", ("elementwise",)))


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
        low = name.lower()
        for g, keys in GROUPS:
            if any(k in low for k in keys):
                groups[g] += ms
                break
        else:
            groups["other"] += ms
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
    peaks = PEAKS["pcie" if "pcie" in kind.lower() else "sxm"]
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
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    from brdfnerf_tpu_torch.parallel import train_step as ts
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.utils.checkpoint import save_checkpoint

    phase("build")
    t0 = time.perf_counter()
    cuda_build.build(["trunk_sigma", "trunk_fwd_grad", "trunk_bwd"])
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in cuda_build.build_log.items():
        # per kernel function: its (mangled) name, spills, registers
        regs = [ln.strip().replace("ptxas info    : ", "")[:60]
                for ln in rec["log"].splitlines()
                if "Function properties for" in ln or "registers" in ln
                or "spill" in ln]
        print(f"  {name}: {rec['seconds']:.1f} s; " + " | ".join(regs[:9]),
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
    macs = trunk_macs(mcfg, ein)
    feat = mcfg.feat
    rows = {}
    mids = list(packed["w_mid"])
    wsig = packed["w_sigma"].to(torch.bfloat16)[:, None]

    def chain_fwd(encb):
        """The trunk's products as torch.matmul calls (bf16), nothing else."""
        h = encb @ packed["w0"].t()
        m = 0
        for i in range(1, mcfg.layers):
            if i == mcfg.skips[0]:
                h = torch.cat([encb, h], 1) @ packed["w_skip"].t()
            else:
                h = h @ mids[m].t()
                m += 1
        return h, h @ wsig

    def chain_k2(encb):
        """chain_fwd, then the reverse chain's products."""
        g, _ = chain_fwd(encb)
        m = len(mids) - 1
        gx = None
        for i in range(mcfg.layers - 1, 0, -1):
            if i == mcfg.skips[0]:
                gx = g @ packed["w_skip"][:, :k1.LANE]
                g = g @ packed["w_skip"][:, k1.LANE:]
            else:
                g = g @ mids[m]
                m -= 1
        return gx + g @ packed["w0"]

    def points(n):
        xyz = torch.rand(n, 3, device="cuda", generator=gen) * 2 - 1
        return positional_encoding(xyz, mcfg.mapping_sizes[0], fast=True,
                                   pad_to=k1.LANE)

    # K1: two sigma-only passes per chunk, CHUNK * N_SAMPLES points each
    n1 = CHUNK * N_SAMPLES
    enc = points(n1)
    s_k, _ = k1._trunk_sigma_cuda(packed, mcfg, enc, False)
    s_p, _ = k1._trunk_sigma_plain(packed, mcfg, enc, False)
    torch.cuda.synchronize()
    e = diff("K1 sigma", s_k, s_p)
    # the kernel rounds activations to bf16 before each product, the twin
    # (the Pallas kernel's arithmetic) keeps them f32: at this width that
    # moves sigma by ~1e-3 on average, ~5e-3 at most on 4,096 points
    assert torch.isfinite(s_k).all()
    assert e["max"] <= 2e-2 * e["scale"] and e["mean"] <= 2e-3 * e["scale"]
    encb = enc.to(torch.bfloat16)
    rows["K1"] = {
        "name": "trunk_sigma", "route": "cuda",
        "source": "brdfnerf_tpu_torch/csrc/trunk_sigma.cu",
        "replaces": "brdfnerf_tpu/ops/pallas_mlp.py:114",
        "max_abs_err": e["max"],
        "ms": timed(lambda: k1._trunk_sigma_cuda(packed, mcfg, enc, False),
                    10),
        "plain_ms": timed(lambda: k1._trunk_sigma_plain(packed, mcfg, enc,
                                                        False), 2),
        "library_ms": timed(lambda: chain_fwd(encb), 10)}
    rows["K1"]["bound_ms"], rows["K1"]["bound_by"] = bound_ms(
        2.0 * macs * n1, n1 * (k1.LANE * 4 + 4) + wbytes, peaks)
    del enc, encb, s_k, s_p

    # K2: the main pass, CHUNK * 2 * N_SAMPLES points
    n2 = CHUNK * 2 * N_SAMPLES
    enc = points(n2)
    out_k = k2._trunk_fwd_grad_cuda(packed, mcfg, enc)
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
    k2_flops = 2.0 * (2 * macs - feat) * n2
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
        k2_flops, n2 * (k1.LANE * 4 + 4 + feat * 2 + k1.LANE * 4) + wbytes,
        peaks)
    del enc, encb

    # K2 saving zs/us, and K3, at the train step's main pass: BATCH *
    # 2 * N_SAMPLES points
    n3 = BATCH * 2 * N_SAMPLES
    enc = points(n3)
    out_k = k2._trunk_fwd_grad_cuda(packed, mcfg, enc, want_zs=True)
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
        k3_err, k3_rel = max(k3_err, e["max"]), max(k3_rel, e["rel"])
        assert torch.isfinite(g_).all(), name
        # deterministic: a fixed summation order, no atomics
        assert torch.equal(g_, a_), f"K3 {name} differs between launches"
        # a grad is a sum over all points; the kernel and the twin round
        # the same operands to bf16, but their f32 sums run in other
        # orders, which flips some of the downstream bf16 roundings, as in
        # K2 (measured on the card: relative L2 1.6e-3 .. 3.6e-3 per
        # tensor, 3.5e-4 for the sigma head's bias)
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
    k2_flops3 = 2.0 * (2 * macs - feat) * n3
    rows["K2zs"]["bound_ms"], rows["K2zs"]["bound_by"] = bound_ms(
        k2_flops3, n3 * (k1.LANE * 4 + 4 + feat * 2 + k1.LANE * 4
                         + 2 * mcfg.layers * feat * 2) + wbytes, peaks)
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
        chain_fwd(cgb)                              # the tangent chain
        a = azb[:n3]
        m = len(mids) - 1
        for i in range(mcfg.layers - 1, 0, -1):     # the a chain
            if i == mcfg.skips[0]:
                a = a @ packed["w_skip"][:, k1.LANE:]
            else:
                a = a @ mids[m]
                m -= 1
        for i in range(mcfg.layers):                # the weight grads
            if i in (0, mcfg.skips[0]):
                xtb.t() @ azb
            if i > 0:
                hth.t() @ azb

    # work per point: the tangent forward (macs), the a chain (7 F^2), the
    # outer products of every layer's dW over (primal, tangent) (2 macs)
    k3_flops = 2.0 * (3 * macs + (mcfg.layers - 1) * feat * feat) * n3
    # reads zs, us, cf, x, cg, cs and the weights; writes the f32 grads
    grad_elems = (2 * k1.LANE * feat + (mcfg.layers - 1) * feat * feat
                  + mcfg.layers * feat + feat + 1)
    k3_bytes = (n3 * (2 * mcfg.layers * feat * 2 + feat * 2
                      + 2 * k1.LANE * 4 + 4) + wbytes + 4 * grad_elems)
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
    del enc, encb, cgb, hth, azb, xtb, zs, us, cs, cf, cg
    for r in rows.values():
        print(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
              f"by {r['bound_by']}, twin {r['plain_ms']:.1f}, matmul chain "
              f"{r['library_ms']:.3f})", flush=True)
    print(f"  K3 largest relative L2 against its twin {k3_rel:.3e}; K2 "
          f"at {n3} points without zs/us {k2_nozs_ms:.3f} ms", flush=True)

    phase("serving")
    renderer = load_renderer(run_dir, 1, device="cuda")
    assert renderer.chunk == CHUNK
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
               "K3": k2.TRUNK_BWD}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    seconds, outs = [], []
    for rays in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(renderer.render_image({"rays": rays}))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {k: v.launches for k, v in kernels.items()}
    chunks = N_REQUESTS * -(-REQ_SIDE * REQ_SIDE // CHUNK)
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"  launches {launches} over {chunks} chunks", flush=True)
    assert launches == {"K1": 2 * chunks, "K2": chunks, "K3": 0}, launches
    rays_per_s = REQ_SIDE * REQ_SIDE / min(seconds)
    print(f"  request seconds {[round(s, 4) for s in seconds]}; "
          f"{rays_per_s:.1f} rays/s (fastest request); "
          f"{N_REQUESTS * REQ_SIDE * REQ_SIDE / sum(seconds):.1f} rays/s "
          f"(all); peak memory {peak_mem / 2**30:.2f} GiB", flush=True)
    rows["K1"]["launches"] = launches["K1"]
    rows["K2"]["launches"] = launches["K2"]
    profile_device(lambda: renderer.render_image({"rays": requests[1]}),
                   "request")

    phase("check")
    n = REQ_SIDE * REQ_SIDE
    for out in outs:
        assert out["rgb_coarse"].shape == (n, 3)
        assert out["depth_coarse"].shape == (n,)
        for k in ("albedo_coarse", "normal_an_coarse", "rpv_k_coarse",
                  "rpv_theta_coarse", "rpv_rhoc_coarse",
                  "irradiance_coarse"):
            assert out[k].shape == (n, 3), k
        assert out["sun_coarse"].shape == (n, 1)
        for k, v in out.items():
            assert np.isfinite(v).all(), k
    # 1,024 rays through the kernels on the card and through the plain
    # twins (the Pallas kernels' arithmetic) on the CPU, same weights and
    # draws
    small = requests[0][:1024]
    rng = torch.Generator().manual_seed(7)
    draws = {k: torch.rand(len(small), N_SAMPLES, generator=rng)
             for k in ("z", "guided", "sun")}
    a = dc.replace(renderer, chunk=len(small)).render_image(
        {"rays": small}, draws=draws)
    cpu = dc.replace(renderer, net=copy.deepcopy(renderer.net).cpu(),
                     device=torch.device("cpu"), chunk=len(small))
    b = cpu.render_image({"rays": small}, draws=draws)
    check = {}
    for k in ("rgb_coarse", "depth_coarse", "normal_an_coarse"):
        d = np.abs(a[k] - b[k]).reshape(len(small), -1).max(-1)
        check[k] = (float(d.mean()), float(np.quantile(d, 0.99)))
        print(f"  kernels vs twins {k}: mean {check[k][0]:.3e} "
              f"p99 {check[k][1]:.3e}", flush=True)
    # K1 keeps f32 activations in its twin and bf16 in the kernel, so the
    # probe's depth and with it the guided samples move a little; the
    # siren trunk amplifies a moved sample on isolated rays
    assert check["depth_coarse"][0] < 1e-2 and check["rgb_coarse"][0] < 1e-2
    assert check["rgb_coarse"][1] < 0.1
    del renderer, outs, cpu

    phase("training")
    rcfg, tcfg = cfg.render, cfg.train
    batcher = DeviceRayBatcher(
        make_store(STORE_BATCHES * BATCH, np.random.RandomState(0)), BATCH,
        seed=0, device="cuda")
    spe = batcher.steps_per_epoch
    assert spe == STORE_BATCHES
    state, optimizer = ts.create_train_state(mcfg, tcfg, spe, seed=0,
                                             device="cuda")
    # the gates' epoch is one step long, so that from step WARM_STEPS on
    # every gate of the JAX package's bench.py holds (cos_irra off, ds,
    # nrrg and hard-surface on, no beta warm-up); the optimizer's epoch is
    # the store's 16 steps
    sched = ts.GateSchedule(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                            steps_per_epoch=1, first_beta_epoch=0)
    assert ts.gates_from_step(WARM_STEPS, sched) == ts.TrainGates(
        cos_irra_on=False, ds_on=True, nrrg_on=True, beta_warmup=False,
        hs_on=True)
    step = ts.make_fused_train_step(mcfg, rcfg, tcfg, optimizer, sched)
    seed = 0

    def one_step(state):
        return step(state, batcher.store, batcher.next_index_tensor(), seed)

    for _ in range(WARM_STEPS):
        state, m = one_step(state)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = one_step(state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = {k: v.launches for k, v in kernels.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"  launches {launches} over {TIMED_STEPS} steps", flush=True)
    # per step: the probe and the sun march (K1), the main pass with zs/us
    # (K2) and its backward (K3: one call, a sweep and a weight-gradient
    # kernel)
    assert launches == {"K1": 2 * TIMED_STEPS, "K2": TIMED_STEPS,
                        "K3": TIMED_STEPS}, launches
    assert state.step == WARM_STEPS + TIMED_STEPS
    print(f"  ms/step fastest {min(step_ms):.3f}, mean "
          f"{sum(step_ms) / len(step_ms):.3f}; train rays/s "
          f"{BATCH / min(step_ms) * 1e3:.1f} (fastest step), "
          f"{BATCH * len(step_ms) / sum(step_ms) * 1e3:.1f} (mean); peak "
          f"memory {peak_mem / 2**30:.2f} GiB", flush=True)
    print(f"  loss {[round(v, 5) for v in losses]}", flush=True)
    print(f"  last metrics {({k: round(float(v), 5) for k, v in m.items()})}",
          flush=True)
    assert all(np.isfinite(losses)), losses
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"  loss mean of the first five timed steps {first:.5f}, of the "
          f"last five {last:.5f}", flush=True)
    assert last < first, (first, last)
    rows["K2zs"]["launches"] = launches["K2"]
    rows["K3"]["launches"] = launches["K3"]
    rows["K1"]["launches_train"] = launches["K1"]
    state, _ = one_step(state)
    profile_device(lambda: one_step(state), "train step")
    del batcher

    phase("step check")
    # one step's parameter gradients on CHECK_RAYS rays at flagship width:
    # the kernels on the card against the twins on the CPU, same weights,
    # batch, gates and draws
    s = make_store(CHECK_RAYS, np.random.RandomState(1))
    gates = ts.gates_from_step(WARM_STEPS, sched)
    rng = torch.Generator().manual_seed(11)
    n_sun = rcfg.sun_march_count(rcfg.n_samples + rcfg.effective_guided)
    draws = {"z": torch.rand(CHECK_RAYS, rcfg.n_samples, generator=rng),
             "guided": torch.rand(CHECK_RAYS, rcfg.effective_guided,
                                  generator=rng),
             "guided_gt": torch.rand(CHECK_RAYS, rcfg.effective_guided,
                                     generator=rng),
             "sun": torch.rand(CHECK_RAYS, n_sun, generator=rng)}
    net_cpu = copy.deepcopy(state.params).cpu()

    def grads_on(net_, dev):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in s.items()}
        net_.zero_grad(set_to_none=True)
        loss, _ = ts.compute_losses(
            net_, mcfg, rcfg, tcfg, batch, gates,
            draws={k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        return loss.item(), {k: p.grad.detach().cpu()
                             for k, p in net_.named_parameters()}

    for k in kernels.values():
        k.launches = 0
    loss_k, g_k = grads_on(state.params, "cuda")
    assert (k2.TRUNK_FWD_GRAD.launches, k2.TRUNK_BWD.launches) == (1, 1)
    # the same step on the card with K3, then K2 and K3, swapped for their
    # twins (K1 still the kernel): it separates what each of the
    # differentiated trunk's kernels changes from what K1 changes upstream
    fwd_cuda, bwd_cuda = k2._trunk_fwd_grad_cuda, k2._trunk_bwd_cuda
    k2._trunk_bwd_cuda = k2._trunk_bwd_plain
    loss_3, g_3 = grads_on(state.params, "cuda")
    k2._trunk_fwd_grad_cuda = k2._trunk_fwd_grad_plain
    loss_23, g_23 = grads_on(state.params, "cuda")
    k2._trunk_fwd_grad_cuda, k2._trunk_bwd_cuda = fwd_cuda, bwd_cuda
    loss_p, g_p = grads_on(net_cpu, "cpu")
    print(f"  loss: kernels {loss_k:.6f}; K3's twin on the card "
          f"{loss_3:.6f}; K2's and K3's twins on the card {loss_23:.6f}; "
          f"twins on the CPU {loss_p:.6f}", flush=True)
    worst = {}
    for label, ref in (("K3 vs its twin", g_3),
                       ("K2 and K3 vs their twins", g_23),
                       ("all kernels vs twins on the CPU", g_p)):
        rels = {k: rel_l2(g_k[k], ref[k]) for k in ref}
        worst[label] = max(rels.values())
        print(f"  gradient relative L2, {label}: largest "
              f"{worst[label]:.2e}; trunk " + ", ".join(
                  f"{k} {v:.2e}" for k, v in rels.items()
                  if k.startswith(("fc_net", "sigma"))), flush=True)
    assert all(torch.isfinite(v).all() for v in g_k.values())
    # K3 moves no forward value
    assert abs(loss_3 - loss_k) <= 1e-6 * abs(loss_k), (loss_3, loss_k)
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p), (loss_k, loss_p)
    # K3 in the step, on the cotangents the step gives it: as K3 alone
    # above (measured on the card 3.6e-3 there)
    assert worst["K3 vs its twin"] <= 1e-2, worst
    # K2's outputs differ from its twin's by 4e-4 (sigma) .. 4e-3 (gx) in
    # relative L2; the loss's cotangents pass them through -normalize(gx)
    # and the compositing weights, and the trunk's grads are sums over 16,384
    # points with cancellation, so the whole step moves by more (measured
    # on the card: 3.1e-2 with K2 and K3 swapped, 4.6e-2 against the CPU,
    # where K1's twin keeps f32 activations and moves the guided samples)
    assert worst["K2 and K3 vs their twins"] <= 0.1, worst
    assert worst["all kernels vs twins on the CPU"] <= 0.1, worst

    tmp.cleanup()
    # every row's "launches" counts its own path's run (K1's and K2's:
    # serving; K2 saving zs/us and K3: training); K1 runs on both paths
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "launches_train")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
