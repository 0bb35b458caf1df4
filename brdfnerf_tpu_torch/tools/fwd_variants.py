"""Check and time the forward kernels K2 (csrc/trunk_fwd_grad.cu) and K4
(csrc/trunk_heads_fwd.cu), the four instantiations of one kernel template
(csrc/trunk_fwd_grad.cuh): serving, and saving zs/us for training.

    python3 -m brdfnerf_tpu_torch.tools.fwd_variants --check [points ...]
    python3 -m brdfnerf_tpu_torch.tools.fwd_variants [variant ...]

Both first print what ptxas says of every forward kernel function
(registers at launch, spills, static shared memory; the consumers raise
their registers with setmaxnreg, so the highest register the SASS names is
printed too) and the dynamic shared memory of a block.

--check holds every instantiation against its plain twin at each size
given (default 64 192 640: 1, 3 and 10 tiles, no multiple of a wave), with
chip_smoke.py's bounds, in a child process with a time limit (a wait of
over ~30 s in a kernel traps instead of hanging); also two launches
bit-identical, the saving instantiations giving what the serving ones do,
K4's sigma and gx bit-identical to K2's, gx's padded lanes 0, and K2 with
f32 feats (compute_dtype bfloat16).

Without --check it times the four instantiations at the main paths'
shapes (655,360 points a serving chunk, 131,072 a training step; the
flagship 8 x 512 trunk in bfloat16_all from seed 0) as the package builds
them and as measurement-only builds of the same sources, in turns on one
card (built, variant, variant, built, ...):

  no_scratch         -DFWD_NO_SCRATCH: act'(z) goes to no scratch and comes
                     back from none; a constant stands in for it
  no_scratch_hints   -DFWD_NO_SCRATCH_HINTS: plain loads and stores of the
                     scratch instead of streaming (evict-first) ones
  no_weight_loads    -DFWD_NO_WEIGHT_LOADS: the producer loads no weight
                     slice (each ring stage completes empty), so the
                     products run on whatever the ring holds: the weight
                     stream from L2 is gone, every product and epilogue
                     stays
  half_weight_loads  -DFWD_HALF_WEIGHT_LOADS: the producer loads every other
                     weight slice, the weight stream a point pays in a
                     128-point block (below), with everything else as built
  identity_act       -DTRUNK_IDENTITY_ACT: the activation becomes w0 z
  ring2              -DFWD_RING_2: a ring of two 32 KB stages where the
                     package has four, the depth the float32 instantiation
                     (two activation and two x tiles, hi and lo) has room
                     for

Tile height: the package's block holds one 64-point tile, one wgmma row
block, which each of the two consumer warpgroups multiplies by its 256 of
the 512 columns.  128 points a block (each warpgroup one 64-point tile over
all 512 columns in two n256 passes) does not fit the SM: the two
warpgroups' A tiles (2 x 64 KB), the first pass's staged outputs that the
second pass must not overwrite (2 x 32 KB) and the two x tiles (2 x 16 KB)
take 224 of the 227 KB of shared memory, leaving no room for a ring of
32 KB weight stages.  Staging the first pass in registers instead, as bf16,
adds 64 registers to the second pass's 128 accumulators in consumers that
already spill at 232 (printed above).  What 128 points a block could win at
most, its halved weight stream from L2, is what half_weight_loads times.

Prints the card's name and power limit first, one line per kernel, variant
and round, and a JSON summary line last.
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from ..ops import cuda_build
from ..ops import fused_trunk_heads as k4
from ..ops import fused_trunk_vjp as k2
from .bwd_check import max_registers, ptxas_summary
from .bwd_variants import VariantKernel

FORWARD = ("trunk_fwd_grad", "trunk_heads_fwd")
SERVE_N, TRAIN_N = 655360, 131072
ROUNDS = 3
CHILD_SECONDS = 240
VARIANTS = {"no_scratch": "-DFWD_NO_SCRATCH",
            "identity_act": "-DTRUNK_IDENTITY_ACT",
            "no_weight_loads": "-DFWD_NO_WEIGHT_LOADS",
            "half_weight_loads": "-DFWD_HALF_WEIGHT_LOADS",
            "no_scratch_hints": "-DFWD_NO_SCRATCH_HINTS",
            "ring2": "-DFWD_RING_2"}
LIBS = {"trunk_fwd_grad": (k2, "TRUNK_FWD_GRAD"),
        "trunk_heads_fwd": (k4, "TRUNK_HEADS_FWD")}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_log(name: str) -> str:
    """nvcc's -Xptxas -v output for csrc/<name>.cu: from this process's
    build, or from one more compile when the library was found built."""
    log = cuda_build.build_log.get(name, {}).get("log")
    if log:
        return log
    path = cuda_build.library_path(name)[:-3] + "-ptxas.so"
    return subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", path,
         os.path.join(cuda_build.CSRC, f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, check=True).stdout


def print_ptxas() -> list:
    """What ptxas and the SASS say of the forward kernel functions of the
    package build; returns the summary rows."""
    rows = []
    for name in FORWARD:
        log = ptxas_log(name)
        tops = max_registers(cuda_build.library_path(name))
        # the dynamic shared memory of a block, from the library itself
        smem = getattr(cuda_build.load(name), f"{name}_smem")()
        for fn in ptxas_summary(log):
            top = next((v for k, v in tops.items() if k in fn["name"]
                        or fn["name"] in k), None)
            fn = dict(fn, library=name, sass_top_register=top,
                      dynamic_smem=smem)
            rows.append(fn)
            print(f"  {name} {fn['name'][:56]}: {fn['registers']} registers"
                  f" at launch (SASS up to R{top}), spills "
                  f"{fn['spill_stores']} B stored / {fn['spill_loads']} B "
                  f"loaded, static smem {fn['smem']} B, dynamic smem "
                  f"{smem} B", flush=True)
            for note in fn["notes"]:
                print(f"    ptxas {note}", flush=True)
        # the wgmma notes in full (ptxas_summary keeps their first words)
        for note in sorted({ln.split("info    :")[-1].strip()
                            for ln in log.splitlines() if "(C75" in ln}):
            print(f"  {name} ptxas: {note[:240]}", flush=True)
    return rows


def setup(n: int, compute_dtype: str = "bfloat16_all"):
    """The flagship network (8 x 512, skip 4, the RPV(111) heads) from seed
    0 and n encoded points."""
    from ..config import ModelConfig
    from ..models.network import init_network
    from ..ops import fused_mlp as k1
    from ..ops.encoding import positional_encoding
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype=compute_dtype, normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1)
    g = torch.Generator(device="cuda").manual_seed(0)
    net = init_network(cfg, g, device="cuda")
    xyz = torch.rand(n, 3, device="cuda", generator=g) * 2 - 1
    enc = positional_encoding(xyz, 10, fast=True, pad_to=k1.LANE)
    return (cfg, k1.pack_trunk_weights(net, cfg, torch.bfloat16),
            k4.pack_head_weights(net, cfg, torch.bfloat16), enc)


def _hold(label, got, ref, l2=None):
    """chip_smoke.py's bounds: max <= 5e-2 scale, mean <= 1e-3 scale, and
    relative L2 <= l2 where given."""
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    rel = ((got.float() - ref.float()).norm()
           / ref.float().norm().clamp_min(1e-30)).item()
    ok = (bool(torch.isfinite(got.float()).all())
          and d.max().item() <= 5e-2 * scale
          and d.mean().item() <= 1e-3 * scale and (l2 is None or rel <= l2))
    print(f"    {label}: max {d.max().item():.3e} mean {d.mean().item():.3e}"
          f" rel L2 {rel:.3e} (scale {scale:.3e})"
          + ("" if ok else "  FAIL"), flush=True)
    return ok


def child(n: int) -> int:
    """Every instantiation against its twin at n points; 0 when all hold."""
    cfg, packed, hw, enc = setup(n)
    ok = True
    s2 = k2._trunk_fwd_grad_cuda(packed, cfg, enc)
    z2 = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs=True)
    z2b = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs=True)
    s4 = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc)
    z4 = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, want_zs=True)
    z4b = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, want_zs=True)
    p2 = k2._trunk_fwd_grad_plain(packed, cfg, enc, want_zs=True)
    p4 = k4._trunk_heads_fwd_plain(packed, hw, cfg, enc, want_zs=True)
    torch.cuda.synchronize()
    print(f"  n={n}", flush=True)
    for name, g_, r_ in zip(("sigma", "feats", "gx", "zs", "us"), z2, p2):
        ok &= _hold(f"K2 {name}", g_, r_, 1e-2 if name in ("zs", "us")
                    else None)
    for name, g_, r_ in (("out", z4[0], p4[0]), ("gx", z4[1], p4[1]),
                         ("zs", z4[2], p4[2])):
        ok &= _hold(f"K4 {name}", g_, r_, 1e-2 if name == "zs" else None)
    checks = {
        "K2 twice bit-identical": all(torch.equal(a, b)
                                      for a, b in zip(z2, z2b)),
        "K4 twice bit-identical": all(torch.equal(a, b)
                                      for a, b in zip(z4, z4b)),
        "K2 saving zs/us gives the serving outputs": all(
            torch.equal(a, b) for a, b in zip(z2[:3], s2)),
        "K4 saving zs gives the serving outputs": all(
            torch.equal(a, b) for a, b in zip(z4[:2], s4[:2])),
        "K4 sigma and gx bit-identical to K2's": (
            torch.equal(s4[0][:, 0], s2[0]) and torch.equal(s4[1], s2[2])),
        "K4 zs bit-identical to K2's": torch.equal(z4[2], z2[3]),
        "gx padded lanes 0": (s2[2][:, 60:].abs().max().item() == 0.0
                              and s4[1][:, 60:].abs().max().item() == 0.0),
        "K4 padded column 0": s4[0][:, 7].abs().max().item() == 0.0,
    }
    for k, v in checks.items():
        print(f"    {k}: {v}", flush=True)
        ok &= v
    # serving with f32 feats (compute_dtype bfloat16)
    cfg32 = dc.replace(cfg, compute_dtype="bfloat16")
    f2 = k2._trunk_fwd_grad_cuda(packed, cfg32, enc)
    q2 = k2._trunk_fwd_grad_plain(packed, cfg32, enc)
    torch.cuda.synchronize()
    ok &= f2[1].dtype == torch.float32
    for name, g_, r_ in zip(("sigma", "feats f32", "gx"), f2, q2):
        ok &= _hold(f"K2 (bfloat16) {name}", g_, r_)
    print(f"  n={n}: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


def check(sizes) -> int:
    rc = 0
    for n in sizes:
        try:
            r = subprocess.run([sys.executable, "-m", __spec__.name,
                                "--child", str(n)], timeout=CHILD_SECONDS)
            rc = rc or r.returncode
        except subprocess.TimeoutExpired:
            print(f"  n={n}: no answer in {CHILD_SECONDS} s (killed)",
                  flush=True)
            rc = 1
    return rc


def build_variants(flags):
    """{(library, variant): path} of both forward libraries built with each
    variant's flag, all nvcc processes started together."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for lib in FORWARD:
        for variant, flag in flags.items():
            path = cuda_build.library_path(lib)[:-3] + f"-{variant}.so"
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, flag, "-o",
                   path, os.path.join(cuda_build.CSRC, f"{lib}.cu")]
            procs[(lib, variant)] = (path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
    return {key: path for key, (path, _) in procs.items()}


def timed(fn, reps=5):
    """ms per call by CUDA events over reps calls after one."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_variants(flags, summary) -> int:
    paths = build_variants(flags)
    cfg, packed, hw, enc_s = setup(SERVE_N)
    enc_t = enc_s[:TRAIN_N].contiguous()
    runs = {
        "K2": ("trunk_fwd_grad",
               lambda: k2._trunk_fwd_grad_cuda(packed, cfg, enc_s)),
        "K2zs": ("trunk_fwd_grad",
                 lambda: k2._trunk_fwd_grad_cuda(packed, cfg, enc_t,
                                                 want_zs=True)),
        "K4": ("trunk_heads_fwd",
               lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc_s)),
        "K4zs": ("trunk_heads_fwd",
                 lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc_t,
                                                  want_zs=True)),
    }
    for name, (lib, run) in runs.items():
        mod, attr = LIBS[lib]
        built = getattr(mod, attr)
        cases = {"built": built}
        cases.update({v: VariantKernel(built, paths[(lib, v)])
                      for v in flags})
        times = {c: [] for c in cases}
        for r in range(ROUNDS):
            order = list(cases) if r % 2 == 0 else list(cases)[::-1]
            for c in order:
                setattr(mod, attr, cases[c])
                try:
                    times[c].append(timed(run))
                finally:
                    setattr(mod, attr, built)
            print(f"  {name} round {r}: " + ", ".join(
                f"{c} {times[c][-1]:.3f} ms" for c in cases), flush=True)
        med = {c: statistics.median(v) for c, v in times.items()}
        summary["kernels"][name] = {"rounds_ms": times, "median_ms": med}
        print(f"  {name}: median " + ", ".join(
            f"{c} {v:.3f}" for c, v in med.items()), flush=True)
    return 0


def main(argv) -> int:
    if "--child" in argv:
        return child(int(argv[argv.index("--child") + 1]))
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.build(list(FORWARD))
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {"card": smi, "ptxas": print_ptxas(), "kernels": {}}
    if "--check" in argv:
        sizes = [int(a) for a in argv if a.isdigit()] or [64, 192, 640]
        return check(sizes)
    flags = {v: f for v, f in VARIANTS.items() if not argv or v in argv}
    rc = time_variants(flags, summary)
    print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
