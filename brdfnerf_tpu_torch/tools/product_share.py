"""How much of a layer-major product (csrc/trunk_layers.cu,
layers_product_kernel) is its mainloop and how much its fused epilogue, and
what each instantiation costs in registers and build time.

One product of layer 2 of the 12 x 2048 trunk (skip 4) over the first
point block of a K3 call at the training step's shape (131,072 points:
20,480 a block at bfloat16_all, 13,184 at float32) is timed under each of
K2's and K3's epilogues (EPI_FWD, EPI_CHAIN, EPI_TAN, EPI_ADJ, EPI_WGRAD)
with the operands, strides and outputs the main path gives it, and beside
it the same product under EPI_NONE, which writes nothing: the bare
mainloop; and the product with its epilogue on a plain grid of one block
a tile, beside the main path's persistent blocks (as many as the SMs
hold, walking the tiles).  All three come from the library built with
-DLAYERS_PROBE (the entry point tl_product_probe; the main path's library
has neither), in turns (with, none, plain; plain, none, with; ...), at
bfloat16_all and at float32 (three bf16 products and the flush every 512
products).

    python3 -m brdfnerf_tpu_torch.tools.product_share [--rounds N]

Builds the package's trunk_layers library alone first and reports its
nvcc seconds, then the probe build; prints the registers and spills ptxas
gives every instantiation of layers_product_kernel (EPI x layout x FLUSH),
the card's name and power limit, one line per product, and a JSON summary
line last.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses as dc
import json
import os
import re
import subprocess
import sys
import time

import torch

from ..ops import cuda_build
from ..ops import fused_mlp as k1
from ..ops import fused_trunk_vjp as k2
from ..ops import trunk_layers as tl

EPIS = ("EPI_FWD", "EPI_CHAIN", "EPI_TAN", "EPI_ADJ", "EPI_WGRAD",
        "EPI_PLAIN", "EPI_LOGITS", "EPI_HEADS", "EPI_NONE")
PROBED = EPIS[:5]
N_POINTS = 131072
DTYPES = ("bfloat16_all", "float32")
REPS = 5

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_INST = re.compile(r"layers_product_kernelILi(\d+)ELb([01])ELb([01])"
                   r"ELb([01])E")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_table(log: str):
    """[(EPI, A layout, B layout, FLUSH, registers, spill stores, spill
    loads)] of every layers_product_kernel instantiation in an nvcc -Xptxas
    -v log."""
    rows, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = _INST.search(m.group(1))
            spill = (0, 0)
            continue
        if cur is None:
            continue
        s = _SPILL.search(line)
        if s:
            spill = (int(s.group(1)), int(s.group(2)))
        r = _REGS.search(line)
        if r:
            epi, ak, bkm, flush = (int(g) for g in cur.groups())
            rows.append((EPIS[epi], "K-major" if ak else "MN-major",
                         "K-major" if bkm else "MN-major", bool(flush),
                         int(r.group(1)), *spill))
            cur = None
    return sorted(set(rows))


def build_probe():
    """nvcc csrc/trunk_layers.cu with -DLAYERS_PROBE; (path, seconds,
    log)."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = cuda_build.library_path("trunk_layers")[:-3] + "-probe.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DLAYERS_PROBE",
           "-o", path, os.path.join(cuda_build.CSRC, "trunk_layers.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probe build:\n"
                           f"{proc.stdout}")
    return path, time.perf_counter() - t0, proc.stdout


def probe_call(lib, cfg, net, gen):
    """(call(epi, none), M rows, planes) of one product of the K3
    arguments at N_POINTS points' first block, every scratch filled from
    gen."""
    e = k1._round_up(cfg.xyz_in_dim, k1.LANE)
    packed = k1.pack_trunk_weights(net, cfg, k1.weight_dtype(cfg))
    block = tl.point_block("K3", cfg, e, N_POINTS)
    scratch = {}
    for k, (shape, dt) in tl.scratch_shapes("K3", cfg, e, block).items():
        scratch[k] = (torch.randn(shape, device="cuda", generator=gen)
                      * 0.1).to(dt)
    sd = k2._saved_dtype(cfg)
    lf = cfg.layers * cfg.feat
    zs = torch.randn(block, lf, device="cuda", generator=gen).to(sd)
    us = (torch.randn(block, lf, device="cuda", generator=gen)
          * 0.01).to(sd)
    x = torch.zeros(block, e, device="cuda")
    ptrs = dict(x=x.data_ptr(), zs=zs.data_ptr(), us=us.data_ptr(),
                **tl._weight_ptrs(cfg, packed),
                **{k: v.data_ptr() for k, v in scratch.items()})
    dims = dict(n=block, e=e, f=cfg.feat, layers=cfg.layers,
                skip=cfg.skips[0], split=int(k1.split_operands(cfg)),
                block=block, saved_f32=int(sd == torch.float32),
                wslices=tl.wgrad_slices(cfg, block))
    p = (ctypes.c_longlong * len(tl.PTRS))(*(ptrs.get(k, 0)
                                             for k in tl.PTRS))
    d = (ctypes.c_int * len(tl.DIMS))(*(dims.get(k, 0) for k in tl.DIMS))
    fn = lib.tl_product_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    keep = (packed, scratch, zs, us, x)

    def call(epi: int, none: int, plain: int = 0):
        err = fn(p, d, epi, none, plain, stream)
        if err:
            raise RuntimeError(f"tl_product_probe {EPIS[epi]} none={none} "
                               f"plain={plain}: CUDA error {err}")
        return keep

    return call, block, 2 if k1.split_operands(cfg) else 1


def timed(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    from .width_check import peaks_of, width_model
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    key = cuda_build.library_key("trunk_layers")
    if os.path.exists(cuda_build.library_path(key)):
        os.remove(cuda_build.library_path(key))
    cuda_build.build([key])
    built = cuda_build.build_log[key]
    path, probe_s, _ = build_probe()
    print(f"trunk_layers build {built['seconds']:.1f} s alone; probe build "
          f"{probe_s:.1f} s", flush=True)
    table = ptxas_table(built["log"])
    for epi, a, b, flush, regs, st, ld in table:
        print(f"  ptxas {epi:10s} A {a:8s} B {b:8s} FLUSH {int(flush)}: "
              f"{regs} registers, spill stores {st} B, loads {ld} B",
              flush=True)
    lib = ctypes.CDLL(path)
    torch.backends.cuda.matmul.allow_tf32 = False
    peak = peaks_of(torch.cuda.get_device_name(0))[0]
    summary = {"card": smi, "build_s": built["seconds"],
               "probe_build_s": probe_s,
               "ptxas": [dict(zip(("epi", "a", "b", "flush", "registers",
                                   "spill_stores", "spill_loads"), r))
                         for r in table],
               "products": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg16, net = width_model(2048, 12, 4)
    for dtype in DTYPES:
        cfg = k1.kernel_cfg(dc.replace(cfg16, compute_dtype=dtype))
        call, m, planes = probe_call(lib, cfg, net, gen)
        prods = 3 if planes == 2 else 1
        for epi in range(len(PROBED)):
            times = {"with": [], "none": [], "plain": []}
            runs = (("with", 0, 0), ("none", 1, 0), ("plain", 0, 1))
            for r in range(args.rounds):
                for name, none, plain in (runs if r % 2 == 0
                                          else runs[::-1]):
                    times[name].append(timed(
                        lambda: call(epi, none, plain)))
            w, n, g = (min(times[k]) for k in ("with", "none", "plain"))
            # K3's weight gradient sums [h | th]^T [a_z | b_tz]: two
            # segments of M points
            flops = 2.0 * cfg.feat * cfg.feat * m * prods * (
                2 if PROBED[epi] == "EPI_WGRAD" else 1)
            bound = flops / peak * 1e3
            row = {"dtype": dtype, "epi": PROBED[epi], "points": m,
                   "ms": w, "mainloop_ms": n, "plain_grid_ms": g,
                   "epilogue_share": (w - n) / w, "bound_ms": bound,
                   "tflops": flops / w * 1e-9,
                   "mainloop_tflops": flops / n * 1e-9,
                   "all_ms": times["with"], "all_mainloop_ms": times["none"],
                   "all_plain_grid_ms": times["plain"]}
            summary["products"].append(row)
            print(f"  {dtype:12s} {PROBED[epi]:9s} M {m}: {w:.3f} ms "
                  f"(mainloop {n:.3f} ms, epilogue {(w - n) / w:.1%}; "
                  f"plain grid {g:.3f} ms; bound {bound:.3f} ms; "
                  f"{flops / w * 1e-9:.1f} TFLOP/s, mainloop "
                  f"{flops / n * 1e-9:.1f})", flush=True)
        del call
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
