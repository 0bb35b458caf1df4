"""Check the backward kernels K3 (csrc/trunk_bwd.cu) and K5
(csrc/trunk_heads_bwd.cu) on the card: build them, print what ptxas says
of every backward kernel function (registers, spills, shared memory), run
the layout check of csrc/sm90_common.cuh (tools/sm90_check.py), then hold
each kernel against its plain twin at every size given, and its scratch
(the bf16 operands of the weight gradients) against the twins'
intermediates, so that a fault shows where it starts.  Each size runs in a
child process with a time limit, so a kernel that hangs fails the check
instead of holding the card.

    python3 -m brdfnerf_tpu_torch.tools.bwd_check [points ...] [--time]

Points default to 64 192 640 131072 (1, 3, 10 and 2,048 tiles); --time
also times each kernel at the largest size, split by kernel function.
Exits non-zero on any failure.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import time

import torch

BACKWARD = ("trunk_bwd", "trunk_heads_bwd")
CHILD_SECONDS = 240


def ptxas_summary(log: str):
    """(function, registers, spill stores, spill loads, static shared
    bytes, wgmma notes) per kernel function of an nvcc -Xptxas -v log."""
    out, fn, notes = [], None, []
    for ln in log.splitlines():
        m = re.search(r"\((C75\d\d)\) (.*?)( in| by compiler|$)", ln)
        if m:
            notes.append(m.group(1) + " " + m.group(2)[:60])
        if "Function properties for" in ln:
            fn = {"name": ln.split("Function properties for")[-1].strip(),
                  "notes": sorted(set(notes))}
            notes = []
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if fn is not None and m:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if fn is not None and m:
            fn["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            fn["smem"] = int(m.group(1)) if m else 0
            out.append(fn)
            fn = None
    return out


def max_registers(path: str):
    """{kernel function: the highest register its SASS names} (cuobjdump),
    which shows the registers a warp-specialised kernel's consumers use
    past the count ptxas reports for the launch."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[-1].strip()
            out[fn] = 0
        elif fn is not None:
            for m in re.finditer(r"\bR(\d+)\b", ln):
                out[fn] = max(out[fn], int(m.group(1)))
    return out


def _rel(got, ref):
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp_min(1e-30))


def setup(n: int):
    """The flagship network (8 x 512, skip 4, the RPV(111) heads) from seed
    0, and K3's and K5's inputs at n points."""
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.models import network as tnet
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding

    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all", normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1)
    g = torch.Generator(device="cuda").manual_seed(0)
    net = tnet.init_network(cfg, g, device="cuda")
    xyz = torch.rand(n, 3, device="cuda", generator=g) * 2 - 1
    enc = positional_encoding(xyz, 10, fast=True, pad_to=k1.LANE)
    packed = k1.pack_trunk_weights(net, cfg, torch.bfloat16)
    hw = k4.pack_head_weights(net, cfg, torch.bfloat16)
    _, _, _, zs, us = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs=True)
    cs = torch.randn(n, device="cuda", generator=g)
    cf = (torch.randn(n, 512, device="cuda", generator=g) * 0.1).to(
        torch.bfloat16)
    cg = torch.zeros(n, k1.LANE, device="cuda")
    cg[:, :60] = torch.randn(n, 60, device="cuda", generator=g)
    cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=g)
    cot[:, 7] = 0.0
    k3 = lambda **kw: k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs,
                                         us, **kw)
    k5 = lambda **kw: k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg,
                                               zs, **kw)
    return dict(cfg=cfg, enc=enc, packed=packed, hw=hw, zs=zs, us=us, cs=cs,
                cf=cf, cg=cg, cot=cot, k3=k3, k5=k5)


def child(n: int) -> int:
    """K3 and K5 against their twins at n points; 0 when both hold."""
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    d = setup(n)
    cfg, enc, packed, hw = d["cfg"], d["enc"], d["packed"], d["hw"]
    zs, us, cs, cf, cg, cot = (d[k] for k in ("zs", "us", "cs", "cf", "cg",
                                             "cot"))
    ok = True

    def hold(label, got, ref, bound):
        nonlocal ok
        r = _rel(got, ref)
        good = bool(torch.isfinite(got.float()).all()) and r <= bound
        ok &= good
        if not good or n <= 640:
            print(f"  n={n} {label}: rel L2 {r:.3e}"
                  + ("" if good else f"  FAIL (bound {bound})"), flush=True)

    # the twins' intermediates: the bf16 operands the sweep writes
    od = torch.bfloat16
    hs, d1s, d2s, zsig, tzs, ths, tzsig = k2._bwd_primal_tangent(
        packed, cfg, cg, zs)
    L, skip, F = cfg.layers, cfg.skips[0], cfg.feat
    w_top, w_bot = k2._split_skip(packed)
    mids = list(packed["w_mid"])

    def reverse(a_h, u_all):
        azs = [None] * L
        for i in range(L - 1, -1, -1):
            u = u_all[:, i * F:(i + 1) * F].float()
            a_z = d1s[i] * a_h + d2s[i] * tzs[i] * u
            azs[i] = (a_z, d1s[i] * u)
            if i:
                w = w_bot if i == skip else mids[i - 1 if i < skip else i - 2]
                a_h = k2._mm_t(a_z, w, od)
        return azs

    sp1 = torch.sigmoid(zsig)
    wsig = packed["w_sigma"][None, :]

    for heads in (False, True):
        name = "K5" if heads else "K3"
        scratch = {}
        if heads:
            got, again = d["k5"](scratch_out=scratch), d["k5"]()
            ref = k4._trunk_heads_bwd_plain(packed, hw, cfg, enc, cot, cg, zs)
            names = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs",
                     "dwsig", "dbsig", "dwf", "dbf", "dw1r", "db1r", "dw2r",
                     "db2r", "dw1p", "db1p", "dw2p", "db2p")
        else:
            got, again = d["k3"](scratch_out=scratch), d["k3"]()
            ref = k2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs, us)
            names = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs",
                     "dwsig", "dbsig")
        bound = 1e-2
        torch.cuda.synchronize()
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        ok &= same
        print(f"  n={n} {name}: two launches bit-identical: {same}",
              flush=True)
        for nm, g_, r_ in zip(names, got, ref):
            if nm in ("dw2r", "dw2p"):
                g_, r_ = g_[:, :3], r_[:, :3]
            hold(f"{name} {nm}", g_, r_, bound)
        # the sweep's scratch against the twins' values
        xt = scratch["xt"]
        hold(f"{name} xt", xt, torch.stack([enc, cg]).to(od), 1e-2)
        for i in range(1, L):
            hold(f"{name} hth[{i - 1}]", scratch["hth"][i - 1],
                 torch.stack([hs[i - 1], ths[i - 1]]).to(od), 2e-2)
        if heads:
            xf, hr, d1r, _, hp, d1p, _ = k4._head_forward(hs[-1], hw, od, cfg)
            pad = torch.zeros(n, k1.LANE - 3, device="cuda")
            c_z1r = d1r * k2._mm_t(torch.cat([cot[:, 1:4], pad], 1),
                                   hw["w2r"], od)
            c_z1p = d1p * k2._mm_t(torch.cat([cot[:, 4:7], pad], 1),
                                   hw["w2p"], od)
            a_xf = (k2._mm_t(c_z1r, hw["w1r"], od)
                    + k2._mm_t(c_z1p, hw["w1p"], od))
            for nm, r_ in (("hl", hs[-1]), ("xfb", xf),
                           ("cz1", torch.cat([c_z1r, c_z1p], 1)),
                           ("axf", a_xf)):
                hold(f"{name} {nm}", scratch[nm], r_.to(od), 2e-2)
            a_sig = (cot[:, 0] * sp1 + sp1 * (1 - sp1) * tzsig)[:, None]
            a_h = (k2._mm_t(a_sig, wsig, od)
                   + k2._mm_t(a_xf, hw["wf"], od))
            # the b_th chain K5 rebuilds before its sweep
            u_all = k4.uchain_plain(packed, cfg, zs)
            hold(f"{name} uc", k4.uchain_from_kernel(scratch["uc"], n, L),
                 u_all, 1e-2)
        else:
            a_h = (k2._mm_t((cs * sp1 + sp1 * (1 - sp1) * tzsig)[:, None],
                            wsig, od) + cf.float())
            u_all = us
        for i, (a_z, b_tz) in enumerate(reverse(a_h, u_all)):
            hold(f"{name} azbtz[{i}]", scratch["azbtz"][i],
                 torch.stack([a_z, b_tz]).to(od), 3e-2)
    print(f"  n={n}: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


def time_kernels(n: int) -> int:
    """ms of K3 and K5 at n points (CUDA events over 5 launches after one),
    and the device time of each of their kernel functions per launch
    (torch.profiler over 3 launches)."""
    from torch.profiler import ProfilerActivity, profile
    d = setup(n)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"  timing at n={n} on {smi}", flush=True)
    for name in ("k3", "k5"):
        fn = d[name]
        fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(5):
            fn()
        e1.record()
        torch.cuda.synchronize()
        print(f"  {name.upper()}: {e0.elapsed_time(e1) / 5:.3f} ms",
              flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                print(f"    {ev.self_device_time_total / 3e3:9.3f} ms  "
                      f"{ev.key[:70]}", flush=True)
    return 0


def main(argv) -> int:
    if "--child" in argv:
        return child(int(argv[argv.index("--child") + 1]))
    if "--time-child" in argv:
        return time_kernels(int(argv[argv.index("--time-child") + 1]))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from brdfnerf_tpu_torch.ops import cuda_build
    from brdfnerf_tpu_torch.tools import sm90_check
    sizes = [int(a) for a in argv if a.isdigit()] or [64, 192, 640, 131072]
    t0 = time.perf_counter()
    cuda_build.build(BACKWARD + ("trunk_fwd_grad", "sm90_check"))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in BACKWARD:
        rec = cuda_build.build_log.get(name, {})
        print(f"{name}: {rec.get('seconds', 0):.1f} s", flush=True)
        for fn in ptxas_summary(rec.get("log", "")):
            print(f"  {fn['name'][:60]}: {fn['registers']} registers, "
                  f"spills {fn['spill_stores']} B stored / "
                  f"{fn['spill_loads']} B loaded, static smem {fn['smem']} B",
                  flush=True)
            for note in fn["notes"]:
                print(f"    ptxas {note}", flush=True)
        for fn, top in max_registers(cuda_build.library_path(name)).items():
            print(f"  {fn[:60]}: highest register in SASS R{top}",
                  flush=True)
    rc = sm90_check.main()
    runs = [("--child", n) for n in sizes]
    if "--time" in argv and rc == 0:
        runs.append(("--time-child", max(sizes)))
    for flag, n in runs:
        if rc and flag == "--time-child":
            break
        try:
            r = subprocess.run([sys.executable, "-m", __spec__.name, flag,
                                str(n)], timeout=CHILD_SECONDS)
            rc = rc or r.returncode
        except subprocess.TimeoutExpired:
            print(f"  {flag} {n}: no answer in {CHILD_SECONDS} s (killed)",
                  flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
