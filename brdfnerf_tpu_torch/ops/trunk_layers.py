"""K1-K5 as layer-major CUDA kernels (csrc/trunk_layers.cu): the trunk
kernels at every width and encoding the fused family (csrc/trunk_sigma.cu,
trunk_fwd_grad.cu, trunk_bwd.cu, trunk_heads_fwd.cu, trunk_heads_bwd.cu:
widths 64..512, 128 lanes) does not take.

They compute what the JAX package's Pallas kernels compute
(brdfnerf_tpu/ops/pallas_mlp.py _trunk_kernel, pallas_trunk_vjp.py
_fwd_kernel and _bwd_kernel, pallas_trunk_heads.py _fwd_kernel_h and
_bwd_kernel_h), with the arithmetic of the plain twins beside the fused
family (fused_mlp._trunk_sigma_plain, fused_trunk_vjp._trunk_fwd_grad_plain
and _trunk_bwd_plain, fused_trunk_heads._trunk_heads_fwd_plain and
_trunk_heads_bwd_plain, which take any width): bf16 products with f32
sums, K1's f32 activations as two bf16 terms, and at compute_dtype float32
every product as three on the bf16 hi and lo terms of its f32 operands
(fused_mlp.split3_mm), the tensor cores' accumulator added into an f32 sum
every 512 products (a K of 3 x 2,048 in one accumulator sat 3-10x further
from the exact twin).

Each launch of a kernel here runs one layer's product over a block of
points with its epilogue fused, so that one layer's weights stay in L2
while the block's point tiles pass through (the fused family instead keeps
a point tile on chip through every layer, which stops fitting past width
512).  One call of `layers_sigma`, `layers_fwd_grad`, `layers_bwd`,
`layers_fwd_grad_heads` or `layers_bwd_heads` is one launch of K1, K2, K3,
K4 or K5 in the counts (TRUNK_SIGMA_WIDE, TRUNK_FWD_GRAD_WIDE,
TRUNK_BWD_WIDE, TRUNK_HEADS_FWD_WIDE, TRUNK_HEADS_BWD_WIDE): its C entry
point walks the points in blocks of `point_block` rows, sized so that its
scratch (every layer's act'(z) for K2's and K4's reverse chain; every
layer's tz, h and th for K3, and for K5 also the b_th chain it rebuilds
from zs in f32) stays within BUDGET bytes.  The wrappers take the packing
of fused_mlp.kernel_cfg: the width, the encoding lanes and the points
padded to multiples of ROWS with zeros, which is exact (a padded column
has z = 0, h = act(0) = 0 and a chain state of 0, and every padded
gradient entry is 0); the heads packed at that width by
fused_trunk_heads.pack_head_weights, with the merged first layers W_1 and
the second layers laid over them (W_2) that K4 and K5 read here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..config import ModelConfig
from .cuda_build import CudaKernel
from .fused_mlp import (PLANE_KEYS, act_of, check_kernel_inputs,
                        split_operands)
from .fused_trunk_heads import HEAD_COLS, LOGITS

_P = ctypes.c_void_p
TRUNK_SIGMA_WIDE = CudaKernel("trunk_layers", "tl_sigma", [_P, _P, _P])
TRUNK_FWD_GRAD_WIDE = CudaKernel("trunk_layers", "tl_fwd_grad",
                                 [_P, _P, _P])
TRUNK_BWD_WIDE = CudaKernel("trunk_layers", "tl_bwd", [_P, _P, _P])
TRUNK_HEADS_FWD_WIDE = CudaKernel("trunk_layers", "tl_fwd_grad_heads",
                                  [_P, _P, _P])
TRUNK_HEADS_BWD_WIDE = CudaKernel("trunk_layers", "tl_bwd_heads",
                                  [_P, _P, _P])

# the kernels' tile: the width, the encoding lanes and the points are
# multiples of it (csrc/trunk_layers.cu BM = BN)
ROWS = 128
# points whose products one accumulator of the weight gradients sums
# (csrc/trunk_layers.cu WG_SLICE)
WG_SLICE = 8192
# the scratch one launch may hold: 4 GiB, so that a 655,360-point serving
# chunk at 12 x 2048 keeps 0.3 GB-0.4 GB of act'(z) a layer per block
# instead of 59 GB for the whole chunk
BUDGET = 4 << 30

# the pointer slots and dimensions of the entry points' two arrays, in the
# order of csrc/trunk_layers.cu's enums
PTRS = ("x", "w0", "w0_lo", "w_mid", "w_mid_lo", "w_skip", "w_skip_lo",
        "b0", "b_mid", "b_skip", "w_sigma", "b_sigma", "sigma", "feats",
        "gx", "zs", "us", "cs", "cf", "cg", "dw0", "db0", "dwm", "dbm",
        "dwst", "dwsb", "dbs", "dwsig", "dbsig", "xs", "cgs", "h0", "h1",
        "d1", "hs", "ths", "tz", "az0", "az1", "btz0", "btz1", "spart",
        "spart2", "zsig", "cpart", "dwsp", "bsp", "wpart", "cot", "out",
        "wf", "wf_lo", "bf", "w1", "w1_lo", "b1", "w2", "b2", "dwf", "dbf",
        "dw1", "dbw2", "db2", "hpart", "xf", "axf", "cz1", "cfh", "uc",
        "hcp", "b2p")
DIMS = ("n", "e", "f", "layers", "skip", "split", "block", "feats_f32",
        "saved_f32", "wslices")


def planes_of(cfg: ModelConfig) -> int:
    """bf16 planes of each activation operand in K2/K3: the rounded value,
    or at float32 its hi and lo terms."""
    return 2 if split_operands(cfg) else 1


def wgrad_slices(cfg: ModelConfig, block: int) -> int:
    """The split-K slices of a weight gradient over `block` points: its
    segments ([h | th] against [a_z | b_tz], three products each at
    float32) cut into WG_SLICE points' products."""
    segs = 2 * (3 if split_operands(cfg) else 1)
    return -(-segs * block // WG_SLICE)


def scratch_shapes(kind: str, cfg: ModelConfig, e: int, block: int
                   ) -> Dict[str, tuple]:
    """name -> (shape, dtype) of the scratch of K1, K2, K3, K4 or K5 at
    encoding width e (lanes) and `block` points a block."""
    f, layers = cfg.feat, cfg.layers
    bf, f32 = torch.bfloat16, torch.float32
    parts = {"spart": ((f // ROWS, block), f32), "zsig": ((block,), f32)}
    if kind == "K1":
        return dict(parts, xs=((2, block, e), bf), h0=((2, block, f), bf),
                    h1=((2, block, f), bf))
    pl = planes_of(cfg)
    if kind in ("K2", "K4"):
        out = dict(parts, xs=((pl, block, e), bf), h0=((pl, block, f), bf),
                   h1=((pl, block, f), bf), d1=((layers, block, f), f32))
        if kind == "K4":
            # the six logits' row partials over the merged first layers'
            # 2 F columns
            out["hpart"] = ((LOGITS, 2 * f // ROWS, block), f32)
        return out
    assert kind in ("K3", "K5"), kind
    heads = kind == "K5"
    act = ((pl, block, f), bf)
    out = dict(parts, xs=((pl, block, e), bf), cgs=((pl, block, e), bf),
               hs=((layers if heads else layers - 1, pl, block, f), bf),
               ths=((layers - 1, pl, block, f), bf),
               tz=((layers, block, f), f32), az0=act, az1=act, btz0=act,
               btz1=act, spart2=((f // ROWS, block), f32),
               cpart=((block // ROWS, f), f32),
               dwsp=((block // ROWS, f), f32), bsp=((block // ROWS,), f32),
               wpart=((wgrad_slices(cfg, block),
                       max(e, 2 * f if heads else f), f), f32))
    if heads:
        # xf, a_xf and c_z1's operand planes, a_xf W_f (K3's c_feats), the
        # rebuilt b_th chain (f32), the column partials of [c_z1; dW_2] and
        # of the cotangents
        out.update(xf=act, axf=act, cz1=((pl, block, 2 * f), bf),
                   cfh=((block, f), f32), uc=((block, layers * f), f32),
                   hcp=((block // ROWS, 4, 2 * f), f32),
                   b2p=((block // ROWS, HEAD_COLS), f32))
    return out


def scratch_bytes(kind: str, cfg: ModelConfig, e: int, block: int) -> int:
    total = 0
    for shape, dt in scratch_shapes(kind, cfg, e, block).values():
        k = 1
        for s in shape:
            k *= s
        total += k * (2 if dt == torch.bfloat16 else 4)
    return total


def point_block(kind: str, cfg: ModelConfig, e: int, n: int) -> int:
    """The points of a block of K1..K5 on n points (a multiple of
    ROWS): all of them where their scratch fits BUDGET, else the most
    multiples of ROWS that fit (at least ROWS)."""
    block = n
    if scratch_bytes(kind, cfg, e, block) <= BUDGET:
        return block
    per = max(1, scratch_bytes(kind, cfg, e, 2 * ROWS)
              - scratch_bytes(kind, cfg, e, ROWS)) / ROWS
    block = max(ROWS, min(n, int(BUDGET / per) // ROWS * ROWS))
    while block > ROWS and scratch_bytes(kind, cfg, e, block) > BUDGET:
        block -= ROWS
    return block


def _weight_ptrs(cfg: ModelConfig, packed: Dict,
                 hw: Optional[Dict] = None) -> Dict[str, int]:
    """The hi (bf16 weights) and, at float32, lo planes of w0, w_mid and
    w_skip, with the biases and the sigma head; with the packed heads `hw`
    also W_f's and the merged W_1's planes, b_f, b_1, W_2 and b_2."""
    out = {k: packed[k].data_ptr() for k in ("b0", "b_mid", "b_skip",
                                            "w_sigma", "b_sigma")}
    planes = dict(PLANE_KEYS)
    if hw is not None:
        from .fused_trunk_heads import LAYER_HEAD_PLANE_KEYS
        out.update({k: hw[k].data_ptr() for k in ("bf", "b1", "w2", "b2")})
        planes.update(LAYER_HEAD_PLANE_KEYS)
    for k, kp in planes.items():
        w = packed if k in PLANE_KEYS else hw
        if split_operands(cfg):
            out[k], out[k + "_lo"] = (w[kp][0].data_ptr(),
                                      w[kp][1].data_ptr())
        else:
            out[k] = w[k].data_ptr()
    return out


def _launch(kernel: CudaKernel, kind: str, cfg: ModelConfig, packed: Dict,
            x: torch.Tensor, ptrs: Dict[str, int], dims: Dict[str, int],
            hw: Optional[Dict] = None, scratch_out: Optional[Dict] = None):
    """Allocate the scratch of `kind`, fill the two arrays and launch (a
    dict passed as scratch_out receives the scratch)."""
    n, e = x.shape
    block = point_block(kind, cfg, e, n)
    scratch = {k: torch.empty(shape, dtype=dt, device=x.device)
               for k, (shape, dt) in scratch_shapes(kind, cfg, e,
                                                   block).items()}
    ptrs = dict(ptrs, x=x.data_ptr(), **_weight_ptrs(cfg, packed, hw),
                **{k: v.data_ptr() for k, v in scratch.items()})
    dims = dict(dims, n=n, e=e, f=cfg.feat, layers=cfg.layers,
                skip=cfg.skips[0], split=int(split_operands(cfg)),
                block=block, wslices=wgrad_slices(cfg, block))
    p = (ctypes.c_longlong * len(PTRS))(*(ptrs.get(k, 0) for k in PTRS))
    d = (ctypes.c_int * len(DIMS))(*(dims.get(k, 0) for k in DIMS))
    kernel(p, d, torch.cuda.current_stream(x.device).cuda_stream,
           act=act_of(cfg))
    if scratch_out is not None:
        scratch_out.update(scratch, block=block)


def layers_sigma(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                 want_feats: bool):
    """K1: (sigma (n,), feats (n, F) f32 or None), as
    fused_mlp._trunk_sigma_plain."""
    check_kernel_inputs(cfg, packed, x)
    n, dev = x.shape[0], x.device
    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    feats = (torch.empty(n, cfg.feat, dtype=torch.float32, device=dev)
             if want_feats else None)
    _launch(TRUNK_SIGMA_WIDE, "K1", cfg, packed, x,
            {"sigma": sigma.data_ptr(),
             "feats": 0 if feats is None else feats.data_ptr()}, {})
    return sigma, feats


def layers_fwd_grad(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                    want_zs: bool = False):
    """K2: (sigma, feats (saved dtype), gx (n, E)), plus zs and us (n, L F)
    with want_zs, as fused_trunk_vjp._trunk_fwd_grad_plain."""
    from .fused_trunk_vjp import _saved_dtype
    check_kernel_inputs(cfg, packed, x)
    n, dev = x.shape[0], x.device
    sd = _saved_dtype(cfg)
    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    feats = torch.empty(n, cfg.feat, dtype=sd, device=dev)
    gx = torch.empty(n, x.shape[1], dtype=torch.float32, device=dev)
    zs = us = None
    if want_zs:
        zs = torch.empty(n, cfg.layers * cfg.feat, dtype=sd, device=dev)
        us = torch.empty_like(zs)
    _launch(TRUNK_FWD_GRAD_WIDE, "K2", cfg, packed, x,
            {"sigma": sigma.data_ptr(), "feats": feats.data_ptr(),
             "gx": gx.data_ptr(),
             "zs": 0 if zs is None else zs.data_ptr(),
             "us": 0 if us is None else us.data_ptr()},
            {"feats_f32": int(sd == torch.float32),
             "saved_f32": int(sd == torch.float32)})
    if want_zs:
        return sigma, feats, gx, zs, us
    return sigma, feats, gx


def layers_bwd(packed: Dict, cfg: ModelConfig, x, cs, cf, cg, zs, us):
    """K3: the packed weight grads of fused_trunk_vjp._trunk_bwd_plain in
    (in, out) layout: (dw0 (E, F), db0, dwm (L-2, F, F), dbm, dwst (E, F),
    dwsb (F, F), dbs, dwsig (F,), dbsig (1,))."""
    from .fused_trunk_vjp import check_bwd_inputs
    check_bwd_inputs(cfg, packed, x, cs, cf, cg, zs, us)
    e, f, layers, dev = x.shape[1], cfg.feat, cfg.layers, x.device

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    names = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
             "dbsig")
    outs = (f32(e, f), f32(f), f32(layers - 2, f, f), f32(layers - 2, f),
            f32(e, f), f32(f, f), f32(f), f32(f), f32(1))
    ptrs = {k: v.data_ptr() for k, v in zip(names, outs)}
    ptrs.update(cs=cs.data_ptr(), cf=cf.data_ptr(), cg=cg.data_ptr(),
                zs=zs.data_ptr(), us=us.data_ptr())
    _launch(TRUNK_BWD_WIDE, "K3", cfg, packed, x, ptrs,
            {"feats_f32": int(cf.dtype == torch.float32),
             "saved_f32": int(zs.dtype == torch.float32)})
    return outs


def layers_fwd_grad_heads(packed: Dict, hw: Dict, cfg: ModelConfig,
                          x: torch.Tensor, want_zs: bool = False):
    """K4: (packed logits (n, 8) f32, gx (n, E) f32, zs (n, L F) in the
    saved dtype with want_zs, else None), as
    fused_trunk_heads._trunk_heads_fwd_plain; it saves no us (K5 rebuilds
    the chain from zs)."""
    from .fused_trunk_heads import check_head_weights
    from .fused_trunk_vjp import _saved_dtype
    check_kernel_inputs(cfg, packed, x)
    check_head_weights(cfg, hw, x)
    n, dev = x.shape[0], x.device
    sd = _saved_dtype(cfg)
    out = torch.empty(n, HEAD_COLS, dtype=torch.float32, device=dev)
    gx = torch.empty(n, x.shape[1], dtype=torch.float32, device=dev)
    zs = (torch.empty(n, cfg.layers * cfg.feat, dtype=sd, device=dev)
          if want_zs else None)
    _launch(TRUNK_HEADS_FWD_WIDE, "K4", cfg, packed, x,
            {"out": out.data_ptr(), "gx": gx.data_ptr(),
             "zs": 0 if zs is None else zs.data_ptr()},
            {"saved_f32": int(sd == torch.float32)}, hw)
    return out, gx, zs


def layers_bwd_heads(packed: Dict, hw: Dict, cfg: ModelConfig, x, cot, cg,
                     zs, scratch_out: Optional[Dict] = None):
    """K5: the outputs of fused_trunk_heads._trunk_heads_bwd_plain (K3's
    nine trunk grads, then dwf (F, F), dbf, dw1r (F, H), db1r, dw2r (H,
    LANE), db2r (LANE,), dw1p (F, 3H), db1p, dw2p (3H, LANE), db2p, H = F /
    2) in (in, out) layout; dw2r / dw2p hold their three logit columns and
    zeros elsewhere.  A dict passed as scratch_out receives the kernel's
    scratch of its last point block ("uc", the b_th chain it rebuilt, reads
    as uchain_plain's rows of that block)."""
    from .fused_mlp import LANE
    from .fused_trunk_heads import check_bwd_h_inputs
    check_bwd_h_inputs(cfg, packed, hw, x, cot, cg, zs)
    e, f, layers, dev = x.shape[1], cfg.feat, cfg.layers, x.device
    h = f // 2

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    names = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
             "dbsig", "dwf", "dbf", "dw1", "dbw2", "db2")
    outs = (f32(e, f), f32(f), f32(layers - 2, f, f), f32(layers - 2, f),
            f32(e, f), f32(f, f), f32(f), f32(f), f32(1), f32(f, f), f32(f),
            f32(f, 4 * h), f32(4, 4 * h), f32(HEAD_COLS))
    ptrs = {k: v.data_ptr() for k, v in zip(names, outs)}
    ptrs.update(cot=cot.data_ptr(), cg=cg.data_ptr(), zs=zs.data_ptr())
    _launch(TRUNK_HEADS_BWD_WIDE, "K5", cfg, packed, x, ptrs,
            {"saved_f32": int(zs.dtype == torch.float32)}, hw, scratch_out)
    dwf, dbf, dw1, dbw2, db2 = outs[9:]
    # [db_1; dW_2] and the cotangents' sums in the twin's layout: dW_2's
    # three logit columns of every hidden unit, split at the rgb block
    dw2r = torch.zeros(h, LANE, dtype=torch.float32, device=dev)
    dw2p = torch.zeros(3 * h, LANE, dtype=torch.float32, device=dev)
    dw2r[:, :3] = dbw2[1:, :h].t()
    dw2p[:, :3] = dbw2[1:, h:].t()
    db2r = torch.zeros(LANE, dtype=torch.float32, device=dev)
    db2p = torch.zeros(LANE, dtype=torch.float32, device=dev)
    db2r[:3], db2p[:3] = db2[1:4], db2[4:7]
    return outs[:9] + (dwf, dbf, dw1[:, :h], dbw2[0, :h], dw2r, db2r,
                       dw1[:, h:], dbw2[0, h:], dw2p, db2p)
