"""The differentiated trunk: sigma, feats and g = d sigma / d x from one
kernel, and its hand-derived second-order VJP from another (counterpart of
the JAX package's ops/pallas_trunk_vjp.py).

    sigma(x), feats(x) = h_{L-1}(x),  g(x) = d sigma / d x_enc

g comes from the reverse chain seeded with softplus'(zsig) * w_sigma:
g_{L-1} = act'(z_{L-1}) * u, u_{i-1} = g_i W_i (the skip layer also sends
g_skip W_top to x_enc), g_x = g_0 W_0 + g_skip W_top.  The positional
encoding's Jacobian is chained outside the kernel:
d sigma / d xyz = (g_x * cos(m)) P^T, with m = xyz P + phase.

The backward differentiates S = <c_sigma, sigma> + <c_feats, feats>
+ <c_g, g>.  The g term is the tangent output of a JVP with input tangent
t = c_g, so a tangent forward (tz_l, th_l) turns the second-order VJP into a
first-order reverse sweep over the (primal, tangent) pairs:

    a_z  = act'(z) * a_h + act''(z) * tz * b_th     (cotangent on z)
    b_tz = act'(z) * b_th                           (cotangent on tz)
    dW  += h_prev^T a_z + th_prev^T b_tz,  db += sum_rows a_z
    a_h_prev = a_z W

The b_th states are the forward's u states, so the forward saves them (us)
with the pre-activations (zs) when gradients are wanted, and the backward
loads both instead of recomputing.

On a CUDA tensor `_run_fwd` launches kernel K2 (csrc/trunk_fwd_grad.cu) and
`_run_bwd` kernel K3 (csrc/trunk_bwd.cu); on a CPU tensor they run
`_trunk_fwd_grad_plain` and `_trunk_bwd_plain`, the plain twins of the
Pallas kernels' arithmetic.  `TrunkCore` is the autograd Function around the
pair.  At compute_dtype float32 the kernels run every product as three on
the bf16 terms of its f32 operands (fused_mlp.split3_mm);
`_trunk_fwd_grad_split` and `_trunk_bwd_split` are that arithmetic in plain
PyTorch, for the tests.  The activation (the polynomial or the exact sine,
or ReLU) is the configuration's in the twins (`_act_all`) and built into
the kernel library the wrappers launch (fused_mlp.act_of).  At a width
or an encoding the fused kernels do not take, K2 and K3 are the layer-major
family's (ops/trunk_layers.py); the entry points pack the weights at
fused_mlp.kernel_cfg's zero-padded width and slice the results back.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import Dict, List

import torch

from ..config import ModelConfig
from .cuda_build import CudaKernel
from .fast_math import (_C1, _C3, _C5, _C7, _C9, horner, needs_graph,
                        reduce_range)
from .fused_mlp import (FEAT, LANE, TILE_N, _round_up, act_of,
                        check_kernel_inputs, layer_major,
                        pack_at_kernel_width, pad_rows_lanes, row_tile,
                        pack_trunk_weights, split3_mm, split_operands,
                        trunk_weight_ptrs, unpad_feats, weight_dtype)

_P = ctypes.c_void_p
_I = ctypes.c_int
TRUNK_FWD_GRAD = CudaKernel(
    "trunk_fwd_grad", "trunk_fwd_grad_launch",
    [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
     _P, _I, _I, _I, _I, _P])
TRUNK_BWD = CudaKernel(
    "trunk_bwd", "trunk_bwd_launch",
    [_P, _P, _P, _I, _P, _P, _P, _I, _I] + [_P] * 12 + [_I, _I]
    + [_P] * 9 + [_I, _I, _I, _I, _P])
# the operand "dtype" of the split kernels' plain emulation: every product
# as fused_mlp.split3_mm
SPLIT3 = "split3"

# The weight-gradient kernel of K3 and K5 (csrc/trunk_bwd.cuh): output
# tiles of WGRAD_M x wgrad_n(F) (WGRAD_N at the widths from 256 up), the K
# axis (points) in chunks of WGRAD_CHUNK, cut into contiguous slices of
# whole chunks, one block per (slice, tile); an output of fewer than
# WGRAD_M rows (a width-64 layer's) takes one tile, its second half masked.
WGRAD_M, WGRAD_N, WGRAD_CHUNK = 128, 256, 64
# a block's fixed cost in chunks' worth of time, fitted to the split counts
# timed on the H100 (tools/bwd_variants.py, PERF.md): with it the model
# picks the fastest of those measured, 2 slices (one wave of 120 blocks)
# for K3 and (9, 5) for K5 at the training step's 131,072 points
WGRAD_TAIL = 48
# the float32 instantiation's cap on the chunks one accumulator sums: the
# tensor cores' f32 accumulation loses precision with the length of K, and
# K3's dW_0 at 131,072 points in slices of at most 128 chunks sits within
# 1e-5 of the f64 sum of its own products, where one slice of the whole K
# misses it by over 1e-3 (tools/f32_check.py --wgrad; PERF.md §6)
WGRAD_F32_CHUNKS = 128


def wgrad_n(feat: int = FEAT) -> int:
    """The output tiles' columns at trunk width `feat`."""
    return min(feat, WGRAD_N)


def wgrad_tiles(layers: int, heads: bool = False, feat: int = FEAT):
    """(trunk tiles, head tiles) of the weight-gradient products at trunk
    width `feat`: dW_0 and the skip layer's top part (LANE x F each), the
    other layers' F x F (the skip layer's bottom part among them); with the
    heads dW_f (F x F) and [dW_1r | dW_1p] (F x 4 HID)."""
    wn = wgrad_n(feat)
    per = lambda m, n: -(-m // WGRAD_M) * (n // wn)
    trunk = 2 * per(LANE, feat) + (layers - 1) * per(feat, feat)
    return trunk, (per(feat, feat) + per(feat, 2 * feat) if heads else 0)


def wgrad_slices(chunks: int, splits: int):
    """The [c0, c1) chunk range of every slice, as the kernel cuts it."""
    return [(s * chunks // splits, (s + 1) * chunks // splits)
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def wgrad_splits(n_rows: int, layers: int, heads: bool = False,
                 sms: int = 132, split: bool = False, feat: int = FEAT):
    """(splits of the trunk's K = 2 n, splits of the heads' K = n; 0
    without heads; with split each K three times as long, the three
    products of the hi and lo planes) that minimise the weight-gradient
    kernel's time in a model of whole waves: ceil(blocks / sms) waves, each
    as long as the longest slice plus WGRAD_TAIL.  Ties go to fewer blocks.
    With split, no slice of the trunk or the heads holds more than
    WGRAD_F32_CHUNKS chunks.  `feat`: the trunk width (wgrad_tiles)."""
    k = 3 if split else 1
    ct = k * 2 * n_rows // WGRAD_CHUNK
    ch = k * n_rows // WGRAD_CHUNK
    tt, th = wgrad_tiles(layers, heads, feat)
    least = -(-ct // WGRAD_F32_CHUNKS) if split else 1
    least_h = -(-ch // WGRAD_F32_CHUNKS) if split else 1
    best = None
    for st in range(least, min(ct, least + 63) + 1):
        for sh in (range(least_h, min(ch, least_h + 63) + 1) if heads
                   else (0,)):
            blocks = tt * st + th * sh
            longest = max(-(-ct // st), -(-ch // sh) if sh else 0)
            key = (-(-blocks // sms) * (longest + WGRAD_TAIL), blocks)
            if best is None or key < best[0]:
                best = (key, st, sh)
    return best[1], best[2]


def _act_all(z, w0: float, siren: bool, fast: bool, want_d2: bool = False):
    """(h, act'(z)) sharing one range reduction, plus act''(z) when
    want_d2 (pallas_trunk_vjp.py:82-103, same expression order)."""
    if not siren:
        out = (torch.clamp(z, min=0.0), (z > 0.0).to(z.dtype))
        return out + (torch.zeros_like(z),) if want_d2 else out
    x = w0 * z
    if not fast:
        sx = torch.sin(x)
        out = (sx, w0 * torch.cos(x))
        return out + (-(w0 * w0) * sx,) if want_d2 else out
    # the nested polynomials of the Pallas kernel, h = v (C1 + v2 (C3 + ...)),
    # act' = w0 (C1 + v2 (3 C3 + ... + v2 * 9 * C9)), act'' = w0^2 v (6 C3
    # + ... + v2 * 72 * C9), each in its order (fast_math.horner)
    v = reduce_range(x)
    v2 = v * v
    graph = needs_graph(v2)
    h = horner(v2, (_C1, _C3, _C5, _C7, _C9))
    h = v * h if graph else h.mul_(v)
    p1 = horner(v2, (_C1, 3 * _C3, 5 * _C5, 7 * _C7, _C9), scale=9)
    p1 = w0 * p1 if graph else p1.mul_(w0)
    if not want_d2:
        return h, p1
    d2 = horner(v2, (6 * _C3, 20 * _C5, 42 * _C7, _C9), scale=72)
    wv = (w0 * w0) * v
    return h, p1, (wv * d2 if graph else d2.mul_(wv))


def _mm(a, w, od):
    """a @ w.T with both operands rounded to od, f32 accumulation (od
    SPLIT3: split3_mm)."""
    if od == SPLIT3:
        return split3_mm(a, w.t())
    return a.to(od).float() @ w.to(od).float().t()


def _mm_t(a, w, od):
    """a @ w: the reverse products (w in (out, in) layout)."""
    if od == SPLIT3:
        return split3_mm(a, w)
    return a.to(od).float() @ w.to(od).float()


def _outer(a, b, od):
    """a.T @ b: (n, M), (n, N) -> (M, N), operands rounded to od."""
    if od == SPLIT3:
        return split3_mm(a.t(), b)
    return a.to(od).float().t() @ b.to(od).float()


def _vec_od(od):
    """The operand dtype of the sigma head's products (against w_sigma):
    the split kernels take them in f32 on the CUDA cores."""
    return torch.float32 if od == SPLIT3 else od


def _w0_of(i: int) -> float:
    return 30.0 if i == 0 else 1.0


def _saved_dtype(cfg: ModelConfig) -> torch.dtype:
    """zs/us (and feats) are stored in the activation-storage dtype: bf16
    under bfloat16_all, f32 otherwise (pallas_trunk_vjp.py:396-408)."""
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16_all"
            else torch.float32)


def saved_spec(cfg: ModelConfig, n: int):
    """(shape, dtype) of the zs / us the CUDA wrappers allocate (K2, K4)
    and take (K3, K5) for n rows: _saved_dtype's, as the twins save them."""
    return (n, cfg.layers * cfg.feat), _saved_dtype(cfg)


def _split_skip(packed: Dict):
    ein_p = packed["w0"].shape[1]
    return packed["w_skip"][:, :ein_p], packed["w_skip"][:, ein_p:]


def _forward_chain(packed: Dict, cfg: ModelConfig, x: torch.Tensor, od=None):
    """The Pallas _forward_chain: (h_{L-1} (n, F) f32, act'(z_l) and z_l of
    every layer, zsig (n,)).  od: the products' operand dtype (default
    weight_dtype(cfg); SPLIT3 the split kernels')."""
    od = weight_dtype(cfg) if od is None else od
    layers, skip = cfg.layers, cfg.skips[0]
    w_top, w_bot = _split_skip(packed)
    d1s, zs = [], []
    h = None
    mid = 0
    for i in range(layers):
        if i == 0:
            z = _mm(x, packed["w0"], od) + packed["b0"]
        elif i == skip:
            z = _mm(x, w_top, od) + _mm(h, w_bot, od) + packed["b_skip"]
        else:
            z = _mm(h, packed["w_mid"][mid], od) + packed["b_mid"][mid]
            mid += 1
        h, d1 = _act_all(z, _w0_of(i), cfg.siren, cfg.fast_sin)
        d1s.append(d1)
        zs.append(z)
    zsig = (_mm(h, packed["w_sigma"][None, :], _vec_od(od))[:, 0]
            + packed["b_sigma"])
    return h, d1s, zs, zsig


def _grad_chain(packed: Dict, cfg: ModelConfig, zsig, d1s, od=None):
    """The Pallas _grad_chain with collect: (gx (n, Ein_p), the chain state
    u_l seen at every layer l, before the act' multiply)."""
    od = weight_dtype(cfg) if od is None else od
    layers, skip = cfg.layers, cfg.skips[0]
    w_top, w_bot = _split_skip(packed)
    u = _mm_t(torch.sigmoid(zsig)[:, None], packed["w_sigma"][None, :],
              _vec_od(od))
    us = [None] * layers
    us[layers - 1] = u
    gx = None
    mid = layers - 3
    for i in range(layers - 1, -1, -1):
        g = d1s[i] * u
        if i == 0:
            c = _mm_t(g, packed["w0"], od)
            gx = c if gx is None else gx + c
        elif i == skip:
            c = _mm_t(g, w_top, od)
            gx = c if gx is None else gx + c
            u = _mm_t(g, w_bot, od)
            us[i - 1] = u
        else:
            u = _mm_t(g, packed["w_mid"][mid], od)
            us[i - 1] = u
            mid -= 1
    return gx, us


def _trunk_fwd_grad_plain(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                          want_zs: bool = False, od=None):
    """Plain twin of K2: the Pallas _forward_chain + _grad_chain, every
    product on operands cast to the compute dtype with f32 accumulation.
    Returns (sigma (n,), feats (n, F), gx (n, Ein_p)), plus zs and us
    (n, L*F) in the saved dtype with want_zs: the pre-activation z_i and
    the chain state u_i seen at layer i (before the act' multiply)."""
    h, d1s, zs, zsig = _forward_chain(packed, cfg, x, od)
    sigma = torch.logaddexp(zsig, torch.zeros_like(zsig))
    feats = h.to(_saved_dtype(cfg))
    gx, us = _grad_chain(packed, cfg, zsig, d1s, od)
    if not want_zs:
        return sigma, feats, gx
    sd = _saved_dtype(cfg)
    return (sigma, feats, gx, torch.cat(zs, 1).to(sd),
            torch.cat(us, 1).to(sd))


def _trunk_fwd_grad_split(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                          want_zs: bool = False):
    """K2's float32 arithmetic in plain PyTorch, for the tests: the twin
    with every trunk product as split3_mm and the sigma head in f32."""
    return _trunk_fwd_grad_plain(packed, cfg, x, want_zs, od=SPLIT3)


def _trunk_bwd_plain(packed: Dict, cfg: ModelConfig, x, cs, cf, cg, zs, us,
                     od=None):
    """Plain twin of K3, the Pallas _bwd_kernel (pallas_trunk_vjp.py:240-338)
    in the same expression order.  x, cg (n, Ein_p) f32, cs (n,) f32, cf
    (n, F), zs/us (n, L*F).  Returns the packed weight grads in (in, out)
    layout: (dw0 (Ein_p, F), db0 (F,), dwm (L-2, F, F), dbm (L-2, F),
    dwst (Ein_p, F), dwsb (F, F), dbs (F,), dwsig (F,), dbsig (1,))."""
    od = weight_dtype(cfg) if od is None else od
    vo = _vec_od(od)
    feat = cfg.feat
    wsig = packed["w_sigma"][None, :]
    hs, d1s, d2s, zsig, tzs, ths, tzsig = _bwd_primal_tangent(packed, cfg,
                                                              cg, zs, od)
    bths = [us[:, i * feat:(i + 1) * feat].float() for i in range(cfg.layers)]

    # head cotangents
    sp1 = torch.sigmoid(zsig)
    sp2 = sp1 * (1.0 - sp1)
    a_z = (cs * sp1 + sp2 * tzsig)[:, None]
    b_tz = sp1[:, None]
    dwsig = (_outer(hs[-1], a_z, vo) + _outer(ths[-1], b_tz, vo))[:, 0]
    dbsig = torch.sum(a_z, 0)
    a_h = _mm_t(a_z, wsig, vo) + cf.float()
    return _reverse_sweep(packed, cfg, x, cg, hs, d1s, d2s, tzs, ths, a_h,
                          bths=bths, od=od) + (dwsig, dbsig)


def _trunk_bwd_split(packed: Dict, cfg: ModelConfig, x, cs, cf, cg, zs, us):
    """K3's float32 arithmetic in plain PyTorch, for the tests: the twin
    with every trunk product as split3_mm and the sigma head in f32."""
    return _trunk_bwd_plain(packed, cfg, x, cs, cf, cg, zs, us, od=SPLIT3)


def _bwd_primal_tangent(packed: Dict, cfg: ModelConfig, cg, zs, od=None):
    """The backward kernels' prologue: h, act', act'' of every layer from
    the saved zs, zsig, and the tangent forward seeded by t = c_g (tz_l,
    th_l, tzsig)."""
    od = weight_dtype(cfg) if od is None else od
    layers, skip, feat = cfg.layers, cfg.skips[0], cfg.feat
    w_top, w_bot = _split_skip(packed)
    wsig = packed["w_sigma"][None, :]
    hs, d1s, d2s = [], [], []
    for i in range(layers):
        z = zs[:, i * feat:(i + 1) * feat].float()
        h, d1, d2 = _act_all(z, _w0_of(i), cfg.siren, cfg.fast_sin, True)
        hs.append(h)
        d1s.append(d1)
        d2s.append(d2)
    zsig = _mm(hs[-1], wsig, _vec_od(od))[:, 0] + packed["b_sigma"]

    # tangent forward, seeded by t = c_g
    tzs, ths = [], []
    th = None
    mid = 0
    for i in range(layers):
        if i == 0:
            tz = _mm(cg, packed["w0"], od)
        elif i == skip:
            tz = _mm(cg, w_top, od) + _mm(th, w_bot, od)
        else:
            tz = _mm(th, packed["w_mid"][mid], od)
            mid += 1
        th = d1s[i] * tz
        tzs.append(tz)
        ths.append(th)
    tzsig = _mm(th, wsig, _vec_od(od))[:, 0]
    return hs, d1s, d2s, zsig, tzs, ths, tzsig


def _reverse_sweep(packed: Dict, cfg: ModelConfig, x, cg, hs, d1s, d2s, tzs,
                   ths, a_h, bths=None, b_th=None, od=None):
    """The reverse sweep over the (primal, tangent) pairs, from the last
    layer's a_h.  The b_th states are `bths` where given (K3 loads them as
    us); otherwise they are rebuilt from the seed `b_th` as the chain runs,
    as the Pallas _bwd_kernel_h does.  Returns (dw0, db0, dwm, dbm, dwst,
    dwsb, dbs) in (in, out) layout."""
    od = weight_dtype(cfg) if od is None else od
    layers, skip = cfg.layers, cfg.skips[0]
    w_top, w_bot = _split_skip(packed)
    dwm: List = [None] * (layers - 2)
    dbm: List = [None] * (layers - 2)
    mid = layers - 3
    for i in range(layers - 1, -1, -1):
        if bths is not None:
            b_th = bths[i]
        a_zl = d1s[i] * a_h + d2s[i] * tzs[i] * b_th
        b_tzl = d1s[i] * b_th
        if i == 0:
            dw0 = _outer(x, a_zl, od) + _outer(cg, b_tzl, od)
            db0 = torch.sum(a_zl, 0)
        elif i == skip:
            dwst = _outer(x, a_zl, od) + _outer(cg, b_tzl, od)
            dwsb = _outer(hs[i - 1], a_zl, od) + _outer(ths[i - 1], b_tzl, od)
            dbs = torch.sum(a_zl, 0)
            a_h = _mm_t(a_zl, w_bot, od)
            if bths is None:
                b_th = _mm_t(b_tzl, w_bot, od)
        else:
            dwm[mid] = (_outer(hs[i - 1], a_zl, od)
                        + _outer(ths[i - 1], b_tzl, od))
            dbm[mid] = torch.sum(a_zl, 0)
            a_h = _mm_t(a_zl, packed["w_mid"][mid], od)
            if bths is None:
                b_th = _mm_t(b_tzl, packed["w_mid"][mid], od)
            mid -= 1
    return (dw0, db0, torch.stack(dwm), torch.stack(dbm), dwst, dwsb, dbs)


def _trunk_fwd_grad_cuda(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                         want_zs: bool = False):
    if layer_major(cfg):
        from .trunk_layers import layers_fwd_grad
        return layers_fwd_grad(packed, cfg, x, want_zs)
    check_kernel_inputs(cfg, packed, x)
    n = x.shape[0]
    dev = x.device
    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    feats = torch.empty(n, cfg.feat, device=dev, dtype=_saved_dtype(cfg))
    gx = torch.empty(n, LANE, dtype=torch.float32, device=dev)
    zs = us = None
    if want_zs:
        shape, dt = saved_spec(cfg, n)
        zs = torch.empty(shape, dtype=dt, device=dev)
        us = torch.empty_like(zs)
    n_blocks, scratch = fwd_scratch(n, cfg.layers, False, dev, cfg.feat)
    w0, w_mid, w_skip = trunk_weight_ptrs(cfg, packed)
    TRUNK_FWD_GRAD(
        x.data_ptr(), n, n_blocks, w0, packed["b0"].data_ptr(), w_mid,
        packed["b_mid"].data_ptr(), w_skip, packed["b_skip"].data_ptr(),
        packed["w_sigma"].data_ptr(), packed["b_sigma"].data_ptr(),
        sigma.data_ptr(), feats.data_ptr(),
        int(feats.dtype == torch.bfloat16), gx.data_ptr(),
        scratch.data_ptr(), None if zs is None else zs.data_ptr(),
        None if us is None else us.data_ptr(),
        int(zs is not None and zs.dtype == torch.float32),
        int(split_operands(cfg)), cfg.layers, cfg.skips[0],
        torch.cuda.current_stream(dev).cuda_stream, act=act_of(cfg),
        feat=cfg.feat)
    if want_zs:
        return sigma, feats, gx, zs, us
    return sigma, feats, gx


def fwd_plan(n_rows: int, layers: int, heads: bool, sms: int = 132,
             feat: int = FEAT):
    """(blocks, f32 scratch elements) of the forward kernel K2 (heads=False)
    or K4 at n_rows points and trunk width `feat`: a persistent grid of one
    block per SM, at most one per 64-point tile; each block keeps act'(z)
    of every layer its reverse chain reads (K2 layers 0..L-2, K4 0..L-1)
    for its current tile, TILE_N x feat f32 a layer, in the accumulator
    layout (csrc/trunk_fwd_grad.cuh)."""
    n_blocks = min(n_rows // TILE_N, sms)
    slots = layers if heads else layers - 1
    return n_blocks, n_blocks * slots * TILE_N * feat


def fwd_scratch(n_rows: int, layers: int, heads: bool, dev,
                feat: int = FEAT):
    """(blocks, scratch tensor) of fwd_plan on `dev`."""
    n_blocks, elems = fwd_plan(
        n_rows, layers, heads,
        torch.cuda.get_device_properties(dev).multi_processor_count, feat)
    return n_blocks, torch.empty(elems, dtype=torch.float32, device=dev)


def check_bwd_inputs(cfg: ModelConfig, packed: Dict, x, cs, cf, cg, zs, us):
    """What K3 takes; anything else raises.  zs/us as saved_spec."""
    check_kernel_inputs(cfg, packed, x)
    n = x.shape[0]
    zshape, zdt = saved_spec(cfg, n)
    want = {"cs": (cs, (n,), (torch.float32,)),
            "cf": (cf, (n, cfg.feat), (torch.bfloat16, torch.float32)),
            "cg": (cg, (n, x.shape[1]), (torch.float32,)),
            "zs": (zs, zshape, (zdt,)),
            "us": (us, zshape, (zdt,))}
    for k, (v, shape, dts) in want.items():
        if not (v.device == x.device and v.is_contiguous()
                and tuple(v.shape) == shape and v.dtype in dts):
            raise ValueError(f"{k} must be a contiguous {dts} tensor {shape} "
                             f"on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def wgrad_scratch(n: int, layers: int, heads: bool, dev, split=False,
                  feat: int = FEAT):
    """(splits of the trunk, of the heads, the partial tiles' scratch) of
    the weight-gradient kernel for n rows at trunk width `feat` on `dev`
    (split: the float32 instantiation's K axis, three times as long)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    st, sh = wgrad_splits(n, layers, heads, sms, split, feat)
    tt, th = wgrad_tiles(layers, heads, feat)
    wpart = torch.empty(tt * st + th * sh, WGRAD_M * wgrad_n(feat),
                        dtype=torch.float32, device=dev)
    return st, sh, wpart


def _trunk_bwd_cuda(packed: Dict, cfg: ModelConfig, x, cs, cf, cg, zs, us,
                    scratch_out=None):
    """K3: the outputs of _trunk_bwd_plain.  A dict passed as scratch_out
    receives the fused kernel's scratch (for checks of its intermediates;
    the layer-major K3 keeps none)."""
    if layer_major(cfg):
        if scratch_out is not None:
            raise ValueError("the layer-major K3 keeps no scratch to show")
        from .trunk_layers import layers_bwd
        return layers_bwd(packed, cfg, x, cs, cf, cg, zs, us)
    check_bwd_inputs(cfg, packed, x, cs, cf, cg, zs, us)
    n, dev = x.shape[0], x.device
    layers, F = cfg.layers, cfg.feat

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    def bf(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device=dev)

    n_tiles = n // TILE_N
    n_blocks = min(n_tiles,
                   torch.cuda.get_device_properties(dev).multi_processor_count)
    split = split_operands(cfg)
    # scratch: the bf16 operands of every layer's weight-gradient product
    # (x|t, h_prev|th_prev, a_z|b_tz; at float32 those planes' hi terms,
    # then their lo terms), per-tile column sums of a_z and the sigma
    # head's partial grads, each block's tangent pre-activations, and the
    # weight-gradient blocks' partial tiles
    pl = 4 if split else 2
    xt, hth, azbtz = (bf(pl, n, LANE), bf(layers - 1, pl, n, F),
                      bf(layers, pl, n, F))
    part, part_bs = f32(n_tiles, layers + 1, F), f32(n_tiles)
    tzs = f32(n_blocks, layers, TILE_N * F)
    splits, _, wpart = wgrad_scratch(n, layers, False, dev, split, F)
    w0, w_mid, w_skip = trunk_weight_ptrs(cfg, packed)
    outs = (f32(LANE, F), f32(F), f32(layers - 2, F, F), f32(layers - 2, F),
            f32(LANE, F), f32(F, F), f32(F), f32(F), f32(1))
    TRUNK_BWD(
        x.data_ptr(), cs.data_ptr(), cf.data_ptr(),
        int(cf.dtype == torch.bfloat16), cg.data_ptr(), zs.data_ptr(),
        us.data_ptr(), n, n_blocks, w0, w_mid, w_skip,
        packed["w_sigma"].data_ptr(), packed["b_sigma"].data_ptr(),
        xt.data_ptr(), hth.data_ptr(), azbtz.data_ptr(), part.data_ptr(),
        part_bs.data_ptr(), tzs.data_ptr(), wpart.data_ptr(), splits,
        wpart.shape[0], *(o.data_ptr() for o in outs),
        int(zs.dtype == torch.float32), int(split), layers, cfg.skips[0],
        torch.cuda.current_stream(dev).cuda_stream, act=act_of(cfg),
        feat=F)
    if scratch_out is not None:
        scratch_out.update(xt=xt, hth=hth, azbtz=azbtz, part=part,
                           pbs=part_bs)
    return outs


def _run_fwd(cfg: ModelConfig, packed: Dict, x_enc: torch.Tensor,
             want_zs: bool = False):
    """(sigma (n,), feats (n, F), gx (n, Ein_p)) of encoded points; gx keeps
    the padded lane width, whose extra lanes are exactly 0.  With want_zs
    also zs and us, padded to the kernel's row count like the JAX
    package's.  cfg is a kernel configuration (fused_mlp.kernel_cfg): F is
    its width and rows are padded to its row_tile."""
    n, rows = x_enc.shape[0], row_tile(cfg)
    x = pad_rows_lanes(x_enc, _round_up(max(n, rows), rows),
                       packed["w0"].shape[1])
    if x.device.type == "cpu":
        out = _trunk_fwd_grad_plain(packed, cfg, x, want_zs)
    else:
        out = _trunk_fwd_grad_cuda(packed, cfg, x, want_zs)
    return tuple(v[:n] for v in out[:3]) + tuple(out[3:])


def _run_bwd(cfg: ModelConfig, packed: Dict, x_enc, c_sigma, c_feats, c_g,
             zs, us):
    """The packed weight grads of S (see the module docstring) from the
    saved zs/us; rows are padded to zs's row count with zero cotangents,
    which contribute exactly 0."""
    n_p = zs.shape[0]
    ein_p = packed["w0"].shape[1]
    x = pad_rows_lanes(x_enc, n_p, ein_p)
    cg = pad_rows_lanes(c_g, n_p, ein_p)
    n = c_sigma.shape[0]
    cs = torch.zeros(n_p, dtype=torch.float32, device=x.device)
    cs[:n] = c_sigma
    cf = torch.zeros(n_p, cfg.feat, dtype=c_feats.dtype, device=x.device)
    cf[:n, :c_feats.shape[1]] = c_feats
    if x.device.type == "cpu":
        return _trunk_bwd_plain(packed, cfg, x, cs, cf, cg, zs, us)
    return _trunk_bwd_cuda(packed, cfg, x, cs, cf, cg, zs, us)


def _unpack_grads(cfg: ModelConfig, ein: int, outs) -> List[torch.Tensor]:
    """Packed (in, out) grads -> the grads of trunk_params(net), in the
    port's (out, in) Dense layout: [w, b] of every fc_net layer, then the
    sigma head's w (1, F) and b (1,), at cfg's width F (the grads of a
    zero-padded packing are sliced to it)."""
    (dw0, db0, dwm, dbm, dwst, dwsb, dbs, dwsig, dbsig) = outs
    f = cfg.feat
    grads: List[torch.Tensor] = []
    mid = 0
    for i in range(cfg.layers):
        if i == 0:
            grads += [dw0[:ein, :f].t(), db0[:f]]
        elif i == cfg.skips[0]:
            grads += [torch.cat([dwst[:ein, :f], dwsb[:f, :f]], 0).t(),
                      dbs[:f]]
        else:
            grads += [dwm[mid, :f, :f].t(), dbm[mid, :f]]
            mid += 1
    return grads + [dwsig[None, :f], dbsig]


def trunk_params(net) -> List[torch.Tensor]:
    """The parameters the fused trunk reads: [w, b] of every fc_net layer,
    then the sigma head's [w, b]."""
    out: List[torch.Tensor] = []
    for layer in list(net["fc_net"]) + [net["sigma_from_xyz"][0]]:
        out += [layer.w, layer.b]
    return out


def _params_view(params):
    """The network view pack_trunk_weights reads, of the flat trunk_params
    list."""
    layers = [SimpleNamespace(w=params[2 * i], b=params[2 * i + 1])
              for i in range(len(params) // 2)]
    return {"fc_net": layers[:-1], "sigma_from_xyz": layers[-1:]}


def _pack_params(cfg: ModelConfig, params) -> Dict[str, torch.Tensor]:
    """pack_trunk_weights from the flat trunk_params list."""
    return pack_trunk_weights(_params_view(params), cfg, weight_dtype(cfg))


class TrunkCore(torch.autograd.Function):
    """(sigma, feats, d sigma / d x_enc) with the hand-derived second-order
    VJP: the forward runs K2 saving zs/us, the backward runs K3, both at
    fused_mlp.kernel_cfg's width (feats and the grads sliced back to
    cfg's).  x_enc carries no gradient (ray points are constants); like
    the JAX package's _trunk_core_bwd, its grad is zeros."""

    @staticmethod
    def forward(ctx, cfg: ModelConfig, x_enc: torch.Tensor, *params):
        kcfg, packed = pack_at_kernel_width(_params_view(params), cfg)
        sigma, feats, gx, zs, us = _run_fwd(kcfg, packed, x_enc,
                                            want_zs=True)
        ctx.cfg, ctx.kcfg, ctx.packed, ctx.zs, ctx.us = (cfg, kcfg, packed,
                                                         zs, us)
        ctx.save_for_backward(x_enc)
        ctx.ein = params[0].shape[1]
        ctx.set_materialize_grads(False)
        return sigma, unpad_feats(cfg, feats), gx

    @staticmethod
    def backward(ctx, c_sigma, c_feats, c_g):
        (x,) = ctx.saved_tensors
        n, dev = x.shape[0], x.device
        if c_sigma is None:
            c_sigma = torch.zeros(n, dtype=torch.float32, device=dev)
        if c_feats is None:
            c_feats = torch.zeros(n, ctx.cfg.feat, device=dev,
                                  dtype=_saved_dtype(ctx.cfg))
        if c_g is None:
            c_g = torch.zeros(n, ctx.packed["w0"].shape[1],
                              dtype=torch.float32, device=dev)
        outs = _run_bwd(ctx.kcfg, ctx.packed, x, c_sigma.float(),
                        c_feats.contiguous(), c_g.float(), ctx.zs, ctx.us)
        grads = _unpack_grads(ctx.cfg, ctx.ein, outs)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return (None, dx, *grads)


def trunk_core(net, cfg: ModelConfig, x_enc: torch.Tensor):
    """(sigma, feats, d sigma / d x_enc) of the trunk at encoded points.
    x_enc carries no gradient.  Where autograd records and a trunk
    parameter requires grad, this goes through TrunkCore (K2 saving zs/us,
    then K3 in the backward); otherwise K2 alone, saving nothing."""
    params = trunk_params(net)
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return TrunkCore.apply(cfg, x_enc.detach(), *params)
    kcfg, packed = pack_at_kernel_width(net, cfg)
    sigma, feats, gx = _run_fwd(kcfg, packed, x_enc.detach())
    return sigma, unpad_feats(cfg, feats), gx


def fused_trunk_with_grad(net, cfg: ModelConfig, xyz: torch.Tensor):
    """Drop-in for the trunk part of apply_network_with_normals: returns
    (sigma, feats, d sigma / d xyz), the encoding's Jacobian chained here at
    the kernel's padded width (the padded lanes of the encoding are
    sin(0) = 0 and their P columns are zero)."""
    enc, chain = encode_with_jacobian(cfg, xyz)
    sigma, feats, gx_enc = trunk_core(net, cfg, enc)
    return sigma, feats, chain(gx_enc)


def encode_with_jacobian(cfg: ModelConfig, xyz: torch.Tensor):
    """(the kernels' input at the padded lane width, the function taking
    d/d x_enc to d/d xyz through the encoding's Jacobian)."""
    if not cfg.mapping:
        return xyz, lambda gx_enc: gx_enc[:, :xyz.shape[-1]]
    from .encoding import _phase_arg, _phase_tensors
    n_freqs, c = cfg.mapping_sizes[0], xyz.shape[-1]
    ein_p = _round_up(2 * n_freqs * c, LANE)
    m = _phase_arg(xyz, n_freqs, pad_to=ein_p)
    enc, cos_m = _act_all(m, 1.0, siren=True, fast=cfg.fast_sin)

    def chain(gx_enc):
        # (gx_enc * cos m) @ P^T, exactly: each column of P holds one power
        # of two, for channel (j mod 2C) mod C of band j // 2C; P's column
        # maxima already on the device (_phase_tensors)
        scale = _phase_tensors(n_freqs, c, ein_p, torch.float32,
                               xyz.device)[1][:2 * n_freqs * c]
        t = (gx_enc * cos_m)[:, :2 * n_freqs * c] * scale
        return t.reshape(-1, 2 * n_freqs, c).sum(1)
    return enc, chain
