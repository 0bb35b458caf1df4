"""The flagship head block inside the differentiated trunk's kernel pair
(counterpart of the JAX package's ops/pallas_trunk_heads.py).

For the flagship head set (RPV(111) at dim_rpv 1, rgb on the trunk
features alone, analytic normals, no sun_v / sky / beta heads) the forward
kernel K4 runs K2's trunk and dsigma/dx chain and then the heads

    xf  = h W_f^T + b_f                    feats_from_xyz, no activation
    hr  = act(xf W_1r^T + b_1r)            rgb hidden
    z2r = hr W_2r^T + b_2r                 3 rgb logits
    hp  = act(xf W_1p^T + b_1p)            merged k | theta | rhoc hidden
    z2p = hp W_2p^T + b_2p                 block-diagonal, 3 logits

on the tile it holds, and emits logits packed as (n, 8) f32 columns
[softplus sigma, rgb x3, k, theta, rhoc, 0] with gx; the features never
reach device memory.  The sigmoid and the RPV rescalings run in torch on
the packed columns (fused_trunk_heads_with_grad), so their backward hands
the backward kernel K5 the logits' cotangents in the same layout.  K5
recomputes the head block from the saved zs, runs its first-order backward
(the head weights' grads and a_h += a_xf W_f, the seed of the trunk's
sweep), then K3's second-order sweep.

On a CUDA tensor `_run_fwd_h` launches K4 and `_run_bwd_h` K5: at the
widths 64..512 with at most 128 encoding lanes the fused pair
(csrc/trunk_heads_fwd.cu, csrc/trunk_heads_bwd.cu), at every other width
and encoding the layer-major pair (ops/trunk_layers.py: K4 and K5 in
csrc/trunk_layers.cu), as fused_mlp.kernel_cfg picks the trunk's family;
on a CPU tensor they run `_trunk_heads_fwd_plain` and
`_trunk_heads_bwd_plain`, the Pallas kernels' arithmetic.  The entry points
pack the trunk and the heads at kernel_cfg's width, zero-padded (a width
under 512 at the next built one, any other at the next multiple of 128):
each head's HID = F / 2 hidden units sit at the start of its own HID_p =
F_p / 2 block, so that a padded hidden unit has z = 0, act(0) = 0 and
gives nothing, and every padded gradient entry is 0
(`_unpack_head_grads` slices them away).  Like the Pallas pair, the
forward saves zs only and the backward rebuilds the u chain (b_th) from zs
in f32 (`uchain_plain`; the fused K5 in a kernel of its own before K3's
sweep, `uchain_from_kernel` reads its layout; the layer-major K5 with
K2's chain products over each point block).  At compute_dtype float32 the
kernels run every product of f32 operands as three on their bf16 hi and
lo terms, the head weights W_f, W_1r and W_1p packed as hi and lo planes
(`HEAD_PLANE_KEYS`; the layer-major pair reads W_f and the merged W_1 =
[W_1r | W_1p], `LAYER_HEAD_PLANE_KEYS`) and the 3-row second layers read
in f32; `_trunk_heads_fwd_split` and `_trunk_heads_bwd_split` are that
arithmetic in plain PyTorch, for the tests.  The activation is the
configuration's, as in the trunk (fused_mlp.act_of).

The path is opt-in, as in the JAX package: models.network reads
BRDFNERF_FUSED_HEADS.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from ..config import ModelConfig
from .cuda_build import CudaKernel
from .fused_mlp import (FEAT, LANE, TILE_N, _round_up, act_of,
                        check_kernel_inputs, kernel_cfg, kernel_supports,
                        layer_major, pack_at_kernel_width,
                        pad_rows_lanes, row_tile,
                        split_operands, split_planes, trunk_weight_ptrs,
                        weight_dtype)
from .fused_trunk_vjp import (SPLIT3, _act_all, _bwd_primal_tangent,
                              _forward_chain, _grad_chain, _mm, _mm_t,
                              _outer, _params_view, _reverse_sweep,
                              _saved_dtype, _split_skip, _unpack_grads,
                              _vec_od, encode_with_jacobian, fwd_scratch,
                              saved_spec, trunk_params, wgrad_scratch)

HEAD_COLS = 8       # packed logits: sigma, rgb x3, k, theta, rhoc, pad
RPV_NAMES = ("k_from_xyz", "theta_rpv_from_xyz", "rhoc_from_xyz")
HEAD_NAMES = ("feats_from_xyz", "rgb_from_xyzdir") + RPV_NAMES
# the head weights K4 and K5 stream through tensor cores, and the key of
# their hi/lo planes (at float32, as fused_mlp.PLANE_KEYS for the trunk)
HEAD_PLANE_KEYS = {"wf": "wf_planes", "w1r": "w1r_planes",
                   "w1p": "w1p_planes"}
# ... and those of the layer-major pair, which reads the merged first layers
LAYER_HEAD_PLANE_KEYS = {"wf": "wf_planes", "w1": "w1_planes"}
# the logits after sigma: rgb x3, k, theta, rhoc
LOGITS = 6

_P = ctypes.c_void_p
_I = ctypes.c_int
TRUNK_HEADS_FWD = CudaKernel(
    "trunk_heads_fwd", "trunk_heads_fwd_launch",
    [_P, _I, _I] + [_P] * 8 + [_P] * 10 + [_P] * 4 + [_I, _I, _I, _I, _P])
TRUNK_HEADS_BWD = CudaKernel(
    "trunk_heads_bwd", "trunk_heads_bwd_launch",
    [_P] * 5 + [_I, _I] + [_P] * 5 + [_P] * 8 + [_P] * 7 + [_I, _I, _I]
    + [_P] * 4 + [_P] * 17 + [_I, _I, _I, _I, _P])


def heads_kernel_supports(cfg: ModelConfig, net, dirs=None, t_emb=None,
                          apply_brdf: bool = False, apply_theta: bool = False,
                          nr_lr: bool = False) -> bool:
    """True when the head set is exactly the flagship's: RPV(111) at
    dim_rpv 1, rgb on the features alone (no view dirs), analytic-only
    normals, no sun_v / sky heads (pallas_trunk_heads.py:73-102), at
    every compute dtype the trunk kernels take."""
    if not (kernel_supports(cfg) and apply_brdf and not apply_theta
            and cfg.rpv and cfg.func_m and cfg.func_f and cfg.func_h == 1
            and cfg.dim_rpv == 1 and not nr_lr
            and dirs is None and t_emb is None
            and "sun_v_net" not in net and "sky_color" not in net):
        return False
    feat, hid = cfg.feat, cfg.feat // 2
    try:
        return (len(net["feats_from_xyz"]) == 1
                and tuple(net["feats_from_xyz"][0].w.shape) == (feat, feat)
                and len(net["rgb_from_xyzdir"]) == 2
                and tuple(net["rgb_from_xyzdir"][0].w.shape) == (hid, feat)
                and tuple(net["rgb_from_xyzdir"][1].w.shape) == (3, hid)
                and all(len(net[n]) == 2
                        and tuple(net[n][0].w.shape) == (hid, feat)
                        and tuple(net[n][1].w.shape) == (1, hid)
                        for n in RPV_NAMES))
    except (KeyError, IndexError, AttributeError):
        return False


def head_plane_keys(cfg: ModelConfig) -> Dict[str, str]:
    """The head weights a kernel configuration's pair streams through
    tensor cores, and the keys of their hi/lo planes at float32: the fused
    pair's HEAD_PLANE_KEYS or the layer-major pair's
    LAYER_HEAD_PLANE_KEYS."""
    return LAYER_HEAD_PLANE_KEYS if layer_major(cfg) else HEAD_PLANE_KEYS


def head_part(feat: int) -> int:
    """The per-tile partial sums K5 keeps for the heads beside K3's at
    trunk width `feat` (HID = feat / 2): db_f, db_1 (rgb | rpv), dW_2 for
    each of 3 logit columns over the 4 HID hidden units, db_2 (6, padded
    to 8); the layout of csrc/trunk_bwd.cuh HEAD_PART."""
    hid = feat // 2
    return feat + 4 * hid + 3 * 4 * hid + 8


def head_part_grads(part: torch.Tensor, layers: int, feat: int):
    """The heads' bias and second-layer grads K5's reduce kernel makes of
    its per-tile partials `part` (n_tiles, (layers + 1) F + head_part(F))
    f32, in plain PyTorch: the head columns summed over the tiles and laid
    out as csrc/trunk_bwd.cuh's reduce kernel writes them, (dbf (F,), db1
    (4 HID,) = [db_1r | db_1p], dw2r (HID, LANE), db2r (LANE,), dw2p
    (3 HID, LANE), db2p (LANE,)), the columns past the 3 logits zero."""
    hid = feat // 2
    s = part[:, (layers + 1) * feat:].sum(0)
    dbf, db1 = s[:feat], s[feat:feat + 4 * hid]
    # dW_2: logit column c of hidden unit k at c * 4 HID + k
    dw2 = s[feat + 4 * hid:feat + 16 * hid].view(3, 4 * hid).t()
    db2 = s[feat + 16 * hid:feat + 16 * hid + 6]

    def z(*shape):
        return torch.zeros(*shape, dtype=s.dtype, device=s.device)
    dw2r, dw2p, db2r, db2p = z(hid, LANE), z(3 * hid, LANE), z(LANE), z(LANE)
    dw2r[:, :3], dw2p[:, :3] = dw2[:hid], dw2[hid:]
    db2r[:3], db2p[:3] = db2[:3], db2[3:]
    return dbf, db1, dw2r, db2r, dw2p, db2p


def pack_head_weights(net, cfg: ModelConfig, dtype: torch.dtype,
                      planes: Optional[bool] = None
                      ) -> Dict[str, torch.Tensor]:
    """The flagship head set as padded matrices in (out, in) layout at the
    width F = cfg.feat (kernel_cfg's; the heads' own width, and their HID =
    F / 2, are their weights'), H = F / 2 (pallas_trunk_heads.py:105-137,
    transposed): wf (F, F), w1r (H, F), w2r (LANE, H) with rows 0..2 real,
    w1p (3H, F) = [k | theta | rhoc], w2p (LANE, 3H) block-diagonal (row i
    holds head i's second layer in columns [iH, (i+1)H)); each head's
    hidden units at the start of its H-wide block, the rest of every row
    and column zeros; weights in `dtype`, biases f32 padded alike.  w1r
    and w1p are the two row blocks of w1 = [w1r; w1p] (4H, F) (b1 alike),
    which the layer-major pair multiplies as one product; at a layer-major
    width also w2 (6, 4H) f32, the six second-layer rows over the merged
    hidden units (the rgb logits over the rgb block, the RPV logits over
    theirs), and b2 (6,).  With `planes` (by default: f32 weights on a
    CUDA device, as fused_mlp.pack_trunk_weights) also the split_planes of
    the weights head_plane_keys(cfg) names."""
    f32 = torch.float32
    wf = net["feats_from_xyz"][0]
    r1, r2 = net["rgb_from_xyzdir"]
    p1s = [net[n][0] for n in RPV_NAMES]
    p2s = [net[n][1] for n in RPV_NAMES]
    feat, hid = wf.w.shape[1], r1.w.shape[0]
    fp, hp = cfg.feat, cfg.feat // 2
    if fp < feat or hp < hid:
        raise ValueError(f"heads of width {feat} packed at {fp}")
    dev = wf.w.device

    def z(*shape, dt=dtype):
        return torch.zeros(*shape, dtype=dt, device=dev)
    w1, b1 = z(4 * hp, fp), z(4 * hp, dt=f32)
    w1[:hid, :feat] = r1.w.detach().to(dtype)
    b1[:hid] = r1.b.detach().float()
    w2r, b2r = z(LANE, hp), z(LANE, dt=f32)
    w2r[:3, :hid] = r2.w.detach().to(dtype)
    b2r[:3] = r2.b.detach().float()
    w2p, b2p = z(LANE, 3 * hp), z(LANE, dt=f32)
    for i, (p1, p2) in enumerate(zip(p1s, p2s)):
        k = (i + 1) * hp
        w1[k:k + hid, :feat] = p1.w.detach().to(dtype)
        b1[k:k + hid] = p1.b.detach().float()
        w2p[i, i * hp:i * hp + hid] = p2.w.detach()[0].to(dtype)
        b2p[i] = p2.b.detach()[0].float()
    wfp, bfp = z(fp, fp), z(fp, dt=f32)
    wfp[:feat, :feat] = wf.w.detach().to(dtype)
    bfp[:feat] = wf.b.detach().float()
    hw = {"wf": wfp, "bf": bfp, "w1": w1, "b1": b1,
          "w1r": w1[:hp], "b1r": b1[:hp], "w2r": w2r, "b2r": b2r,
          "w1p": w1[hp:], "b1p": b1[hp:], "w2p": w2p, "b2p": b2p}
    if layer_major(cfg):
        w2 = z(LOGITS, 4 * hp, dt=f32)
        w2[:3, :hp] = w2r[:3].float()
        w2[3:, hp:] = w2p[:3].float()
        hw["w2"] = w2
        hw["b2"] = torch.cat([b2r[:3], b2p[:3]])
    if planes is None:
        planes = dtype == torch.float32 and dev.type == "cuda"
    if planes:
        for k, kp in head_plane_keys(cfg).items():
            hw[kp] = split_planes(hw[k])
    return hw


def _head_forward(h, hw: Dict, od, cfg: ModelConfig):
    """xf, (hr, act'), z2r, (hp, act'), z2p from the trunk output h
    (pallas_trunk_heads.py:140-149); the 3-row second layers' products in
    _vec_od(od) (the split kernels take them in f32 on the CUDA cores)."""
    vo = _vec_od(od)
    xf = _mm(h, hw["wf"], od) + hw["bf"]
    z1r = _mm(xf, hw["w1r"], od) + hw["b1r"]
    hr, d1r = _act_all(z1r, 1.0, cfg.siren, cfg.fast_sin)
    z2r = _mm(hr, hw["w2r"], vo) + hw["b2r"]
    z1p = _mm(xf, hw["w1p"], od) + hw["b1p"]
    hp, d1p = _act_all(z1p, 1.0, cfg.siren, cfg.fast_sin)
    z2p = _mm(hp, hw["w2p"], vo) + hw["b2p"]
    return xf, hr, d1r, z2r, hp, d1p, z2p


# ------------------------------------------------------------ the twins

def _trunk_heads_fwd_plain(packed: Dict, hw: Dict, cfg: ModelConfig, x,
                           want_zs: bool = False, od=None):
    """Plain twin of K4, the Pallas _fwd_kernel_h (pallas_trunk_heads.py:
    154-180): (packed logits (n, 8), gx (n, Ein_p), zs (n, L*F) in the saved
    dtype with want_zs, else None).  od: the products' operand dtype
    (default weight_dtype(cfg); SPLIT3 the split kernels')."""
    od = weight_dtype(cfg) if od is None else od
    h, d1s, zs, zsig = _forward_chain(packed, cfg, x, od)
    _, _, _, z2r, _, _, z2p = _head_forward(h, hw, od, cfg)
    out = torch.cat([torch.logaddexp(zsig, torch.zeros_like(zsig))[:, None],
                     z2r[:, 0:3], z2p[:, 0:3], torch.zeros_like(zsig)[:, None]],
                    1)
    gx, _ = _grad_chain(packed, cfg, zsig, d1s, od)
    zs = torch.cat(zs, 1).to(_saved_dtype(cfg)) if want_zs else None
    return out, gx, zs


def _trunk_heads_fwd_split(packed: Dict, hw: Dict, cfg: ModelConfig, x,
                           want_zs: bool = False):
    """K4's float32 arithmetic in plain PyTorch, for the tests: the twin
    with every trunk and head product of f32 operands as split3_mm, the
    sigma head and the heads' second layers in f32."""
    return _trunk_heads_fwd_plain(packed, hw, cfg, x, want_zs, od=SPLIT3)


def uchain_plain(packed: Dict, cfg: ModelConfig, zs, od=None) -> torch.Tensor:
    """The b_th chain the Pallas _bwd_kernel_h rebuilds (pallas_trunk_heads.
    py:252-291), in its expression order, from the saved zs (n, L*F):
    b_th_{L-1} = bf16(sigmoid(zsig)) w_sigma with zsig = bf16(h_{L-1}) .
    w_sigma + b, then b_th_{l-1} = bf16(act'(z_l) b_th_l) W_l.  Returns
    (n, L*F) f32, layer l in columns [l F, (l+1) F).  od as in
    _trunk_heads_fwd_plain (at float32 nothing is rounded)."""
    od = weight_dtype(cfg) if od is None else od
    vo = _vec_od(od)
    layers, skip, feat = cfg.layers, cfg.skips[0], cfg.feat
    _, w_bot = _split_skip(packed)
    wsig = packed["w_sigma"][None, :]
    d1s, h = [], None
    for i in range(layers):
        z = zs[:, i * feat:(i + 1) * feat].float()
        h, d1 = _act_all(z, 30.0 if i == 0 else 1.0, cfg.siren, cfg.fast_sin)
        d1s.append(d1)
    zsig = _mm(h, wsig, vo)[:, 0] + packed["b_sigma"]
    b_th = _mm_t(torch.sigmoid(zsig)[:, None], wsig, vo)
    out: List = [None] * layers
    mid = layers - 3
    for i in range(layers - 1, -1, -1):
        out[i] = b_th
        if i == 0:
            break
        b_tz = d1s[i] * b_th
        if i == skip:
            b_th = _mm_t(b_tz, w_bot, od)
        else:
            b_th = _mm_t(b_tz, packed["w_mid"][mid], od)
            mid -= 1
    return torch.cat(out, 1)


def uchain_from_kernel(uc: torch.Tensor, n: int, layers: int,
                       feat: int = FEAT) -> torch.Tensor:
    """K5's rebuilt b_th chain at trunk width F = `feat` (csrc/
    trunk_heads_bwd.cu: element j, e of consumer thread c of layer l of
    tile t at ((t L + l) F / 4 + 4 j + e) 256 + c, as the wgmma
    accumulators hold it, j < F / 16) as (n, L*F), uchain_plain's layout.
    Thread c = 128 wg + 32 w + 4 q + p holds rows 16 w + q + 8 hf and
    columns F / 2 wg + 8 j + 2 p + e1 (e = 2 hf + e1)."""
    v = uc[:n * layers * feat].view(n // TILE_N, layers, feat // 16, 2, 2,
                                    2, 4, 8, 4)
    # (tile, l, j, hf, e1, wg, w, q, p) -> (tile, w, hf, q, l, wg, j, p, e1)
    return v.permute(0, 6, 3, 7, 1, 5, 2, 8, 4).reshape(n, layers * feat)


def _trunk_heads_bwd_plain(packed: Dict, hw: Dict, cfg: ModelConfig, x, cot,
                           cg, zs, od=None):
    """Plain twin of K5, the Pallas _bwd_kernel_h (pallas_trunk_heads.py:
    185-302) in the same expression order: the b_th chain is rebuilt from
    zs (uchain_plain), not loaded.  x, cg (n, Ein_p) f32, cot (n, 8) f32,
    zs (n, L*F).  Returns K3's nine trunk grads, then dwf (F, F), dbf, dw1r (F, H), db1r,
    dw2r (H, LANE), db2r (LANE,), dw1p (F, 3H), db1p, dw2p (3H, LANE), db2p
    (LANE,), all f32 in (in, out) layout like the Pallas kernel's.  od as
    in _trunk_heads_fwd_plain."""
    od = weight_dtype(cfg) if od is None else od
    vo = _vec_od(od)
    wsig = packed["w_sigma"][None, :]
    hs, d1s, d2s, zsig, tzs, ths, tzsig = _bwd_primal_tangent(packed, cfg,
                                                              cg, zs, od)
    sp1 = torch.sigmoid(zsig)
    sp2 = sp1 * (1.0 - sp1)
    a_z = (cot[:, 0] * sp1 + sp2 * tzsig)[:, None]
    b_tz = sp1[:, None]

    # head recompute + first-order backward chain -> the a_h seed
    xf, hr, d1r, _, hp, d1p, _ = _head_forward(hs[-1], hw, od, cfg)
    pad = torch.zeros(cot.shape[0], LANE - 3, dtype=torch.float32,
                      device=cot.device)
    c_z2r = torch.cat([cot[:, 1:4], pad], 1)
    c_z2p = torch.cat([cot[:, 4:7], pad], 1)
    dw2r, db2r = _outer(hr, c_z2r, vo), torch.sum(c_z2r, 0)
    dw2p, db2p = _outer(hp, c_z2p, vo), torch.sum(c_z2p, 0)
    c_z1r = d1r * _mm_t(c_z2r, hw["w2r"], vo)
    c_z1p = d1p * _mm_t(c_z2p, hw["w2p"], vo)
    dw1r, db1r = _outer(xf, c_z1r, od), torch.sum(c_z1r, 0)
    dw1p, db1p = _outer(xf, c_z1p, od), torch.sum(c_z1p, 0)
    a_xf = _mm_t(c_z1r, hw["w1r"], od) + _mm_t(c_z1p, hw["w1p"], od)
    dwf, dbf = _outer(hs[-1], a_xf, od), torch.sum(a_xf, 0)
    a_h_heads = _mm_t(a_xf, hw["wf"], od)

    dwsig = (_outer(hs[-1], a_z, vo) + _outer(ths[-1], b_tz, vo))[:, 0]
    dbsig = torch.sum(a_z, 0)
    a_h = _mm_t(a_z, wsig, vo) + a_h_heads
    bths = uchain_plain(packed, cfg, zs, od).split(cfg.feat, 1)
    trunk = _reverse_sweep(packed, cfg, x, cg, hs, d1s, d2s, tzs, ths, a_h,
                           bths=bths, od=od)
    return trunk + (dwsig, dbsig, dwf, dbf, dw1r, db1r, dw2r, db2r, dw1p,
                    db1p, dw2p, db2p)


def _trunk_heads_bwd_split(packed: Dict, hw: Dict, cfg: ModelConfig, x, cot,
                           cg, zs):
    """K5's float32 arithmetic in plain PyTorch, for the tests: the twin
    with every trunk and head product of f32 operands as split3_mm, the
    sigma head and the heads' second layers in f32."""
    return _trunk_heads_bwd_plain(packed, hw, cfg, x, cot, cg, zs, od=SPLIT3)


# ------------------------------------------------------------ the kernels

def check_head_weights(cfg: ModelConfig, hw: Dict, x: torch.Tensor):
    """What K4 and K5 take of the packed heads, the operands of the
    configuration's dtype: bf16 weights at a bf16 compute dtype; at float32
    f32 weights with the split_planes of those head_plane_keys(cfg) names
    beside them, in the shapes of the width cfg.feat, a kernel
    configuration's (fused_mlp.kernel_cfg: the heads packed at the width
    K1-K5 run the model at); at a layer-major width also the merged first
    layers and the second layers laid over them (pack_head_weights).
    Anything else raises."""
    if kernel_cfg(cfg).feat != cfg.feat:
        raise ValueError(f"K4/K5 take the heads packed at the width the "
                         f"kernels run the model at (fused_mlp.kernel_cfg: "
                         f"{kernel_cfg(cfg).feat}, got feat={cfg.feat})")
    f, h = cfg.feat, cfg.feat // 2
    shapes = {"wf": (f, f), "bf": (f,), "w1r": (h, f), "b1r": (h,),
              "w2r": (LANE, h), "b2r": (LANE,), "w1p": (3 * h, f),
              "b1p": (3 * h,), "w2p": (LANE, 3 * h), "b2p": (LANE,)}
    if layer_major(cfg):
        shapes.update(w1=(4 * h, f), b1=(4 * h,), w2=(LOGITS, 4 * h),
                      b2=(LOGITS,))
    split = split_operands(cfg)
    wdt = torch.float32 if split else torch.bfloat16
    planes = head_plane_keys(cfg)
    if split:
        for k, kp in planes.items():
            shapes[kp] = (2,) + shapes[k]
    for k, shape in shapes.items():
        v = hw.get(k)
        want = (torch.float32 if k.startswith("b") or k == "w2" else
                torch.bfloat16 if k in planes.values() else wdt)
        if v is None:
            raise ValueError(f"packed head {k} is missing: at compute_dtype "
                             f"float32 the heads hold the hi and lo planes "
                             f"of {', '.join(planes)} (split_planes), and at "
                             f"a layer-major width the merged w1, b1, w2 "
                             f"and b2 (pack_head_weights)")
        if not (v.device == x.device and v.is_contiguous()
                and tuple(v.shape) == shape and v.dtype == want):
            raise ValueError(f"packed head {k} must be a contiguous {want} "
                             f"tensor {shape} on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def head_weight_ptrs(cfg: ModelConfig, hw: Dict) -> Dict[str, int]:
    """{name: data pointer} of the packed heads in the kernels' order (wf,
    bf, w1r, b1r, w2r, b2r, w1p, b1p, w2p, b2p): at float32 the planes of
    wf, w1r and w1p in their places."""
    planes = HEAD_PLANE_KEYS if split_operands(cfg) else {}
    return {k: hw[planes.get(k, k)].data_ptr()
            for k in ("wf", "bf", "w1r", "b1r", "w2r", "b2r", "w1p", "b1p",
                      "w2p", "b2p")}


def _trunk_heads_fwd_cuda(packed: Dict, hw: Dict, cfg: ModelConfig, x,
                          want_zs: bool = False):
    """K4: (out (n, 8), gx (n, lanes), zs): with want_zs, zs as saved_spec
    (bf16 under bfloat16_all, f32 under bfloat16 and float32), the residual
    K5 reads, else None.  A layer-major kernel configuration
    (fused_mlp.layer_major) launches the layer-major K4."""
    if layer_major(cfg):
        from .trunk_layers import layers_fwd_grad_heads
        return layers_fwd_grad_heads(packed, hw, cfg, x, want_zs)
    check_kernel_inputs(cfg, packed, x)
    check_head_weights(cfg, hw, x)
    n, dev = x.shape[0], x.device
    out = torch.empty(n, HEAD_COLS, dtype=torch.float32, device=dev)
    gx = torch.empty(n, LANE, dtype=torch.float32, device=dev)
    zs = None
    if want_zs:
        shape, dt = saved_spec(cfg, n)
        zs = torch.empty(shape, dtype=dt, device=dev)
    n_blocks, scratch = fwd_scratch(n, cfg.layers, True, dev, cfg.feat)
    w0, w_mid, w_skip = trunk_weight_ptrs(cfg, packed)
    TRUNK_HEADS_FWD(
        x.data_ptr(), n, n_blocks, w0, packed["b0"].data_ptr(), w_mid,
        packed["b_mid"].data_ptr(), w_skip, packed["b_skip"].data_ptr(),
        packed["w_sigma"].data_ptr(), packed["b_sigma"].data_ptr(),
        *head_weight_ptrs(cfg, hw).values(),
        out.data_ptr(), gx.data_ptr(), scratch.data_ptr(),
        None if zs is None else zs.data_ptr(),
        int(zs is not None and zs.dtype == torch.float32),
        int(split_operands(cfg)), cfg.layers, cfg.skips[0],
        torch.cuda.current_stream(dev).cuda_stream, act=act_of(cfg),
        feat=cfg.feat)
    return out, gx, zs


def check_bwd_h_inputs(cfg: ModelConfig, packed: Dict, hw: Dict, x, cot, cg,
                       zs):
    """What K5 takes; anything else raises.  It takes no u chain: it
    rebuilds it from zs, taken as saved_spec."""
    check_kernel_inputs(cfg, packed, x)
    check_head_weights(cfg, hw, x)
    n = x.shape[0]
    want = {"cot": (cot, (n, HEAD_COLS), torch.float32),
            "cg": (cg, (n, x.shape[1]), torch.float32),
            "zs": (zs,) + saved_spec(cfg, n)}
    for k, (v, shape, dt) in want.items():
        if v is None or not (v.device == x.device and v.is_contiguous()
                             and tuple(v.shape) == shape and v.dtype == dt):
            raise ValueError(f"{k} must be a contiguous {dt} tensor {shape} "
                             f"on {x.device}, got "
                             + ("None" if v is None else
                                f"{v.dtype} {tuple(v.shape)} on {v.device}"))


def _trunk_heads_bwd_cuda(packed: Dict, hw: Dict, cfg: ModelConfig, x, cot,
                          cg, zs, scratch_out=None):
    """K5: the outputs of _trunk_heads_bwd_plain.  dw2r / dw2p hold their
    three logit columns and zeros elsewhere.  A dict passed as scratch_out
    receives the kernel's scratch (for checks of its intermediates; "uc",
    the rebuilt b_th chain, reads as uchain_plain through
    uchain_from_kernel).  A layer-major kernel configuration launches the
    layer-major K5 (its scratch_out: trunk_layers.layers_bwd_heads')."""
    if layer_major(cfg):
        from .trunk_layers import layers_bwd_heads
        return layers_bwd_heads(packed, hw, cfg, x, cot, cg, zs, scratch_out)
    check_bwd_h_inputs(cfg, packed, hw, x, cot, cg, zs)
    n, dev = x.shape[0], x.device
    layers, F, H = cfg.layers, cfg.feat, cfg.feat // 2

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    def bf(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device=dev)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=dev)

    n_tiles = n // TILE_N
    n_blocks = min(n_tiles,
                   torch.cuda.get_device_properties(dev).multi_processor_count)
    split = split_operands(cfg)
    # the rebuilt b_th chain, K3's scratch (as _trunk_bwd_cuda's), then the
    # bf16 operands of the heads' weight-gradient products: h_{L-1}, xf,
    # a_xf and the first layers' cotangents [c_z1r | c_z1p] (at float32
    # each as its hi and lo planes)
    uc = f32(n * layers * F)
    splits_t, splits_h, wpart = wgrad_scratch(n, layers, True, dev, split, F)
    pl, hp = (4, 2) if split else (2, 1)
    scratch = (bf(pl, n, LANE), bf(layers - 1, pl, n, F),
               bf(layers, pl, n, F),
               f32(n_tiles, (layers + 1) * F + head_part(F)), f32(n_tiles),
               f32(n_blocks, layers, TILE_N * F), wpart)
    head_ops = (bf(hp, n, F), bf(hp, n, F), bf(hp, n, F), bf(hp, n, 4 * H))
    trunk = (f32(LANE, F), f32(F), f32(layers - 2, F, F), f32(layers - 2, F),
             f32(LANE, F), f32(F, F), f32(F), f32(F), f32(1))
    dw1, db1 = f32(F, 4 * H), f32(4 * H)
    heads = (f32(F, F), f32(F), dw1, db1, zeros(H, LANE), zeros(LANE),
             zeros(3 * H, LANE), zeros(LANE))
    hptr = head_weight_ptrs(cfg, hw)
    TRUNK_HEADS_BWD(
        x.data_ptr(), cot.data_ptr(), cg.data_ptr(), zs.data_ptr(),
        uc.data_ptr(), n, n_blocks, *trunk_weight_ptrs(cfg, packed),
        packed["w_sigma"].data_ptr(), packed["b_sigma"].data_ptr(),
        *(hptr[k] for k in ("wf", "bf", "w1r", "b1r", "w2r", "w1p", "b1p",
                            "w2p")),
        *(v.data_ptr() for v in scratch), splits_t, splits_h, wpart.shape[0],
        *(v.data_ptr() for v in head_ops), *(v.data_ptr() for v in trunk),
        *(v.data_ptr() for v in heads), int(zs.dtype == torch.float32),
        int(split), layers, cfg.skips[0],
        torch.cuda.current_stream(dev).cuda_stream, act=act_of(cfg), feat=F)
    if scratch_out is not None:
        scratch_out.update(zip(("xt", "hth", "azbtz", "part", "pbs"), scratch))
        scratch_out.update(zip(("hl", "xfb", "axf", "cz1"), head_ops))
        scratch_out["uc"] = uc
    dwf, dbf, _, _, dw2r, db2r, dw2p, db2p = heads
    return trunk + (dwf, dbf, dw1[:, :H], db1[:H], dw2r, db2r, dw1[:, H:],
                    db1[H:], dw2p, db2p)


# --------------------------------------------------------------- plumbing

def _run_fwd_h(cfg: ModelConfig, packed: Dict, hw: Dict, x_enc,
               want_zs: bool = False):
    """(packed logits (n, 8), gx (n, Ein_p)) of encoded points; with
    want_zs also zs, padded to the kernel's row count (the backward
    rebuilds the u chain from it, as the Pallas pair does).  cfg is a
    kernel configuration (fused_mlp.kernel_cfg): F is its width and rows
    are padded to its row_tile."""
    n, rows = x_enc.shape[0], row_tile(cfg)
    x = pad_rows_lanes(x_enc, _round_up(max(n, rows), rows),
                       packed["w0"].shape[1])
    if x.device.type == "cpu":
        out, gx, zs = _trunk_heads_fwd_plain(packed, hw, cfg, x, want_zs)
    else:
        out, gx, zs = _trunk_heads_fwd_cuda(packed, hw, cfg, x, want_zs)
    if want_zs:
        return out[:n], gx[:n], zs
    return out[:n], gx[:n]


def _run_bwd_h(cfg: ModelConfig, packed: Dict, hw: Dict, x_enc, c_out, c_g,
               zs):
    """The trunk's and the heads' packed weight grads from the saved zs;
    rows are padded to zs's row count with zero cotangents, which
    contribute exactly 0."""
    n_p = zs.shape[0]
    ein_p = packed["w0"].shape[1]
    x = pad_rows_lanes(x_enc, n_p, ein_p)
    cot = pad_rows_lanes(c_out, n_p, HEAD_COLS)
    cg = pad_rows_lanes(c_g, n_p, ein_p)
    if x.device.type == "cpu":
        return _trunk_heads_bwd_plain(packed, hw, cfg, x, cot, cg, zs)
    return _trunk_heads_bwd_cuda(packed, hw, cfg, x, cot, cg, zs)


def _unpack_head_grads(cfg: ModelConfig, outs) -> List[torch.Tensor]:
    """Packed (in, out) head grads -> the grads of head_params(net) in the
    port's (out, in) layout, at cfg's width F and HID = F / 2: the padded
    columns and blocks of w2r / w2p address no parameter and are sliced
    away (pallas_trunk_heads.py:448-462), as are the rows and columns a
    zero-padded packing (kernel_cfg's width, HID_p = dw1r's columns) adds,
    each head's hidden units at the start of its HID_p block."""
    (dwf, dbf, dw1r, db1r, dw2r, db2r, dw1p, db1p, dw2p, db2p) = outs
    f, hid, hp = cfg.feat, cfg.feat // 2, dw1r.shape[1]
    grads = [dwf[:f, :f].t(), dbf[:f], dw1r[:f, :hid].t(), db1r[:hid],
             dw2r[:hid, :3].t(), db2r[:3]]
    for i in range(len(RPV_NAMES)):
        s = slice(i * hp, i * hp + hid)
        grads += [dw1p[:f, s].t(), db1p[s], dw2p[s, i:i + 1].t(),
                  db2p[i:i + 1]]
    return grads


def head_params(net) -> List[torch.Tensor]:
    """The parameters of the fused head block: [w, b] of every layer of
    feats_from_xyz, rgb_from_xyzdir and the three RPV heads, in order."""
    out: List[torch.Tensor] = []
    for name in HEAD_NAMES:
        for layer in net[name]:
            out += [layer.w, layer.b]
    return out


def _head_view(params) -> Dict[str, list]:
    """head_params' flat list back into named layers."""
    layers = [SimpleNamespace(w=params[2 * i], b=params[2 * i + 1])
              for i in range(len(params) // 2)]
    view = {"feats_from_xyz": layers[:1], "rgb_from_xyzdir": layers[1:3]}
    for i, name in enumerate(RPV_NAMES):
        view[name] = layers[3 + 2 * i:5 + 2 * i]
    return view


class TrunkHeadsCore(torch.autograd.Function):
    """(packed logits, d sigma / d x_enc) with the hand-derived VJP: the
    forward runs K4 saving zs, the backward K5, both at
    fused_mlp.kernel_cfg's width (the grads sliced back to cfg's).  x_enc
    carries no gradient; like the JAX package's _trunk_heads_bwd, its grad
    is zeros."""

    @staticmethod
    def forward(ctx, cfg: ModelConfig, x_enc: torch.Tensor, *params):
        n_trunk = 2 * (cfg.layers + 1)
        kcfg, packed = pack_at_kernel_width(_params_view(params[:n_trunk]),
                                            cfg)
        hw = pack_head_weights(_head_view(params[n_trunk:]), kcfg,
                               weight_dtype(cfg))
        out, gx, zs = _run_fwd_h(kcfg, packed, hw, x_enc, want_zs=True)
        ctx.cfg, ctx.kcfg, ctx.packed, ctx.hw, ctx.zs = (cfg, kcfg, packed,
                                                         hw, zs)
        ctx.save_for_backward(x_enc)
        ctx.ein = params[0].shape[1]
        ctx.set_materialize_grads(False)
        return out, gx

    @staticmethod
    def backward(ctx, c_out, c_g):
        (x,) = ctx.saved_tensors
        n, dev = x.shape[0], x.device
        if c_out is None:
            c_out = torch.zeros(n, HEAD_COLS, dtype=torch.float32,
                                device=dev)
        if c_g is None:
            c_g = torch.zeros(n, ctx.packed["w0"].shape[1],
                              dtype=torch.float32, device=dev)
        outs = _run_bwd_h(ctx.kcfg, ctx.packed, ctx.hw, x, c_out.float(),
                          c_g.float(), ctx.zs)
        grads = (_unpack_grads(ctx.cfg, ctx.ein, outs[:9])
                 + _unpack_head_grads(ctx.cfg, outs[9:]))
        dx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return (None, dx, *grads)


def trunk_heads_core(net, cfg: ModelConfig, x_enc: torch.Tensor):
    """(packed logits (n, 8), d sigma / d x_enc) of the trunk and the
    flagship heads at encoded points.  Columns of the logits: [softplus
    sigma, rgb x3, k, theta, rhoc, 0].  Where autograd records and a
    parameter requires grad this goes through TrunkHeadsCore (K4 saving
    zs, then K5 in the backward); otherwise K4 alone, saving nothing."""
    params = trunk_params(net) + head_params(net)
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return TrunkHeadsCore.apply(cfg, x_enc.detach(), *params)
    kcfg, packed = pack_at_kernel_width(net, cfg)
    return _run_fwd_h(kcfg, packed,
                      pack_head_weights(net, kcfg, weight_dtype(cfg)),
                      x_enc.detach())


def fused_trunk_heads_with_grad(net, cfg: ModelConfig,
                                xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Drop-in for the trunk and the flagship heads of
    apply_network_with_normals: the named outputs {sigma, rgb, rpv_k,
    rpv_theta, rpv_rhoc, normal_an}, the sigmoid and the RPV rescalings
    ([0, 2], [-1, 1], [0, 1]) applied here to the packed logits
    (pallas_trunk_heads.py:505-546)."""
    from .compositing import l2_normalize
    enc, chain = encode_with_jacobian(cfg, xyz)
    out_p, gx_enc = trunk_heads_core(net, cfg, enc)
    gx = chain(gx_enc)

    def tile3(v):
        return v.repeat(1, 3)

    return {
        "sigma": out_p[:, 0],
        "rgb": torch.sigmoid(out_p[:, 1:4]),
        "rpv_k": tile3((torch.sigmoid(out_p[:, 4:5]) - 0.5) * 2.0 + 1.0),
        "rpv_theta": tile3((torch.sigmoid(out_p[:, 5:6]) - 0.5) * 2.0),
        "rpv_rhoc": tile3(torch.sigmoid(out_p[:, 6:7])),
        "normal_an": -l2_normalize(gx.float()),
    }
