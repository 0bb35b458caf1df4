"""The whole trunk + sigma head as one kernel, forward only (counterpart
of the JAX package's ops/pallas_mlp.py), for a siren trunk with the
polynomial or the exact sine, or a ReLU trunk.

It runs the two sigma-only passes of a spsbrdf render, the guided depth
probe and the analytic sun march, whose results are consumed only as
detached values.  On a CUDA tensor `fused_trunk_sigma` launches kernel K1
(csrc/trunk_sigma.cu); on a CPU tensor it runs `_trunk_sigma_plain`, the
plain PyTorch twin that repeats the Pallas kernel's arithmetic.  There is no
fallback from one to the other.

The Pallas kernel multiplies f32 activations by bf16 weights in f32.  K1
keeps that on bf16 tensor cores by splitting each f32 operand into two
bf16 terms (`split_bf16`) and summing both products in f32;
`_trunk_sigma_split` is that arithmetic in plain PyTorch, for the tests.
At compute_dtype float32 the weights are f32 too: the packed weights then
carry hi and lo bf16 planes for the CUDA kernels (`split_planes`), and each
product runs as three (`split3_mm`: A_hi B_hi + A_lo B_hi + A_hi B_lo).
The activation and the trunk width are built into each kernel library
(`act_of`, ops/cuda_build.ACTS; `cfg.feat`, one of CUDA_WIDTHS).  Every
other width, and any encoding over LANE lanes, takes the layer-major
family (ops/trunk_layers.py, csrc/trunk_layers.cu), whose width is a
runtime argument.  The entry points pack the weights at `kernel_cfg`'s
width, zero-padded: a width of at most 512 outside CUDA_WIDTHS at the next
one (the fused family), any other at the next multiple of LAYER_TILE, and
slice the results back to the model's width.

The skip layer's concat([enc, h]) @ W is split as enc @ W_top + h @ W_bot;
the packed `w_skip` holds [W_top (lane-padded) | W_bot] in (out, in) layout,
so the kernel runs it as one product over [enc | h].
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from .cuda_build import WIDTHS, CudaKernel

TILE_N = 64        # points per CUDA block
LANE = 128         # encoding width the kernels take (the lanes are padded to
                   # a multiple of it)
FEAT = 512         # the flagship's trunk width
# the layer-major kernels' tile: their width, lanes and points are
# multiples of it (ops/trunk_layers.ROWS)
LAYER_TILE = 128
# the trunk widths K1-K3 are built for (ops/cuda_build.library_key)
CUDA_WIDTHS = WIDTHS

_P = ctypes.c_void_p
_I = ctypes.c_int
TRUNK_SIGMA = CudaKernel(
    "trunk_sigma", "trunk_sigma_launch",
    [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
# the compute dtypes the CUDA kernels take
CUDA_DTYPES = ("float32", "bfloat16", "bfloat16_all")
# the trunk weights the kernels stream, and the key of their hi/lo planes
PLANE_KEYS = {"w0": "w0_planes", "w_mid": "w_mid_planes",
              "w_skip": "w_skip_planes"}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def kernel_supports(cfg: ModelConfig) -> bool:
    """The fused trunk assumes the reference architecture: exactly one skip
    layer inside the trunk and at least one plain mid layer.  Callers use
    the unfused path when this is False."""
    return (len(cfg.skips) == 1 and 0 < cfg.skips[0] < cfg.layers
            and cfg.layers >= 3 and cfg.compute_dtype != "int8")


def cuda_kernels_cover(cfg: ModelConfig) -> bool:
    """True where the CUDA kernels K1-K5 take this model: the architecture
    of kernel_supports (any of the three activations, act_of) and a compute
    dtype of CUDA_DTYPES, at any width and encoding (kernel_cfg picks the
    family and the padded width; K4/K5 also need the flagship head set,
    fused_trunk_heads.heads_kernel_supports)."""
    return kernel_supports(cfg) and cfg.compute_dtype in CUDA_DTYPES


def kernel_width(cfg: ModelConfig) -> int:
    """The width K1-K3 run the model at: with an encoding of at most LANE
    lanes and a width of at most FEAT, the least of CUDA_WIDTHS that holds
    it (the fused family); otherwise the width rounded up to LAYER_TILE
    (the layer-major family)."""
    if cfg.feat <= FEAT and cfg.xyz_in_dim <= LANE:
        return min(w for w in CUDA_WIDTHS if w >= cfg.feat)
    return _round_up(cfg.feat, LAYER_TILE)


def kernel_cfg(cfg: ModelConfig) -> ModelConfig:
    """cfg at kernel_width: the configuration the packed weights, the twins
    and the kernels take (zero-padded columns change no logical value)."""
    w = kernel_width(cfg)
    return cfg if w == cfg.feat else dataclasses.replace(cfg, feat=w)


def pack_at_kernel_width(net, cfg: ModelConfig
                         ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """(kernel_cfg(cfg), the trunk packed at its width in cfg's weight
    dtype): where the kernels run a model at a wider width than its own,
    the entry points pack here and take unpad_feats of what they return."""
    kcfg = kernel_cfg(cfg)
    return kcfg, pack_trunk_weights(net, kcfg, weight_dtype(cfg))


def unpad_feats(cfg: ModelConfig, feats: torch.Tensor) -> torch.Tensor:
    """feats (n, F) at a kernel configuration's width, sliced back to
    cfg's own (the padded columns are exact zeros)."""
    return feats[:, :cfg.feat]


def layer_major(cfg: ModelConfig) -> bool:
    """True where a kernel configuration (kernel_cfg) runs the layer-major
    family (ops/trunk_layers.py): a width outside CUDA_WIDTHS or an
    encoding over LANE lanes."""
    return cfg.feat not in CUDA_WIDTHS or cfg.xyz_in_dim > LANE


def row_tile(cfg: ModelConfig) -> int:
    """The multiple a kernel configuration pads the points to."""
    return LAYER_TILE if layer_major(cfg) else TILE_N


def act_of(cfg: ModelConfig) -> str:
    """The trunk's activation as the kernel libraries name it
    (ops/cuda_build.ACTS): "poly" (siren, the polynomial sine), "sin"
    (siren, the exact sine) or "relu" (no siren)."""
    if not cfg.siren:
        return "relu"
    return "poly" if cfg.fast_sin else "sin"


def split_operands(cfg: ModelConfig) -> bool:
    """True where the kernels multiply f32 operands (compute_dtype float32)
    as three products of their bf16 hi and lo terms."""
    return cfg.compute_dtype == "float32"


def weight_dtype(cfg: ModelConfig) -> torch.dtype:
    return (torch.bfloat16 if cfg.compute_dtype in ("bfloat16", "bfloat16_all")
            else torch.float32)


def split_planes(w: torch.Tensor) -> torch.Tensor:
    """(2, *w.shape) bf16: split_bf16's hi and lo terms of the f32 w, the
    layout the CUDA kernels take f32 weights in (the same bytes as f32)."""
    return torch.stack(split_bf16(w.float())).contiguous()


def pack_trunk_weights(net, cfg: ModelConfig,
                       dtype: torch.dtype = torch.float32,
                       planes: Optional[bool] = None
                       ) -> Dict[str, torch.Tensor]:
    """Trunk + sigma head as dense matrices in (out, in) layout, at the
    width F = cfg.feat (kernel_cfg's; the network's own width is its
    weights', and wider rows and columns are zeros):

      w0 (F, Ein_p) dtype, b0 (F,) f32
      w_mid (L-2, F, F) dtype, b_mid (L-2, F) f32  -- non-skip layers 1..L-1
      w_skip (F, Ein_p + F) dtype = [W_top | W_bot], b_skip (F,) f32
      w_sigma (F,) f32 holding dtype-rounded values, b_sigma (1,) f32

    With `planes` (by default: f32 weights on a CUDA device, which the
    kernels take as split products) also split_planes of w0, w_mid and
    w_skip under PLANE_KEYS, split once here for every launch that reads
    this pack; the plain twins read the f32 matrices.
    """
    assert len(cfg.skips) == 1, "fused kernel supports one skip layer"
    skip = cfg.skips[0]
    trunk = net["fc_net"]
    feat, ein = cfg.feat, cfg.xyz_in_dim
    ein_p = _round_up(ein, LANE)
    dev = trunk[0].w.device

    def pad(w, rows, cols, dt=dtype):
        out = torch.zeros(rows, cols, dtype=dt, device=dev)
        out[:w.shape[0], :w.shape[1]] = w.detach().to(dt)
        return out

    def pad_b(b):
        # at the model's own width the f32 bias as it is (its storage: a
        # kernel call's packed b0 names its network, chip_smoke.pack_owners)
        if b.shape[0] == feat:
            return b.detach().float()
        return pad(b[None], 1, feat, torch.float32)[0]

    packed: Dict[str, torch.Tensor] = {
        "w0": pad(trunk[0].w, feat, ein_p), "b0": pad_b(trunk[0].b)}
    mids_w, mids_b = [], []
    for i in range(1, cfg.layers):
        layer = trunk[i]
        if i == skip:
            packed["w_skip"] = torch.cat(
                [pad(layer.w[:, :ein], feat, ein_p),
                 pad(layer.w[:, ein:], feat, feat)], 1).contiguous()
            packed["b_skip"] = pad_b(layer.b)
        else:
            mids_w.append(pad(layer.w, feat, feat))
            mids_b.append(pad_b(layer.b))
    packed["w_mid"] = torch.stack(mids_w).contiguous()
    packed["b_mid"] = torch.stack(mids_b).contiguous()
    sig = net["sigma_from_xyz"][0]
    packed["w_sigma"] = pad_b(sig.w.detach()[0].to(dtype).float())
    packed["b_sigma"] = sig.b.detach().float().reshape(1).contiguous()
    if planes is None:
        planes = dtype == torch.float32 and dev.type == "cuda"
    if planes:
        for k, kp in PLANE_KEYS.items():
            packed[kp] = split_planes(packed[k])
    return packed


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _act(cfg: ModelConfig, z: torch.Tensor, first: bool) -> torch.Tensor:
    """The trunk's activation of z (pallas_mlp.py:128-132): the polynomial
    or the exact sine of w0 z (w0 = 30 on the first layer), or ReLU."""
    if cfg.siren:
        w0 = 30.0 if first else 1.0
        if cfg.fast_sin:
            from .fast_math import fast_sin
            return fast_sin(w0 * z)
        return torch.sin(w0 * z)
    return torch.clamp(z, min=0.0)


def _trunk_sigma_plain(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                       want_feats: bool):
    """Plain twin of K1, the Pallas kernel's arithmetic: f32 activations
    times the dtype-rounded weights, f32 products (pallas_mlp.py:134-151:
    jnp.dot promotes the bf16 weights to f32)."""
    ein_p = packed["w0"].shape[1]
    skip = cfg.skips[0]
    h = _act(cfg, x @ packed["w0"].float().t() + packed["b0"], True)
    mid = 0
    for i in range(1, cfg.layers):
        if i == skip:
            ws = packed["w_skip"].float()
            z = (x @ ws[:, :ein_p].t() + h @ ws[:, ein_p:].t()
                 + packed["b_skip"])
        else:
            z = h @ packed["w_mid"][mid].float().t() + packed["b_mid"][mid]
            mid += 1
        h = _act(cfg, z, False)
    sigma = _softplus(h @ packed["w_sigma"] + packed["b_sigma"])
    return sigma, (h if want_feats else None)


def split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 with hi = bf16(a), lo = bf16(a - hi), both rounded to
    nearest even: hi + lo holds a normal f32 value a to 2^-16 relative,
    as long as a - hi is normal too (|a| >= 2^-110) and a is within bf16's
    finite range.  K1's operand split (csrc/trunk_sigma.cu)."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.float()).to(torch.bfloat16)


def split3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for f32 a (n, K) and b (K, m) as the split kernels compute it:
    A_hi B_hi + A_lo B_hi + A_hi B_lo on the split_bf16 terms, each product
    of bf16 terms exact, sums in f32.  The dropped A_lo B_lo and the terms'
    residuals leave each product within 2^-16 of its exact value (about
    2^-17 as a rule)."""
    ah, al = (t.float() for t in split_bf16(a.float()))
    bh, bl = (t.float() for t in split_bf16(b.float()))
    return ah @ bh + al @ bh + ah @ bl


def _trunk_sigma_split(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                       want_feats: bool):
    """K1's arithmetic in plain PyTorch, for the tests: every product as
    hi . W + lo . W on the split_bf16 terms of its f32 operand (the
    activations and the encoded input), and with f32 weights (float32) the
    three products of split3_mm, f32 sums, then bias, activation (the
    configuration's, as the kernel library is built for it) and the sigma
    head in f32 as in _trunk_sigma_plain."""
    def mm(a, w):
        if w.dtype == torch.float32:
            return split3_mm(a, w.t())
        hi, lo = split_bf16(a)
        wf = w.float().t()
        return hi.float() @ wf + lo.float() @ wf

    ein_p = packed["w0"].shape[1]
    skip = cfg.skips[0]
    h = _act(cfg, mm(x, packed["w0"]) + packed["b0"], True)
    mid = 0
    for i in range(1, cfg.layers):
        if i == skip:
            ws = packed["w_skip"]
            z = mm(h, ws[:, ein_p:]) + mm(x, ws[:, :ein_p]) + packed["b_skip"]
        else:
            z = mm(h, packed["w_mid"][mid]) + packed["b_mid"][mid]
            mid += 1
        h = _act(cfg, z, False)
    sigma = _softplus(h @ packed["w_sigma"] + packed["b_sigma"])
    return sigma, (h if want_feats else None)


def check_kernel_inputs(cfg: ModelConfig, packed: Dict, x: torch.Tensor):
    """What the CUDA trunk kernels take; anything else raises.  cfg is a
    kernel configuration (kernel_cfg): the fused family takes a width of
    CUDA_WIDTHS and LANE lanes, the layer-major family (layer_major) a
    width and lanes that are multiples of LAYER_TILE.  The packed trunk
    weights are bf16 at a bf16 compute dtype; at float32 they are f32 with
    their split_planes beside them."""
    if not cuda_kernels_cover(cfg):
        raise ValueError(
            f"the CUDA trunk kernels take a trunk with one skip layer inside "
            f"it (siren with the polynomial or the exact sine, or ReLU) and "
            f"a compute_dtype of {CUDA_DTYPES} (got layers={cfg.layers}, "
            f"skips={tuple(cfg.skips)}, compute_dtype="
            f"{cfg.compute_dtype!r}); this model runs with the fused "
            f"kernels off")
    wide = layer_major(cfg)
    if wide and cfg.feat % LAYER_TILE:
        raise ValueError(
            f"the layer-major kernels take a trunk width that is a multiple "
            f"of {LAYER_TILE} (got width {cfg.feat}); the fused family takes "
            f"the widths {CUDA_WIDTHS}; fused_mlp.kernel_cfg pads to either")
    lanes = _round_up(cfg.xyz_in_dim, LANE) if wide else LANE
    rows = row_tile(cfg)
    if packed["w0"].shape != (cfg.feat, lanes):
        raise ValueError(f"packed w0 must be ({cfg.feat}, {lanes}), got "
                         f"{tuple(packed['w0'].shape)}")
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and x.dim() == 2 and x.shape[1] == lanes
            and x.shape[0] % rows == 0 and x.shape[0] > 0):
        raise ValueError(f"x must be a contiguous f32 CUDA tensor (n, "
                         f"{lanes}) with n % {rows} == 0, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    split = split_operands(cfg)
    for k, kp in PLANE_KEYS.items():
        if split and (kp not in packed or tuple(packed[kp].shape)
                      != (2,) + tuple(packed[k].shape)):
            raise ValueError(f"packed {kp} must hold the hi and lo planes "
                             f"of {k} (split_planes) at compute_dtype "
                             f"float32")
    for k, v in packed.items():
        if k in PLANE_KEYS.values() and not split:
            continue
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"packed {k} must be contiguous on {x.device}")
        want = (torch.bfloat16 if k in PLANE_KEYS.values()
                or (k in PLANE_KEYS and not split) else torch.float32)
        if v.dtype != want:
            raise ValueError(f"packed {k} is {v.dtype}, need {want}")


def trunk_weight_ptrs(cfg: ModelConfig, packed: Dict):
    """The data pointers of w0, w_mid and w_skip that the kernels stream:
    the bf16 weights, or at float32 their hi and lo planes."""
    keys = (PLANE_KEYS.values() if split_operands(cfg) else PLANE_KEYS)
    return tuple(packed[k].data_ptr() for k in keys)


def _trunk_sigma_cuda(packed: Dict, cfg: ModelConfig, x: torch.Tensor,
                      want_feats: bool):
    if layer_major(cfg):
        from .trunk_layers import layers_sigma
        return layers_sigma(packed, cfg, x, want_feats)
    check_kernel_inputs(cfg, packed, x)
    n = x.shape[0]
    sigma = torch.empty(n, dtype=torch.float32, device=x.device)
    feats = (torch.empty(n, cfg.feat, dtype=torch.float32, device=x.device)
             if want_feats else None)
    w0, w_mid, w_skip = trunk_weight_ptrs(cfg, packed)
    TRUNK_SIGMA(
        x.data_ptr(), n, w0, packed["b0"].data_ptr(), w_mid,
        packed["b_mid"].data_ptr(), w_skip, packed["b_skip"].data_ptr(),
        packed["w_sigma"].data_ptr(), packed["b_sigma"].data_ptr(),
        sigma.data_ptr(), None if feats is None else feats.data_ptr(),
        cfg.layers, cfg.skips[0], int(split_operands(cfg)),
        torch.cuda.current_stream(x.device).cuda_stream, act=act_of(cfg),
        feat=cfg.feat)
    return sigma, feats


def pad_rows_lanes(x_enc: torch.Tensor, n_p: int, ein_p: int) -> torch.Tensor:
    n, ein = x_enc.shape
    if n == n_p and ein == ein_p:
        return x_enc.float().contiguous()
    x = torch.zeros(n_p, ein_p, dtype=torch.float32, device=x_enc.device)
    x[:n, :ein] = x_enc
    return x


def fused_trunk_sigma(net, cfg: ModelConfig, x_enc: torch.Tensor,
                      want_feats: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Trunk + sigma of encoded points x_enc (N, Ein).  Returns (sigma (N,),
    feats (N, F) f32) or (sigma, None) with want_feats=False.  The weights
    are packed at kernel_cfg's width, rows padded to its row_tile and lanes
    to LANE internally.  A CPU tensor runs the plain twin; a CUDA tensor
    launches K1 (the fused or the layer-major family) or raises."""
    kcfg, packed = pack_at_kernel_width(net, cfg)
    n, rows = x_enc.shape[0], row_tile(kcfg)
    x = pad_rows_lanes(x_enc, _round_up(max(n, rows), rows),
                       packed["w0"].shape[1])
    if x.device.type == "cpu":
        sigma, feats = _trunk_sigma_plain(packed, kcfg, x, want_feats)
    else:
        sigma, feats = _trunk_sigma_cuda(packed, kcfg, x, want_feats)
    return sigma[:n], (unpad_feats(cfg, feats[:n]) if want_feats else None)


def fused_sigma_fn(net, cfg: ModelConfig, xyz: torch.Tensor) -> torch.Tensor:
    """Drop-in for models.network.sigma_fn on the no-grad paths."""
    from .encoding import positional_encoding
    if cfg.mapping and cfg.mapping_sizes[0] > 0:
        ein_p = _round_up(2 * cfg.mapping_sizes[0] * xyz.shape[-1], LANE)
        enc = positional_encoding(xyz, cfg.mapping_sizes[0],
                                  fast=cfg.fast_sin, pad_to=ein_p)
    else:
        enc = xyz
    sigma, _ = fused_trunk_sigma(net, cfg, enc, want_feats=False)
    return sigma
