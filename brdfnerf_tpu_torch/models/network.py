"""NeRF-family network: shared siren trunk + config-gated heads, as an
`nn.Module` (counterpart of the JAX package's models/network.py).

`Network` is an `nn.ModuleDict` of named heads (fc_net, sigma_from_xyz,
feats_from_xyz, rgb_from_xyzdir, sun_v_net, ...), each a list of `Dense`
layers with parameters `w` and `b`, so `named_parameters()` reads
`fc_net.0.w`, the npz key `coarse/fc_net/0/w` with '.' for '/'.  `w` is
stored (out, in), nn.Linear's layout; the npz (and the JAX package) store
(in, out), and utils/checkpoint.py transposes on the way in and out.

`Params` holds the JAX package's {'coarse': net, ['fine': net],
['t': (vocab, tau)]}: the coarse network, the fine one of n_importance > 0
and the transient embedding table of the beta head.  Its parameters read
`coarse.fc_net.0.w`, `fine.fc_net.0.w`, `t`, the npz keys with '.' for '/'.
The system builds Params alone (model_params, init_params); a bare
`Network` handed to an entry point stands for the coarse network alone
(as_params).

The forward functions return a dict of named head outputs, like the JAX
package, so the render step consumes names.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.compositing import l2_normalize
from ..ops.encoding import positional_encoding
from ..ops.fused_mlp import _round_up


# ---------------------------------------------------------------- modules

class Dense(nn.Module):
    """One linear layer; w (out, in), b (out,)."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(fan_out, fan_in, device=device))
        self.b = nn.Parameter(torch.empty(fan_out, device=device))


class Network(nn.ModuleDict):
    """Named heads -> nn.ModuleList of Dense layers; `cfg` is the
    ModelConfig it was built for."""

    def __init__(self, cfg: ModelConfig, device=None):
        feat, xyz_in, dir_in = cfg.feat, cfg.xyz_in_dim, cfg.dir_in_dim
        sizes: Dict[str, list] = {}
        sizes["fc_net"] = [
            (xyz_in if i == 0 else
             (feat + xyz_in if i in cfg.skips else feat), feat)
            for i in range(cfg.layers)]

        def mlp(dims):
            return list(zip(dims[:-1], dims[1:]))

        sizes["sigma_from_xyz"] = mlp([feat, 1])
        sizes["feats_from_xyz"] = mlp([feat, feat])
        sizes["rgb_from_xyzdir"] = mlp([feat + dir_in, feat // 2, 3])
        if (cfg.sun_v == "learned"
                or cfg.variant in ("s-nerf", "sat-nerf", "sps-nerf")):
            sizes["sun_v_net"] = mlp([feat + 3, feat // 2, feat // 2,
                                      feat // 2, 1])
        if cfg.indirect_light or cfg.variant in ("s-nerf", "sat-nerf",
                                                 "sps-nerf"):
            sizes["sky_color"] = mlp([3, feat // 2, 3])
        if cfg.beta:
            sizes["beta_from_xyz"] = mlp([feat + cfg.t_embedding_tau,
                                          feat // 2, 1])
        if cfg.normal in ("analystic_learned", "learned"):
            sizes["grad_from_xyz"] = mlp([feat, 3])
        if cfg.roughness:
            sizes["roughness_from_xyz"] = mlp([feat, feat // 2, 1])
        if cfg.func_m:
            sizes["k_from_xyz"] = mlp([feat, feat // 2, cfg.dim_rpv])
        if cfg.func_f:
            sizes["theta_rpv_from_xyz"] = mlp([feat, feat // 2, cfg.dim_rpv])
        if cfg.func_h == 1:
            sizes["rhoc_from_xyz"] = mlp([feat, feat // 2, cfg.dim_rpv])
        if cfg.hapke_b:
            sizes["b_from_xyz"] = mlp([feat, feat // 2, 1])
        if cfg.hapke_c:
            sizes["c_from_xyz"] = mlp([feat, feat // 2, 1])
        if cfg.hapke_theta:
            sizes["theta_from_xyz"] = mlp([feat, feat // 2, 1])
        super().__init__({
            name: nn.ModuleList([Dense(i, o, device) for i, o in dims])
            for name, dims in sizes.items()})
        self.cfg = cfg
        # a tensor-parallel trunk's layout (parallel/tensor.Layout): its
        # fc_net layers hold this rank's blocks
        self.tp = None


class Params(nn.Module):
    """The coarse network, the optional fine network and the optional
    transient embedding table t (vocab, tau), as the JAX package's params
    dict (parallel/train_step.create_train_state)."""

    def __init__(self, coarse: Network, fine: Optional[Network] = None,
                 t: Optional[torch.Tensor] = None):
        super().__init__()
        self.coarse = coarse
        self.fine = fine
        self.t = None if t is None else nn.Parameter(t)


def as_params(params) -> Params:
    """`params` as a Params: a bare Network stands for the coarse network
    alone (the entry points take either and convert here, once)."""
    return params if isinstance(params, Params) else Params(params)


def model_params(cfg: ModelConfig, n_importance: int = 0,
                 device=None) -> Params:
    """The parameter structure of a run, values unset: a Params of the
    coarse Network, the fine one where n_importance > 0 and the t table
    where cfg.beta.  On CUDA unless `device` names another."""
    from ..utils.device import resolve_device
    device = resolve_device(device)
    return Params(
        Network(cfg, device=device),
        Network(cfg, device=device) if n_importance > 0 else None,
        torch.empty(cfg.t_embedding_vocab, cfg.t_embedding_tau,
                    device=device) if cfg.beta else None)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                n_importance: int = 0, device=None) -> Params:
    """model_params drawn from `generator` in the JAX package's order:
    the coarse network, the fine one, the t table (create_train_state)."""
    coarse = init_network(cfg, generator, device=device)
    fine = (init_network(cfg, generator, device=device)
            if n_importance > 0 else None)
    return Params(coarse, fine, init_t_embedding(
        cfg.t_embedding_vocab, cfg.t_embedding_tau, generator,
        device=device) if cfg.beta else None)


def init_t_embedding(vocab: int, dim: int, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """The transient per-image embedding, torch.nn.Embedding's N(0, 1)
    (main.py:115), drawn from `generator`."""
    from ..utils.device import resolve_device
    draw = torch.randn((vocab, dim), generator=generator,
                       device=generator.device)
    return draw.to(resolve_device(device))


def model_config_for_variant(variant: str, **overrides) -> ModelConfig:
    """The defaults of each model variant (reference models/__init__.py
    load_model), as the JAX package's model_config_for_variant gives them;
    overrides replace any field.  ValueError for an unknown variant."""
    base: Dict = dict(variant=variant)
    if variant == "nerf":
        base.update(mapping=True, siren=False)           # NeRF class defaults
    elif variant == "s-nerf":
        base.update(siren=True, sun_v="learned", indirect_light=True)
    elif variant in ("sat-nerf", "sps-nerf"):
        base.update(siren=True, sun_v="learned", indirect_light=True,
                    beta=True)
    elif variant == "spsbrdf-nerf":
        base.update(siren=True)
    else:
        raise ValueError(f"model {variant} is not valid")
    base.update(overrides)
    return ModelConfig(**base)


def init_network(cfg: ModelConfig, generator: torch.Generator,
                 device=None) -> Network:
    """torch-style init: Linear U(+-1/sqrt(fan_in)) for weights and
    biases; siren trunks redraw the weights with sine_init /
    first_layer_sine_init (nerf.py:9-21).  The JAX package draws the same
    distributions from its own generator, so the values differ.  On CUDA
    unless `device` names another."""
    from ..utils.device import resolve_device
    net = Network(cfg, device=resolve_device(device))

    def uniform_(p, bound):
        draw = torch.rand(p.shape, generator=generator,
                          device=generator.device)
        with torch.no_grad():
            p.copy_((draw * 2.0 - 1.0) * bound)

    for name, layers in net.items():
        for i, layer in enumerate(layers):
            fan_in = layer.w.shape[1]
            bound = 1.0 / math.sqrt(fan_in)
            uniform_(layer.w, bound)
            uniform_(layer.b, bound)
            if cfg.siren and name == "fc_net":
                uniform_(layer.w, (1.0 / fan_in) if i == 0
                         else math.sqrt(6.0 / fan_in))
    return net


# ------------------------------------------------------------- primitives

def _linear(w, b, x, compute_dtype: str = "float32"):
    """Dense layer, with the JAX package's three dtype rules
    (network.py:72-91):
      'float32'      -> x @ w + b in f32;
      'bfloat16'     -> bf16 operands, f32 accumulation and f32 output
                        (the products of bf16 values are exact in f32, so
                        upcasting the rounded operands is the same math);
      'bfloat16_all' -> bf16 operands and a bf16 output, then a bf16 bias
                        add;
      'int8'         -> 'bfloat16_all': int8 applies to the trunk alone
                        (_trunk_features, _linear_int8); the heads are thin
                        matmuls over unbounded inputs."""
    if compute_dtype == "int8":
        compute_dtype = "bfloat16_all"
    if compute_dtype == "bfloat16_all":
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16).t()
                + b.to(torch.bfloat16))
    if compute_dtype == "bfloat16":
        return (x.to(torch.bfloat16).float()
                @ w.to(torch.bfloat16).float().t() + b.float())
    if compute_dtype == "float32":
        return x @ w.t() + b
    raise ValueError(f"compute_dtype={compute_dtype!r}")


class LaunchCount:
    """A launch count, kept as ops/cuda_build.CudaKernel keeps its own
    (under a lock: a multi-device server launches from threads)."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self.launches += 1


# the int8 products (torch._int_mm calls) of _linear_int8
INT8_MM = LaunchCount()
# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
INT8_MIN_ROWS = 17
INT8_ALIGN = 8


def int8_mm(xq, wq):
    """xq (M, K) @ wq (K, N), int8 x int8 -> int32, exact, through
    torch._int_mm: K is zero-padded to a multiple of INT8_ALIGN (zero
    columns of xq, zero rows of wq) and M to at least INT8_MIN_ROWS rows,
    the CUDA product's limits; the padding runs on every device, so the
    CPU covers it too.  N must be a multiple of INT8_ALIGN.  The second
    operand goes in as the transposed view of a row-major (N, K) tensor:
    cuBLASLt's int8 product takes a row-major first operand with a
    column-major second one, and refuses two row-major operands."""
    m, k = xq.shape
    n = wq.shape[1]
    if n % INT8_ALIGN:
        raise ValueError(f"int8 product with {n} output columns (not a "
                         f"multiple of {INT8_ALIGN})")
    kp, mp = _round_up(k, INT8_ALIGN), max(m, INT8_MIN_ROWS)
    w_nk = wq.t()
    if kp != k or mp != m:
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
        w_nk = torch.nn.functional.pad(w_nk, (0, kp - k))
    acc = torch._int_mm(xq.contiguous(), w_nk.contiguous().t())
    INT8_MM.add()
    return acc[:m]


def _linear_int8(w, b, x):
    """The serving-only int8 dense layer for inputs bounded in [-1, 1] (the
    JAX package's _linear_int8, network.py:94-119): every trunk input is
    the sine encoding or a siren activation, so x quantizes with the
    constant scale 1/127 (round(clip(x, -1, 1) * 127)); W per output
    channel with sw = max|W[:, j]| / 127; the product accumulates in int32
    (int8_mm) and dequantizes as acc * (sw / 127) + b in f32, rounded to
    bf16.  round() has no gradient: training refuses int8, and gradient
    consumers run on the bfloat16_all twin (grad_safe_cfg)."""
    xq = torch.round(torch.clamp(x.float(), -1.0, 1.0) * 127.0).to(
        torch.int8)
    wt = w.float().t()                                   # (in, out)
    sw = torch.amax(torch.abs(wt), 0, keepdim=True) / 127.0
    wq = torch.round(w.float() / torch.clamp(sw.t(), min=1e-20)).to(
        torch.int8).t()
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y = acc.float() * (sw / 127.0) + b.float()
    return y.reshape(*x.shape[:-1], y.shape[-1]).to(torch.bfloat16)


def _act(cfg: ModelConfig, x, first: bool = False):
    if cfg.siren:
        w0 = 30.0 if first else 1.0          # nerf.py:23-33,191
        if cfg.fast_sin:
            from ..ops.fast_math import fast_sin
            return fast_sin(w0 * x)
        return torch.sin(w0 * x)
    return torch.relu(x)


def softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0));
    torch.nn.functional.softplus switches to the identity above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------- forward

def _trunk_features(net: Network, cfg: ModelConfig, xyz):
    """Encoded xyz -> shared features (calc_features, spsbrdfnerf.py:636-646).
    The skip layer's concat([enc, h]) @ W is evaluated as
    enc @ W_top + h @ W_bot, as in the JAX package.  A tensor-parallel
    trunk (net.tp) runs the Megatron forward (_trunk_features_tp)."""
    enc = (positional_encoding(xyz, cfg.mapping_sizes[0], fast=cfg.fast_sin)
           if cfg.mapping else xyz)
    e_dim = enc.shape[-1]
    if int8_trunk(cfg):
        if net.tp is not None:
            raise ValueError("int8 serving takes whole weights, not a "
                             "tensor-parallel trunk")
        lin = _linear_int8
    else:
        def lin(w, b, x):
            return _linear(w, b, x, cfg.compute_dtype)
    if net.tp is not None:
        return _trunk_features_tp(net, cfg, enc, lin)
    h = enc
    for i, layer in enumerate(net["fc_net"]):
        if i in cfg.skips:
            z = (lin(layer.w[:, :e_dim], layer.b, enc)
                 + lin(layer.w[:, e_dim:], torch.zeros_like(layer.b), h))
            h = _act(cfg, z, first=False)
        else:
            h = _act(cfg, lin(layer.w, layer.b, h), first=(i == 0))
    return h


def _trunk_features_tp(net: Network, cfg: ModelConfig, enc, lin):
    """The trunk over a model group, Megatron's forward on this rank's
    blocks (parallel/tensor.py): a column-parallel layer takes its
    replicated input through `copy` and gives its block of the outputs; a
    row-parallel layer multiplies its block of the inputs, the partial
    products are summed over the model group (`reduce`) and the bias is
    added once, after the sum; the activation between them runs on the
    block.  Where a column layer follows a column layer (a skip at an odd
    index), or ends the trunk, the blocks are joined first (`gather`).  x
    enters layer 0 and the skip layer through `copy`, whose backward sums
    each rank's part of the sigma gradient."""
    from ..parallel.tensor import (COLUMN, copy_to, gather_from, reduce_from,
                                   trunk_spec)
    tp = net.tp
    e_dim = enc.shape[-1]
    h, block = enc, False
    for i, layer in enumerate(net["fc_net"]):
        if trunk_spec(i, "w", tp.skips) == COLUMN:
            if block:
                h = gather_from(h, tp)
            x = copy_to(h, tp)
            if i in cfg.skips:
                z = (lin(layer.w[:, :e_dim], layer.b, copy_to(enc, tp))
                     + lin(layer.w[:, e_dim:], torch.zeros_like(layer.b),
                           x))
            else:
                z = lin(layer.w, layer.b, x)
            block = True
        else:
            part = lin(layer.w, torch.zeros_like(layer.b), h)
            z = reduce_from(part, tp) + layer.b.to(part.dtype)
            block = False
        h = _act(cfg, z, first=(i == 0))
    return gather_from(h, tp) if block else h


def _head(net: Network, cfg: ModelConfig, name, x, final=None,
          act_relu=False):
    """An MLP head: hidden layers use the model activation (ReLU for
    sky_color, snerf.py:135-140), then an optional final nonlinearity.
    Outputs return to f32 for the compositing and BRDF math."""
    layers = net[name]
    h = x
    for i, layer in enumerate(layers):
        h = _linear(layer.w, layer.b, h, cfg.compute_dtype)
        if i < len(layers) - 1:
            h = torch.relu(h) if act_relu else _act(cfg, h, first=False)
    if final == "sigmoid":
        h = torch.sigmoid(h)
    elif final == "softplus":
        h = softplus(h)
    return h.float()


def _sun_v_head(net, cfg: ModelConfig, feats, sun_d):
    """sun_v_net on concat([feats, sun_d]) (snerf.py:126-131)."""
    x = torch.cat([feats, sun_d], -1)
    return _head(net, cfg, "sun_v_net", x, final="sigmoid")


def sigma_fn(net: Network, cfg: ModelConfig, xyz):
    """Density only (sigma_only=True path, spsbrdfnerf.py:682-685)."""
    feats = _trunk_features(net, cfg, xyz)
    return _head(net, cfg, "sigma_from_xyz", feats, final="softplus")[..., 0]


def sigma_and_sun_v(net: Network, cfg: ModelConfig, xyz, sun_d):
    """Density and the learned sun visibility from one trunk forward: the
    program of the solar-correction pass along sun rays (the reference's
    intended inference_sun, rendering.py:281)."""
    feats = _trunk_features(net, cfg, xyz)
    sigma = _head(net, cfg, "sigma_from_xyz", feats, final="softplus")[..., 0]
    f = net["feats_from_xyz"][0]
    xyz_features = _linear(f.w, f.b, feats, cfg.compute_dtype)
    return sigma, _sun_v_head(net, cfg, xyz_features, sun_d)


def int8_trunk(cfg: ModelConfig) -> bool:
    """Whether the trunk's sigma passes run as int8 products (serving):
    the sine encoding and every siren activation lie in [-1, 1], so the
    whole trunk runs int8; a raw-xyz trunk (mapping off, or 0
    frequencies: the encoding passes xyz through) is unbounded and stays
    at bfloat16_all rather than clipping coordinates (network.py:226-235)."""
    return (cfg.compute_dtype == "int8" and cfg.siren and cfg.mapping
            and cfg.mapping_sizes[0] > 0)


def grad_safe_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of a path that differentiates the trunk: int8's round()
    has no gradient, so under int8 such a path runs on the bfloat16_all
    twin (network.py:294-300); any other dtype is returned as it is."""
    if cfg.compute_dtype == "int8":
        import dataclasses
        return dataclasses.replace(cfg, compute_dtype="bfloat16_all")
    return cfg


def refuse_kernels(net: Network) -> None:
    """A tensor-parallel trunk holds blocks, and the fused kernels take
    whole weights: a step or render on such a trunk is built with the
    kernels off (parallel/tensor.kernels_off), and a kernel gate that
    meets one raises rather than run on the blocks."""
    if net.tp is not None:
        raise ValueError("a tensor-parallel trunk runs no fused kernel: "
                         "build the render config with "
                         "parallel.tensor.kernels_off")


def analytic_normals(net: Network, cfg: ModelConfig, xyz):
    """-normalize(grad_xyz sigma), calc_normals (spsbrdfnerf.py:648-660):
    the gradient of the summed density (sigma at a point depends on that
    point alone), with a graph for the loss's second order when grad mode
    is on; under int8 on the bfloat16_all twin (grad_safe_cfg)."""
    cfg = grad_safe_cfg(cfg)
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = xyz if xyz.requires_grad else xyz.detach().requires_grad_(True)
        (grad_x,) = torch.autograd.grad(sigma_fn(net, cfg, x).sum(), x,
                                        create_graph=create)
    return -l2_normalize(grad_x.float())


def apply_network(net: Network, cfg: ModelConfig, xyz, dirs=None,
                  sun_d=None, t_emb=None, apply_brdf: bool = False,
                  apply_theta: bool = False,
                  nr_lr: bool = False) -> Dict[str, torch.Tensor]:
    """Full forward over flat points xyz (N, 3); returns named heads with
    the semantics of SpSBRDFNeRF.forward (spsbrdfnerf.py:662-757).
    t_emb (N, tau): the points' transient embeddings, which the beta head
    takes."""
    out: Dict[str, torch.Tensor] = {}
    feats = _trunk_features(net, cfg, xyz)
    out["sigma"] = _head(net, cfg, "sigma_from_xyz", feats,
                         final="softplus")[..., 0]
    return _heads_from_feats(out, net, cfg, feats, dirs, sun_d, t_emb,
                             apply_brdf, apply_theta, nr_lr)


def apply_network_with_normals(net: Network, cfg: ModelConfig, xyz,
                               dirs=None, sun_d=None, t_emb=None,
                               apply_brdf: bool = False,
                               apply_theta: bool = False,
                               nr_lr: bool = False,
                               fused_trunk: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """apply_network plus analytic density-gradient normals from ONE trunk
    pass: sigma, feats and grad_xyz sigma together.

    fused_trunk: the trunk, sigma head and the sigma gradient come from the
    fused trunk-with-gradient kernel (ops/fused_trunk_vjp.py) when the
    architecture fits it (kernel_supports); otherwise from autograd.  With
    BRDFNERF_FUSED_HEADS set (read per call, as the JAX package does) and
    the flagship head set (heads_kernel_supports), the heads run inside the
    kernel pair too (ops/fused_trunk_heads.py): on the card K4/K5 at every
    width and encoding K1-K3 take (the fused or the layer-major pair at
    fused_mlp.kernel_cfg's width), on the CPU their twins.  K4/K5 take no
    t-embedding: with t_emb the beta head runs on K2's features.

    The trunk is differentiated per sample, so under int8 it runs wholly on
    the bfloat16_all twin (grad_safe_cfg), applied before the kernel gate
    as in the JAX package (network.py:350-357): an int8 request's main pass
    runs K2, or K4 with the switch, at bfloat16_all."""
    grad_cfg = grad_safe_cfg(cfg)
    if fused_trunk:
        refuse_kernels(net)
        from ..ops.fused_mlp import kernel_supports
        fused_trunk = kernel_supports(grad_cfg)
    if fused_trunk:
        if os.environ.get("BRDFNERF_FUSED_HEADS"):
            from ..ops.fused_trunk_heads import (fused_trunk_heads_with_grad,
                                                 heads_kernel_supports)
            if heads_kernel_supports(grad_cfg, net, dirs=dirs, t_emb=t_emb,
                                     apply_brdf=apply_brdf,
                                     apply_theta=apply_theta, nr_lr=nr_lr):
                return fused_trunk_heads_with_grad(net, grad_cfg, xyz)
        from ..ops.fused_trunk_vjp import fused_trunk_with_grad
        sigma, feats, grad_x = fused_trunk_with_grad(net, grad_cfg, xyz)
    else:
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            x = xyz if xyz.requires_grad else xyz.detach().requires_grad_(True)
            feats = _trunk_features(net, grad_cfg, x)
            sigma = _head(net, grad_cfg, "sigma_from_xyz", feats,
                          final="softplus")[..., 0]
            (grad_x,) = torch.autograd.grad(sigma.sum(), x,
                                            create_graph=create)
        if not create:
            feats, sigma = feats.detach(), sigma.detach()
    out: Dict[str, torch.Tensor] = {"sigma": sigma}
    out["normal_an"] = -l2_normalize(grad_x.float())
    return _heads_from_feats(out, net, cfg, feats, dirs, sun_d, t_emb,
                             apply_brdf, apply_theta, nr_lr)


def _merged_sigmoid_heads(net: Network, cfg: ModelConfig, x, names):
    """Several 2-layer sigmoid-final heads sharing one input, evaluated as
    ONE concatenated first layer + ONE block-diagonal second layer, the
    JAX package's formulation (the per-slice math is _head's).  Returns one
    (N, out_dim_i) tensor per name."""
    l1 = [net[n][0] for n in names]
    l2 = [net[n][1] for n in names]
    hids = [p.w.shape[0] for p in l1]
    dims = [p.w.shape[0] for p in l2]
    w1 = torch.cat([p.w for p in l1], 0)            # (sum(hids), F)
    b1 = torch.cat([p.b for p in l1])
    h = _act(cfg, _linear(w1, b1, x, cfg.compute_dtype), first=False)
    w2 = torch.zeros(sum(dims), sum(hids), dtype=l2[0].w.dtype,
                     device=l2[0].w.device)
    ho = do = 0
    for p, hid, dim in zip(l2, hids, dims):
        w2[do:do + dim, ho:ho + hid] = p.w
        ho += hid
        do += dim
    b2 = torch.cat([p.b for p in l2])
    y = torch.sigmoid(_linear(w2, b2, h, cfg.compute_dtype)).float()
    return list(torch.split(y, dims, -1))


def _heads_from_feats(out: Dict, net: Network, cfg: ModelConfig, feats,
                      dirs=None, sun_d=None, t_emb=None,
                      apply_brdf: bool = False, apply_theta: bool = False,
                      nr_lr: bool = False) -> Dict[str, torch.Tensor]:
    xyz_features = _linear(net["feats_from_xyz"][0].w,
                           net["feats_from_xyz"][0].b, feats,
                           cfg.compute_dtype)
    if cfg.input_sizes[1] > 0 and dirs is not None:
        enc_dir = (positional_encoding(dirs, cfg.mapping_sizes[1],
                                       fast=cfg.fast_sin)
                   if cfg.mapping else dirs)
        rgb_in = torch.cat([xyz_features, enc_dir], -1)
    else:
        rgb_in = xyz_features

    # RPV(111): the three RPV heads run as one merged matmul pair
    rpv_names = ("k_from_xyz", "theta_rpv_from_xyz", "rhoc_from_xyz")
    merged_rpv = (apply_brdf and cfg.rpv and cfg.func_m and cfg.func_f
                  and cfg.func_h == 1
                  and all(n in net and len(net[n]) == 2 for n in rpv_names))
    out["rgb"] = _head(net, cfg, "rgb_from_xyzdir", rgb_in, final="sigmoid")

    if "sun_v_net" in net and sun_d is not None:
        out["sun_v"] = _sun_v_head(net, cfg, xyz_features, sun_d)
    if "sky_color" in net and sun_d is not None:
        out["sky"] = _head(net, cfg, "sky_color", sun_d, final="sigmoid",
                           act_relu=True)
    if cfg.beta and t_emb is not None:
        # concat promotes bf16 features to t's f32, as jnp.concatenate does
        dt = torch.promote_types(xyz_features.dtype, t_emb.dtype)
        beta_in = torch.cat([xyz_features.to(dt), t_emb.to(dt)], -1)
        out["beta"] = _head(net, cfg, "beta_from_xyz", beta_in,
                            final="softplus")
    if nr_lr and "grad_from_xyz" in net:
        g = net["grad_from_xyz"][0]
        grad_lr = _linear(g.w, g.b, feats, cfg.compute_dtype)
        out["normal_lr"] = -l2_normalize(grad_lr.float())

    if not apply_brdf:
        return out

    def tile3(v):
        return v.repeat(*((1,) * (v.ndim - 1)), 3) if v.shape[-1] == 1 \
            else v

    if cfg.roughness:
        out["roughness"] = _head(net, cfg, "roughness_from_xyz",
                                 xyz_features, final="sigmoid")
    elif cfg.rpv:
        k = th = rc = None
        if merged_rpv:
            k, th, rc = _merged_sigmoid_heads(net, cfg, xyz_features,
                                              rpv_names)
        else:
            if cfg.func_m:
                k = _head(net, cfg, "k_from_xyz", xyz_features,
                          final="sigmoid")
            if cfg.func_f:
                th = _head(net, cfg, "theta_rpv_from_xyz", xyz_features,
                           final="sigmoid")
            if cfg.func_h == 1:
                rc = _head(net, cfg, "rhoc_from_xyz", xyz_features,
                           final="sigmoid")
        if k is not None:
            out["rpv_k"] = tile3((k - 0.5) * 2.0 + 1.0)        # [0, 2]
        if th is not None:
            out["rpv_theta"] = tile3((th - 0.5) * 2.0)          # [-1, 1]
        if rc is not None:
            out["rpv_rhoc"] = tile3(rc)                          # [0, 1]
    else:
        hp_names = [n for n, on in (("b_from_xyz", cfg.hapke_b),
                                    ("c_from_xyz", cfg.hapke_c),
                                    ("theta_from_xyz",
                                     apply_theta and cfg.hapke_theta)) if on]
        if len(hp_names) >= 2 and all(n in net and len(net[n]) == 2
                                      for n in hp_names):
            # one merged matmul pair, as the RPV heads
            vals = dict(zip(hp_names, _merged_sigmoid_heads(
                net, cfg, xyz_features, tuple(hp_names))))
        else:
            vals = {n: _head(net, cfg, n, xyz_features, final="sigmoid")
                    for n in hp_names}
        if "b_from_xyz" in vals:
            out["hpk_b"] = tile3(vals["b_from_xyz"])
        if "c_from_xyz" in vals:
            out["hpk_c"] = tile3(vals["c_from_xyz"])
        if "theta_from_xyz" in vals:
            out["hpk_theta"] = (vals["theta_from_xyz"]
                                * (math.pi * 30.0 / 180.0))   # [0, 30 deg]
    return out
