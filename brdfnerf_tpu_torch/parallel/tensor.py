"""Tensor parallelism over a 2-D (data, model) mesh of ranks (counterpart
of the JAX package's parallel/tensor.py).

The reference's 8x512 trunk fits one card many times over; tensor
parallelism exists for the scaled trunks (--fc_feat 2048, --fc_layers 12:
52.7 M trunk parameters), whose parameters, gradients and Adam moments it
cuts over the ranks of a model group.  The scheme is the JAX package's,
the alternating column / row split of Megatron:

  layer 2k and every skip layer   column-parallel: a block of the
                                  layer's outputs, with its bias block
  layer 2k+1                      row-parallel: a block of its inputs,
                                  the bias whole

The port stores Dense.w as (out, in) and the npz (and the JAX package) as
(in, out), so the JAX package's column split P(None, 'model') is a block
of the port's rows and its row split P('model', None) a block of the
port's columns.  A skip layer is column-parallel whatever its index, so
its enc @ W_top + h @ W_bot split at the encoding's width stays within a
rank.  Heads, the t table and the optimizer's count are replicated.  One
rule (spec_of, cut) serves the parameters, their gradients and Adam's
moments, all keyed by the npz key.

Where GSPMD places the collectives in the JAX package, the port's trunk
(models/network._trunk_features) calls hand-written ones, the Megatron
set of autograd Functions: `copy` (identity forward, all-reduce backward)
on the replicated input of a column layer, `reduce` (all-reduce forward,
identity backward) on a row layer's partial product, and `gather`
(all-gather forward, own block backward) where a column layer follows a
column layer or ends the trunk, with `scatter` (own block forward,
all-gather backward) as gather's adjoint.  Each backward is another
Function's apply (copy's is reduce, reduce's is copy, gather's is
scatter, scatter's is gather), so the trunk's sigma gradient, which the
losses differentiate again (the analytic normals), has a double backward
through the collectives.

The fused kernels K1-K5 run all the trunk's layers in one launch, so
nothing could place the all-reduce a layer pair needs: a tensor-parallel
run takes them off (kernels_off), decided from the configuration before
the first step and named on the train CLI's [kernels] line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

COLUMN, ROW, REPLICATED = "column", "row", "replicated"
SEP = "/"


def tp_mesh(n_data: int, n_model: int, rank: int, store_path: str, device,
            backend: Optional[str] = None):
    """This rank's place on a (data, model) mesh of n_data * n_model ranks,
    'model' innermost (rank = d * n_model + m), joined through the
    FileStore at store_path (parallel/mesh.init_mesh)."""
    from .mesh import init_mesh
    return init_mesh(rank, n_data * n_model, store_path, device, backend,
                     n_model=n_model)


def model_axis_size(mesh) -> int:
    """The size of the 'model' axis (1 when absent: no tensor
    parallelism)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get("model", 1))


def data_axis_size(mesh) -> int:
    """The size of the 'data' axis: the batch-scaling factor on any
    mesh."""
    if mesh is None:
        return 1
    return int(mesh.shape["data"])


def trunk_spec(layer: int, kind: str, skips: Sequence[int] = (4,)) -> str:
    """The split of trunk layer `layer`'s `kind` ('w' or 'b'): COLUMN for
    the weight and bias of an even or skip layer, ROW for an odd layer's
    weight, REPLICATED for its bias."""
    col = layer % 2 == 0 or layer in tuple(skips)
    if kind == "w":
        return COLUMN if col else ROW
    return COLUMN if col else REPLICATED


def _trunk_leaf(key: str) -> Optional[Tuple[int, str]]:
    """(layer, 'w' | 'b') of an npz key under a network's fc_net
    ('coarse/fc_net/3/w', 'fine/fc_net/0/b'), else None."""
    parts = key.split(SEP)
    for j in range(len(parts) - 2):
        if (parts[j] == "fc_net" and parts[j + 1].isdigit()
                and parts[j + 2] in ("w", "b")):
            return int(parts[j + 1]), parts[j + 2]
    return None


def spec_of(key: str, skips: Sequence[int] = (4,)) -> str:
    """The split of the state leaf under npz key `key`: a parameter, its
    gradient or one of its Adam moments."""
    hit = _trunk_leaf(key)
    return REPLICATED if hit is None else trunk_spec(*hit, skips)


def cut_axis(key: str, skips: Sequence[int] = (4,),
             npz: bool = False) -> Optional[int]:
    """The axis along which the leaf under `key` is cut, None where it is
    replicated: the port's (out, in) weights and its biases, or with npz
    the (in, out) weights of the npz layout."""
    spec = spec_of(key, skips)
    if spec == REPLICATED:
        return None
    if not key.endswith(f"{SEP}w"):
        return 0
    return int(spec == ROW) if not npz else int(spec == COLUMN)


def cut(key: str, value, n_model: int, m: int, skips: Sequence[int] = (4,),
        npz: bool = False):
    """Model rank m's block of the whole leaf `value` (a tensor or an
    array) under `key`; a replicated leaf is returned as it is."""
    axis = cut_axis(key, skips, npz)
    if axis is None:
        return value
    n = value.shape[axis]
    if n % n_model:
        raise ValueError(f"{key}: {n} does not split over {n_model} model "
                         "ranks")
    per = n // n_model
    index = [slice(None)] * value.ndim
    index[axis] = slice(m * per, (m + 1) * per)
    return value[tuple(index)]


def shard_flat(flat: Dict[str, np.ndarray], n_model: int, m: int,
               skips: Sequence[int] = (4,)) -> Dict[str, np.ndarray]:
    """Model rank m's blocks of a whole flat dict in the npz layout (the
    JAX package's addressable shard of each leaf)."""
    return {k: (v if k.startswith("__") else
                np.ascontiguousarray(cut(k, v, n_model, m, skips, True)))
            for k, v in flat.items()}


class Layout(NamedTuple):
    """A rank's tensor-parallel layout: the mesh whose model group shares
    the trunk, and the skips that make a layer column-parallel.  A
    network whose trunk holds blocks carries it as `Network.tp`."""
    mesh: object
    skips: Tuple[int, ...]

    @property
    def n_model(self) -> int:
        return self.mesh.n_model

    @property
    def m(self) -> int:
        return self.mesh.model_rank


def state_shardings(mesh, skips: Sequence[int] = (4,)) -> Optional[Layout]:
    """The layout of a state on `mesh` (the JAX package's state_shardings):
    None where the model axis is 1."""
    if model_axis_size(mesh) <= 1:
        return None
    return Layout(mesh, tuple(skips))


def kernels_off(rcfg):
    """rcfg with K1 (use_pallas) and K2-K5 (fused_trunk) off, as a
    tensor-parallel run takes them."""
    return dataclasses.replace(rcfg, use_pallas=False, fused_trunk=False)


# ------------------------------------------------------- the collectives

class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over the model group backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    """All-reduce over the model group forward (bfloat16 partials summed
    in float32), identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.float() if x.dtype == torch.bfloat16 else x.clone()
        return mesh.model_all_reduce_(y).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh), None


class _Gather(torch.autograd.Function):
    """All-gather of the blocks along the last axis forward, this rank's
    block backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(mesh.model_all_gather(x), -1)

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.mesh), None


class _Scatter(torch.autograd.Function):
    """This rank's block of the last axis forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        per = x.shape[-1] // mesh.n_model
        m = mesh.model_rank
        return x[..., m * per:(m + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.mesh), None


def copy_to(x, layout: Layout):
    """x, replicated, entering a column-parallel layer."""
    return _Copy.apply(x, layout.mesh)


def reduce_from(x, layout: Layout):
    """A row-parallel layer's partial products summed over the model
    group."""
    return _Reduce.apply(x, layout.mesh)


def gather_from(x, layout: Layout):
    """A column-parallel layer's output blocks joined whole."""
    return _Gather.apply(x, layout.mesh)


# ------------------------------------------------ cutting and gathering

def _networks(params):
    from ..models.network import as_params
    params = as_params(params)
    return [(name, net) for name, net in (("coarse", params.coarse),
                                          ("fine", params.fine))
            if net is not None]


def shard_params(params, layout: Layout):
    """Cut every trunk layer of params (a Params of whole weights) to
    this rank's blocks, in place, and mark each network with the layout
    (Network.tp); returns params."""
    for _, net in _networks(params):
        if net.tp is not None:
            raise ValueError("the network is already sharded")
        for i, layer in enumerate(net["fc_net"]):
            for kind in ("w", "b"):
                key = f"fc_net{SEP}{i}{SEP}{kind}"
                if cut_axis(key, layout.skips) is None:
                    continue
                block = cut(key, getattr(layer, kind).detach(),
                            layout.n_model, layout.m, layout.skips)
                setattr(layer, kind,
                        torch.nn.Parameter(block.contiguous().clone()))
        net.tp = layout
    return params


def gather_tensor(key: str, t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The whole leaf under `key` from this rank's block `t` (the port's
    layout), gathered over the model group; a replicated leaf is
    returned as it is.  Every rank of the model group calls it."""
    axis = cut_axis(key, layout.skips)
    if axis is None:
        return t
    return torch.cat(layout.mesh.model_all_gather(t.detach()), axis)


def whole_params(params, layout: Layout):
    """A new Params of whole weights (no layout) gathered from params'
    blocks over the model group, on the same device.  Every rank of the
    model group calls it."""
    from ..models.network import Network, Params, as_params
    from ..utils.checkpoint import named_flat
    out = {}
    for name, net in _networks(params):
        whole = Network(net.cfg, device=next(net.parameters()).device)
        blocks = named_flat(net)
        with torch.no_grad():
            for key, p in named_flat(whole).items():
                p.copy_(gather_tensor(key, blocks[key], layout))
        out[name] = whole
    t = as_params(params).t
    return Params(out["coarse"], out.get("fine"),
                  None if t is None else t.detach().clone())


def _moments(opt, p) -> Dict:
    return opt.state.get(p, {}) if opt is not None else {}


def shard_state(state, optimizer, layout: Layout):
    """A TrainState of whole weights and moments -> this rank's: the
    parameters cut (shard_params), a new torch optimizer over them
    (optimizer.init) holding the blocks of the whole one's Adam moments
    and its count.  The JAX package's shard_state."""
    from ..utils.checkpoint import named_flat
    from .train_step import TrainState
    params, opt, step = state
    old = {k: _moments(opt, p) for k, p in named_flat(params).items()}
    shard_params(params, layout)
    new_opt = optimizer.init(params)
    if new_opt is not None:
        for key, p in named_flat(params).items():
            st = old[key]
            if not st:
                continue
            new_opt.state[p] = {
                "step": st["step"].clone(),
                **{name: cut(key, st[name], layout.n_model, layout.m,
                             layout.skips).contiguous().clone()
                   for name in ("exp_avg", "exp_avg_sq")}}
    return TrainState(params, new_opt, step)


def gather_state(state, layout: Layout):
    """This rank's TrainState -> the whole one (the parameters and Adam's
    moments gathered over the model group, in a plain torch.optim.Adam
    over the whole parameters the sharded optimizer trains), for
    validation and checkpoints (utils/checkpoint.save_opt_state writes its
    moments).  Every rank of the model group calls it."""
    from ..utils.checkpoint import named_flat
    from .train_step import TrainState
    params, opt, step = state
    whole = whole_params(params, layout)
    if opt is None:
        return TrainState(whole, None, step)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    parts = named_flat(params)
    pairs = [(k, parts[k], w) for k, w in named_flat(whole).items()
             if id(parts[k]) in trained]
    whole_opt = torch.optim.Adam([w for _, _, w in pairs],
                                 lr=opt.param_groups[0]["lr"],
                                 betas=(0.9, 0.999), eps=1e-8)
    for key, p, w in pairs:
        st = _moments(opt, p)
        if st:
            whole_opt.state[w] = {
                "step": st["step"].clone(),
                **{name: gather_tensor(key, st[name], layout)
                   for name in ("exp_avg", "exp_avg_sq")}}
    return TrainState(whole, whole_opt, step)


def trunk_bytes(params) -> int:
    """The bytes of the trunk layers' parameters this rank holds (its
    blocks under tensor parallelism); their gradient and each Adam moment
    take as many again."""
    return sum(p.numel() * p.element_size()
               for _, net in _networks(params)
               for p in net["fc_net"].parameters())
