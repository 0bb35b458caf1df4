"""The train step and the render step (counterpart of the JAX package's
parallel/train_step.py).

The JAX package compiles render, losses, schedule gates and the optimizer
update into one program; here they run eagerly in that order, and the
trunk's differentiated pass goes through the fused kernels K2/K3
(ops/fused_trunk_vjp.TrunkCore) when rcfg.fused_trunk is on, or K4/K5 with
the flagship heads (ops/fused_trunk_heads.TrunkHeadsCore) when
BRDFNERF_FUSED_HEADS is set too.  Schedule gates
are plain booleans computed on the host from the step count, as the JAX
package computes them in-program (gates_from_step).

make_scan_train_step runs N fused steps per call as a plain loop on the
device (the JAX package's lax.scan of the same steps).

Random draws: the JAX package folds the step into a base key; here each
step draws from a torch.Generator seeded from (seed, step), or takes the
draws it is handed (a test hands in the JAX package's; draws["kp"] are
those of sat-nerf's keypoint render).

Data parallelism (mesh: a parallel/mesh.Mesh, one process a rank): each
rank takes its contiguous block of the global batch (its block of the
index vector), the rows of the global batch's draws that are its rays'
(render.batch_draws from the step's generator, or the global draws handed
in), and the global batch's first ray, which the render reads
(RenderInputs.ray0, broadcast from rank 0).  Its loss is its share of the
global loss (losses.py), so the ranks' gradients, all-reduced, are the
global gradient; Adam then steps identically on every rank.  A step over
N ranks is the one-device step on the global batch up to the order of its
sums.

Tensor parallelism (mesh: a (data, model) mesh, parallel/tensor.py): the
batch splits over the data axis alone, so every rank of a model group
takes the same block and draws; the state holds this rank's blocks of the
trunk (create_train_state's layout, tensor.shard_state) and its Adam
moments for them; the trunk's forward and backward run the Megatron
collectives over the model group (models/network._trunk_features_tp); the
gradients all-reduce over the data group.  The step runs with K1-K5 off
(tensor.kernels_off).  A step over a (D, T) mesh is the one-device step
on the global batch up to the order of its sums.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, RenderConfig, TrainConfig
from ..models.network import Params, as_params, init_params, model_params
from ..render.render import RenderInputs, render_rays
from .. import losses as L
from ..metrics import psnr as psnr_metric


class TrainGates(NamedTuple):
    """The schedule gates of one step (main.py:60-63,202-230)."""
    cos_irra_on: bool     # train_steps > cos_irra_on
    ds_on: bool           # train_steps < ds_drop
    nrrg_on: bool         # train_steps > nrrg_on
    beta_warmup: bool     # epoch < first_beta_epoch -> loss without beta
    hs_on: bool           # epoch > 2


class GateSchedule(NamedTuple):
    """Schedule thresholds (fraction * max_steps, precomputed by the
    trainer) from which each step's gates follow."""
    t_cos_irra: float
    t_ds_drop: float
    t_nrrg: float
    steps_per_epoch: int
    first_beta_epoch: int


def gates_from_step(step: int, sched: GateSchedule) -> TrainGates:
    """main.py:60-63,202-230 schedule comparisons."""
    epoch = step // sched.steps_per_epoch
    return TrainGates(
        cos_irra_on=step > sched.t_cos_irra,
        ds_on=step < sched.t_ds_drop,
        nrrg_on=step > sched.t_nrrg,
        beta_warmup=epoch < sched.first_beta_epoch,
        hs_on=epoch > 2)


class TrainState(NamedTuple):
    """The parameters (a models.network.Params), the torch optimizer
    holding Adam's moments, and the number of updates done."""
    params: Params
    opt_state: torch.optim.Optimizer
    step: int


def _lr_schedule(tcfg: TrainConfig, steps_per_epoch: int
                 ) -> Callable[[int], float]:
    """optax's exponential_decay(staircase) after an optional
    linear_schedule warmup, joined at the warmup's end (join_schedules):
    update k uses lr * gamma^floor((k - warm) / spe) past the warmup and
    lr/10 -> lr linearly within it.  Values are float32, as optax's are;
    the staircase's power is the float64 one rounded, which can differ from
    XLA's float32 pow in the last place."""
    spe = max(1, steps_per_epoch)
    warm = tcfg.lr_warmup_steps
    if warm == -1:
        warm = 2 * spe
    elif warm < 0:          # -2 = explicitly off
        warm = 0

    def decay(k: int) -> float:
        return tcfg.lr * tcfg.lr_gamma ** math.floor(k / spe)

    def sched(k: int) -> float:
        if k < warm:
            # linear_schedule's own float32 arithmetic, so the ramp is
            # optax's bit for bit
            f32 = np.float32
            frac = f32(1.0) - f32(min(max(k, 0), warm)) / f32(warm)
            v = f32(tcfg.lr * 0.1 - tcfg.lr) * frac + f32(tcfg.lr)
        else:
            v = decay(k - warm)
        return float(np.float32(v))
    return sched


class Optimizer:
    """Adam (optax.adam's defaults) with the per-epoch staircase of
    make_optimizer; `step(opt, k)` applies update k, counting updates as
    optax does.  Parameters whose npz key starts with a `frozen` prefix
    ('all': every one) are left out, as the JAX Trainer's
    optax.multi_transform with set_to_zero leaves them unchanged; with
    nothing left to train, `init` gives None and a step changes nothing."""

    def __init__(self, schedule: Callable[[int], float],
                 frozen: Optional[Sequence[str]] = None):
        self.schedule = schedule
        self.frozen = list(frozen or ())

    def init(self, net: torch.nn.Module) -> Optional[torch.optim.Optimizer]:
        from ..utils.checkpoint import freeze_mask, named_flat
        mask = freeze_mask(net, self.frozen)
        params = [p for k, p in named_flat(net).items() if mask[k]]
        if not params:
            return None
        return torch.optim.Adam(params, lr=self.schedule(0),
                                betas=(0.9, 0.999), eps=1e-8,
                                fused=params[0].is_cuda)

    def step(self, opt: Optional[torch.optim.Optimizer], k: int) -> None:
        if opt is None:
            return
        # a parameter the loss does not reach gets a zero grad, as under
        # jax.grad: its moments decay and its step count advances with
        # every other's (torch.optim.Adam would skip it)
        for group in opt.param_groups:
            group["lr"] = self.schedule(k)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()


def make_optimizer(tcfg: TrainConfig, steps_per_epoch: int,
                   frozen: Optional[Sequence[str]] = None):
    """Adam + per-epoch StepLR gamma (main.py:147-168,
    train_utils.py:153-155), with the optional linear warmup
    (tcfg.lr_warmup_steps; -1 = two epochs), over the parameters outside
    `frozen`.  Returns (optimizer, schedule)."""
    sched = _lr_schedule(tcfg, steps_per_epoch)
    return Optimizer(sched, frozen), sched


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig,
                       steps_per_epoch: int, seed: int = 0,
                       flat: Optional[Dict[str, np.ndarray]] = None,
                       n_importance: int = 0, device=None,
                       frozen: Optional[Sequence[str]] = None,
                       layout=None):
    """A fresh TrainState and its Optimizer.  The parameters are the coarse
    network, with the fine one where n_importance > 0 and the t table where
    mcfg.beta (models.network.model_params), drawn from a torch.Generator
    seeded with `seed` in that order, or taken from `flat` (the npz
    layout, e.g. the JAX package's params through
    utils.checkpoint._flatten), which must hold exactly those.  On CUDA
    unless `device` names another.  `frozen`: key prefixes the optimizer
    leaves out (Optimizer).  layout (parallel/tensor.Layout): the whole
    parameters are cut to this rank's blocks before the optimizer is made
    over them (every rank starts from the same whole weights)."""
    from ..utils.checkpoint import load_params
    from ..utils.device import resolve_device
    device = resolve_device(device)
    if flat is not None:
        net = load_params(model_params(mcfg, n_importance, device=device),
                          flat)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        net = init_params(mcfg, gen, n_importance, device=device)
    if layout is not None:
        from .tensor import shard_params
        shard_params(net, layout)
    opt, _ = make_optimizer(tcfg, steps_per_epoch, frozen)
    return TrainState(net, opt.init(net), 0), opt


def compute_losses(net, mcfg: ModelConfig, rcfg: RenderConfig,
                   tcfg: TrainConfig, batch: Dict, gates: TrainGates,
                   draws: Optional[Dict] = None,
                   generator: Optional[torch.Generator] = None,
                   mesh=None):
    """Full loss of one batch (training_step semantics, main.py:230-327).
    Returns (loss, (terms, aux)).  With `kp_rays` in the batch (sat-nerf's
    keypoint store, kp_depths and kp_ts beside), a second render of those
    rays feeds the keypoint depth loss.  On a mesh of several ranks the
    batch is this rank's block, the loss and terms are its shares of the
    global ones and aux holds the global metrics (losses.py); `ray0` and
    `kp_ray0` in the batch stand for the global batches' first rays."""
    draws = draws or {}
    inp = RenderInputs(
        rays=batch["rays"], ts=batch.get("ts"),
        valid_depth=batch.get("valid_depth"),
        target_depths=batch.get("depths"),
        target_std=batch.get("depth_std"),
        cos_irra_on=gates.cos_irra_on, ray0=batch.get("ray0"))
    results = render_rays(net, mcfg, rcfg, inp, train=True, draws=draws,
                          generator=generator)
    rgbs = batch["rgbs"]
    typ = "fine" if "rgb_fine" in results else "coarse"
    terms: Dict[str, torch.Tensor] = {}

    # color loss; the beta warmup takes the s-nerf (no-beta) loss
    # (main.py:237-238)
    loss_fn = L.load_loss(mcfg.variant, mcfg.beta, tcfg.sc_lambda,
                          tcfg.lambda_rgb, mesh=mesh)
    loss, d = loss_fn(results, rgbs)
    if (mcfg.beta and mcfg.variant in ("sat-nerf", "sps-nerf")
            and gates.beta_warmup):
        loss, _ = L.snerf_loss(results, rgbs, lambda_sc=tcfg.sc_lambda,
                               mesh=mesh)
    terms.update(d)

    # depth supervision (main.py:248-265), dropped after ds_drop
    if tcfg.ds_lambda > 0 and "depths" in batch:
        kp_weights = (torch.ones_like(batch["depths"][:, 1])
                      if tcfg.ds_noweights else batch["depths"][:, 1])
        dloss, d = L.depth_loss(
            results, batch["depths"][:, 0], kp_weights,
            valid_depth=batch.get("valid_depth"),
            target_std=batch.get("depth_std"),
            lambda_ds=tcfg.ds_lambda, gnll=tcfg.gnll,
            usealldepth=tcfg.usealldepth,
            subset=(mcfg.variant != "sat-nerf"), mesh=mesh)
        if gates.ds_on:
            loss = loss + dloss
        terms.update(d)

    # sat-nerf's keypoint depth: a second render of the tie-point rays
    # (main.py:256-262 renders batch['depth'] with mode='test'), the plain
    # MSE over all of them (DepthLoss subset=False, metrics.py:147: the
    # keypoint weights apply in subset mode alone)
    if tcfg.ds_lambda > 0 and "kp_rays" in batch:
        kp_inp = RenderInputs(rays=batch["kp_rays"], ts=batch.get("kp_ts"),
                              cos_irra_on=gates.cos_irra_on,
                              ray0=batch.get("kp_ray0"))
        kp_res = render_rays(net, mcfg, rcfg, kp_inp, train=False,
                             draws=draws.get("kp"), generator=generator)
        dloss, d = L.depth_loss(
            kp_res, batch["kp_depths"][:, 0], batch["kp_depths"][:, 1],
            lambda_ds=tcfg.ds_lambda, gnll=tcfg.gnll,
            usealldepth=tcfg.usealldepth, subset=False, mesh=mesh)
        if gates.ds_on:
            loss = loss + dloss
        terms.update({f"kp_{k}": v for k, v in d.items()})

    perc_bad_nr = torch.tensor(-1.0)
    if mcfg.variant == "spsbrdf-nerf":
        # normal regularization after nrrg_on (main.py:270-285)
        for lam, key in ((tcfg.nr_reg_an_lambda, "normal_an"),
                         (tcfg.nr_reg_lr_lambda, "normal_lr")):
            if lam > 0 and f"{key}_{typ}" in results:
                lr, d, perc_bad_nr = L.normal_reg_loss(results, lam, key,
                                                       mesh=mesh)
                if gates.nrrg_on:
                    loss = loss + lr
                terms.update(d)
        # normal supervision by nr_spv_type (main.py:301-327)
        if abs(tcfg.nr_spv_lambda) > 1e-5:
            w = results[f"weights_{typ}"]
            an, lr_ = f"normal_an_{typ}", f"normal_lr_{typ}"
            ln = None
            if tcfg.nr_spv_type == 1 and lr_ in results and an in results:
                ln, d = L.normal_loss(w, results[an], results[lr_],
                                      tcfg.nr_spv_lambda, keyword="an_lr",
                                      mesh=mesh)
            elif (tcfg.nr_spv_type == 2 and lr_ in results
                  and "normals" in batch):
                ln, d = L.normal_loss(w, batch["normals"], results[lr_],
                                      tcfg.nr_spv_lambda, keyword="lr",
                                      mesh=mesh)
            elif (tcfg.nr_spv_type == 3 and an in results
                  and "normals" in batch):
                ln, d = L.normal_loss(
                    w, batch["normals"], results[an], tcfg.nr_spv_lambda,
                    target_weight=batch.get("valid_normal"),
                    valid_depth=batch.get("valid_depth"), keyword="an",
                    mesh=mesh)
            if ln is not None:
                loss = loss + ln
                terms.update(d)

    # hard surface after epoch 2 (main.py:290-299)
    if tcfg.hs_lambda > 0:
        hl, d = L.hard_surface_loss(results, tcfg.hs_lambda, mesh=mesh)
        if gates.hs_on:
            loss = loss + hl
        terms.update(d)

    aux = {
        "psnr": _psnr(results[f"rgb_{typ}"], rgbs, mesh),
        "perc_bad_nr": perc_bad_nr,
        "depth_std_mean": L._global_mean(torch.sqrt(torch.sum(
            (results[f"z_vals_{typ}"]
             - results[f"depth_{typ}"][..., None]) ** 2
            * results[f"weights_{typ}"], -1)), mesh),
    }
    if f"irradiance_{typ}" in results:
        aux["irradiance"] = L._global_mean(results[f"irradiance_{typ}"],
                                           mesh)
    return loss, (terms, aux)


def _psnr(rgb, rgbs, mesh=None):
    """The batch's PSNR (metrics.psnr); on a mesh of several ranks, the
    global batch's: its squared error's mean over max(gt)^2, both reduced
    over the ranks."""
    if L._world(mesh) == 1:
        return psnr_metric(rgb, rgbs)
    peak = mesh.max(torch.max(rgbs).detach())
    mse = L._global_mean((rgb.detach() - rgbs) ** 2, mesh) / peak ** 2
    return -10.0 * torch.log10(mse)


def _update(state: TrainState, optimizer: Optimizer, loss_fn, mesh=None):
    """One optimizer update of state from loss_fn(net); with every
    parameter frozen (no torch optimizer) the loss is computed and nothing
    changes but the step count.  On a mesh, the ranks' gradients are
    all-reduced (summed: each rank's loss is its share) before the update,
    and the logged loss is the ranks' shares summed."""
    net, opt, step = state
    net.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, (_, aux) = loss_fn(net)
        if opt is not None:
            loss.backward()
    if mesh is not None and opt is not None:
        mesh.reduce_grads([p for g in opt.param_groups for p in g["params"]])
    optimizer.step(opt, step)
    loss = loss.detach()
    if mesh is not None:
        loss = mesh.sum(loss)
    metrics = {"loss": loss,
               **{k: torch.as_tensor(v).detach() for k, v in aux.items()}}
    return TrainState(net, opt, step + 1), metrics


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, seeded from (seed, step): the
    analogue of jax.random.fold_in(base_key, step)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(hi) << 31) ^ int(lo))


def _step_layout(mesh, mcfg: ModelConfig, rcfg: RenderConfig,
                 store_sharded: bool, state_shardings):
    """(rcfg, layout) of a step on `mesh`: the tensor-parallel layout
    (state_shardings, or the mesh's own where its model axis is larger
    than 1, parallel/tensor.state_shardings) and the render config with
    K1-K5 off under it; (rcfg, None) without one."""
    from . import tensor
    if store_sharded and mesh is None:
        raise ValueError("store_sharded requires a mesh")
    layout = state_shardings
    if layout is None and mesh is not None:
        layout = tensor.state_shardings(mesh, mcfg.skips)
    if layout is None:
        return rcfg, None
    if mesh is None or getattr(layout, "mesh", None) is not mesh:
        raise ValueError("state_shardings are a layout of the step's mesh "
                         "(parallel/tensor.state_shardings(mesh, skips))")
    return tensor.kernels_off(rcfg), layout


def _check_sharded(state: TrainState, layout) -> None:
    """A tensor-parallel step takes a state of blocks (create_train_state
    with the layout, or tensor.shard_state)."""
    if layout is not None and as_params(state.params).coarse.tp is None:
        raise ValueError("a tensor-parallel step takes a sharded state "
                         "(create_train_state(..., layout=) or "
                         "parallel.tensor.shard_state)")


def _rank_batch(mesh, mcfg: ModelConfig, rcfg: RenderConfig, batch: Dict,
                draws: Optional[Dict], generator) -> tuple:
    """This rank's view of a data-parallel step: (batch, draws) with the
    global first rays (ray0, kp_ray0) broadcast from rank 0 into the batch,
    and this rank's rows of the global batch's draws: `draws` when given
    (those of the global batch, draws["kp"] of its keypoint batch), else
    render.batch_draws of the global batch from `generator`."""
    from ..render.render import batch_draws
    batch = dict(batch)
    n_global = batch["rays"].shape[0] * mesh.n_data
    batch["ray0"] = mesh.broadcast(batch["rays"][:1].contiguous())
    kp_global = None
    if "kp_rays" in batch:
        kp_global = batch["kp_rays"].shape[0] * mesh.n_data
        batch["kp_ray0"] = mesh.broadcast(
            batch["kp_rays"][:1].contiguous())
    if draws is None:
        dev = batch["rays"].device
        draws = batch_draws(mcfg, rcfg, n_global, dev, generator,
                            train=True, gt_band="valid_depth" in batch)
        if kp_global is not None:
            draws["kp"] = batch_draws(mcfg, rcfg, kp_global, dev, generator)

    def rows(d, n):
        if d.shape[0] != n:
            raise ValueError(f"draws of {d.shape[0]} rows for a global "
                             f"batch of {n}")
        return d[mesh.block(n)]
    local = {k: rows(v, n_global) for k, v in draws.items() if k != "kp"}
    if "kp" in draws:
        local["kp"] = {k: rows(v, kp_global) for k, v in draws["kp"].items()}
    return batch, local


def make_train_step(mcfg: ModelConfig, rcfg: RenderConfig,
                    tcfg: TrainConfig, optimizer: Optimizer, mesh=None,
                    state_shardings=None):
    """fn(state, batch, gates, draws=None, generator=None) ->
    (state, metrics): one update on a batch already on the device.  On a
    mesh, `batch` is this rank's block of the global batch, and `draws`
    (or the generator's) are the global batch's (_rank_batch).  On a
    (data, model) mesh the state is this rank's blocks (state_shardings,
    by default the mesh's layout) and the step runs without K1-K5."""
    rcfg, layout = _step_layout(mesh, mcfg, rcfg, False, state_shardings)

    def step_fn(state: TrainState, batch: Dict, gates: TrainGates,
                draws: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None):
        _check_sharded(state, layout)
        if mesh is not None:
            batch, draws = _rank_batch(mesh, mcfg, rcfg, batch, draws,
                                       generator)
            generator = None
        return _update(state, optimizer, lambda net: compute_losses(
            net, mcfg, rcfg, tcfg, batch, gates, draws, generator, mesh),
            mesh)
    return step_fn


def make_fused_train_step(mcfg: ModelConfig, rcfg: RenderConfig,
                          tcfg: TrainConfig, optimizer: Optimizer,
                          schedule: GateSchedule, has_kp: bool = False,
                          mesh=None, store_sharded: bool = False,
                          state_shardings=None):
    """The step Trainer.fit dispatches: fn(state, store, idx, seed,
    kp_store=None, kp_idx=None, draws=None) -> (state, metrics).  The
    minibatch is gathered from the device-resident store by the (batch,)
    index tensor on the device (with has_kp, sat-nerf's keypoint sub-batch
    from kp_store by kp_idx too, both required), the gates follow from
    state.step, and the draws from step_generator(seed, state.step) unless
    given.  Per step the host sends the index vectors and nothing else.

    On a mesh (parallel/mesh.Mesh): `idx` and `kp_idx` are this rank's
    blocks of the global index vectors, into the replicated store, or with
    store_sharded into this rank's shard (data/batcher.ShardedRayBatcher);
    the draws are the global batch's (_rank_batch), so the step is the
    one-device step on the global batch up to the order of its sums.  On
    a (data, model) mesh the blocks are the data axis's, the state is
    this rank's blocks (state_shardings, by default the mesh's layout)
    and the step runs without K1-K5."""
    rcfg, layout = _step_layout(mesh, mcfg, rcfg, store_sharded,
                                state_shardings)

    def step_fn(state: TrainState, store: Dict[str, torch.Tensor],
                idx: torch.Tensor, seed: int, *,
                kp_store: Optional[Dict[str, torch.Tensor]] = None,
                kp_idx: Optional[torch.Tensor] = None,
                draws: Optional[Dict] = None):
        if has_kp != (kp_store is not None and kp_idx is not None):
            raise ValueError(f"a step built with has_kp={has_kp} takes "
                             f"kp_store and kp_idx {'' if has_kp else 'not'}")
        _check_sharded(state, layout)
        batch = {k: torch.index_select(v, 0, idx) for k, v in store.items()}
        if has_kp:
            kb = {k: torch.index_select(v, 0, kp_idx)
                  for k, v in kp_store.items()}
            batch.update(kp_rays=kb["rays"], kp_depths=kb["depths"],
                         kp_ts=kb["ts"])
        gates = gates_from_step(state.step, schedule)
        gen = (None if draws is not None
               else step_generator(seed, state.step, idx.device))
        if mesh is not None:
            batch, draws = _rank_batch(mesh, mcfg, rcfg, batch, draws, gen)
            gen = None
        return _update(state, optimizer, lambda net: compute_losses(
            net, mcfg, rcfg, tcfg, batch, gates, draws, gen, mesh), mesh)
    return step_fn


def make_scan_train_step(mcfg: ModelConfig, rcfg: RenderConfig,
                         tcfg: TrainConfig, optimizer: Optimizer,
                         schedule: GateSchedule, has_kp: bool = False,
                         mesh=None, store_sharded: bool = False,
                         state_shardings=None):
    """N fused steps per call: fn(state, store, idx_mat, seed,
    kp_store=None, kp_mat=None, draws=None) -> (state, metrics of the last
    step).
    idx_mat is (N, batch) on the device (kp_mat (N, kp_batch)), one host
    upload for the N steps; step i takes row i, its gates and draws follow
    from its own step count, so the trajectory is that of N calls of
    make_fused_train_step.  draws: None, or a list of N draw dicts."""
    step = make_fused_train_step(mcfg, rcfg, tcfg, optimizer, schedule,
                                 has_kp, mesh, store_sharded,
                                 state_shardings)

    def scan_fn(state: TrainState, store: Dict[str, torch.Tensor],
                idx_mat: torch.Tensor, seed: int, *,
                kp_store: Optional[Dict[str, torch.Tensor]] = None,
                kp_mat: Optional[torch.Tensor] = None,
                draws: Optional[List[Dict]] = None):
        metrics = None
        for i in range(idx_mat.shape[0]):
            state, metrics = step(
                state, store, idx_mat[i], seed, kp_store=kp_store,
                kp_idx=None if kp_mat is None else kp_mat[i],
                draws=None if draws is None else draws[i])
        return state, metrics
    return scan_fn


def make_render_step(mcfg: ModelConfig, rcfg: RenderConfig,
                     train: bool = False, mesh=None):
    """fn(net, inp, draws=None, generator=None) -> render_rays result, with
    no autograd graph unless `train`.  On a (data, model) mesh (the JAX
    package's make_render_step(mesh=tp_mesh(...))), net holds this rank's
    blocks, every rank of a model group renders the same rays and draws
    with the sharded trunk, and K1-K5 are off."""
    from .tensor import kernels_off, model_axis_size
    if model_axis_size(mesh) > 1:
        rcfg = kernels_off(rcfg)

    def fn(net, inp: RenderInputs, draws: Optional[Dict] = None,
           generator: Optional[torch.Generator] = None):
        with torch.set_grad_enabled(train):
            return render_rays(net, mcfg, rcfg, inp, train=train,
                               draws=draws, generator=generator)
    return fn


def render_blocks(net, mcfg: ModelConfig, rcfg: RenderConfig,
                  rays: np.ndarray, chunk: int, device, cos_irra_on: bool,
                  per_ray_keys: Sequence[str], panel_accum,
                  seed: int = 0, draws: Optional[Dict] = None,
                  block: Optional[int] = None,
                  t: int = 0, replicas=None) -> Dict[str, np.ndarray]:
    """Block render of a full image (the JAX package's
    make_scan_render_step with Trainer._render_image_scan): the rays go to
    the device once, padded to whole chunks by repeating the last ray; the
    chunks render back to back in blocks of `block` chunks
    (BRDFNERF_RENDER_SCAN_BLOCK, default 32), the per-ray keys and the
    reduce_panels maps accumulating in one float32 device buffer, which
    crosses to the host in one copy a block.  Every chunk takes the same
    draws: `draws` (one chunk's), else render.chunk_draws(seed), which are
    those a generator seeded with `seed` gives a chunk.  Every ray takes
    the transient embedding t (of a t table).  Returns what the chunk loop
    (serve.render_in_chunks) returns, bit for bit.

    replicas: [(device, params)] of a multi-device server (default: the
    one replica (device, net)).  Each chunk's rays and its draws split
    into len(replicas) contiguous blocks, each rendered on its replica (a
    thread a replica, at the same time), every block reading the chunk's
    first ray as its ray 0 (the JAX package's sharded render of the
    chunk); each replica copies its rows to the host once a block of
    chunks."""
    from concurrent.futures import ThreadPoolExecutor
    from ..render.render import chunk_draws
    step = make_render_step(mcfg, rcfg)
    replicas = list(replicas or [(device, net)])
    n_dev = len(replicas)
    if chunk % n_dev:
        raise ValueError(f"chunk {chunk} does not split over {n_dev} "
                         "devices")
    sub = chunk // n_dev
    rays = np.asarray(rays, np.float32)
    n = rays.shape[0]
    n_chunks = max(1, -(-n // chunk))
    if block is None:
        block = int(os.environ.get("BRDFNERF_RENDER_SCAN_BLOCK", "32"))
    block = min(max(1, block), n_chunks)
    total = n_chunks * chunk
    if total > n:
        rays = np.concatenate([rays, np.tile(rays[-1:], (total - n, 1))], 0)
    if draws is None:
        draws = chunk_draws(mcfg, rcfg, chunk, device, seed)
    panel_items = tuple(panel_accum.items())

    def run(d: int):
        dev, net_d = replicas[d]
        dev = torch.device(dev)
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            rays_d = torch.from_numpy(rays).to(dev)
            draws_d = {k: v[d * sub:(d + 1) * sub].to(dev)
                       for k, v in draws.items()}
            cos = torch.tensor(bool(cos_irra_on), device=dev)
            ts = torch.full((sub,), int(t), dtype=torch.int64, device=dev)
            # [(key, first column, columns, trailing shape)] of the buffer
            layout = buf = None
            parts: List[np.ndarray] = []
            for b0 in range(0, n_chunks, block):
                rows = min(block, n_chunks - b0) * sub
                for c in range(b0, min(b0 + block, n_chunks)):
                    r0 = c * chunk + d * sub
                    # a split chunk's blocks all read the chunk's ray 0
                    ray0 = (rays_d[c * chunk:c * chunk + 1] if n_dev > 1
                            else None)
                    res = step(net_d, RenderInputs(
                        rays=rays_d[r0:r0 + sub], ts=ts, cos_irra_on=cos,
                        ray0=ray0), draws=draws_d)
                    out = {k: res[k] for k in per_ray_keys if k in res}
                    out.update(reduce_panels(res, panel_items))
                    if layout is None:
                        layout, width = [], 0
                        for k, v in out.items():
                            w = int(np.prod(v.shape[1:], dtype=np.int64))
                            layout.append((k, width, w, tuple(v.shape[1:])))
                            width += w
                        buf = torch.empty(block * sub, width,
                                          dtype=torch.float32, device=dev)
                    o = (c - b0) * sub
                    for k, off, w, _ in layout:
                        buf[o:o + sub, off:off + w] = out[k].reshape(sub, w)
                parts.append(buf[:rows].to("cpu", copy=True).numpy())
            return layout, parts

    if n_dev == 1:
        results = [run(0)]
    else:
        with ThreadPoolExecutor(n_dev) as pool:
            results = list(pool.map(run, range(n_dev)))
    layout = results[0][0]
    width = results[0][1][0].shape[1]
    # (chunks, replicas, sub, width): each chunk's rows in replica order
    host = np.concatenate([
        np.stack([r[1][i].reshape(-1, sub, width) for r in results],
                 1).reshape(-1, width)
        for i in range(len(results[0][1]))], 0)[:n]
    return {k: np.ascontiguousarray(host[:, off:off + w]).reshape(
        (n,) + shape) for k, off, w, shape in layout}


def reduce_panels(res: Dict, panel_accum) -> Dict:
    """Per-sample (N, S, C) panel fields -> per-ray maps: weighted sum along
    samples ('wsum') or plain mean ('mean')."""
    out = {}
    w = res.get("weights_coarse")
    if w is None:
        return out
    items = (panel_accum.items() if isinstance(panel_accum, dict)
             else panel_accum)
    for k, how in items:
        if k in res:
            out[k] = (torch.mean(res[k], -2) if how == "mean"
                      else torch.sum(w[..., None] * res[k], -2))
    return out
