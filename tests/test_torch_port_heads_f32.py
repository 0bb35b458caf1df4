"""K4 and K5 at compute_dtype float32 (the CLIs' default): their split
emulations against the JAX package's Pallas _fwd_kernel_h / _bwd_kernel_h
at float32 in interpret mode, and what the wrappers hand the kernels.

The float32 instantiations of K4 (csrc/trunk_heads_fwd.cu) and K5
(csrc/trunk_heads_bwd.cu) run every product of f32 operands as three bf16
products of their hi and lo terms, as K1-K3 do: the head weights W_f, W_1r
and W_1p are packed as hi and lo planes (fused_trunk_heads.HEAD_PLANE_KEYS),
the 3-row second layers W_2r, W_2p are read in f32 on the CUDA cores, and
the heads' weight gradients take their operands as hi and lo planes, K
three segments long and cut at WGRAD_F32_CHUNKS.  Here, on the CPU:
  * _trunk_heads_fwd_split / _trunk_heads_bwd_split (the kernels'
    arithmetic) within 1e-4 relative L2 of the Pallas kernels at float32
    (4 x 64 and 8 x 64 trunks, 200 points), and K5's rebuilt b_th chain
    (uchain_plain) likewise;
  * the head planes sum back to the f32 weights within 2^-16 relative;
  * the head weights' check, pointers and the weight-gradient plan at
    float32; fwd_plan and saved_spec as K2's.
The kernels are held to their twins on the card by tools/f32_check.py and
chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_heads as jh

from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2

from test_torch_port_kernels import _inputs, _j2t
from torch_port_common import (FLAGSHIP_HEADS, SMALL, model_configs,
                               networks, t)

SPLIT_BOUND = 1e-4
SIZES = [(4, 2), (8, 4)]
K5_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig", "dwf", "dbf", "dw1r", "db1r", "dw2r", "db2r", "dw1p",
            "db1p", "dw2p", "db2p")


def _rel(got, ref):
    g = got.detach().double().numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))


def _f32(layers, skip):
    """(JAX params, packs, port packs) of a small flagship at float32."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,)),
                               **FLAGSHIP_HEADS, compute_dtype="float32")
    params, net = networks(jcfg, tcfg)
    return (jcfg, tcfg, net, jk1.pack_trunk_weights(params, jcfg,
                                                    jnp.float32),
            jh.pack_head_weights(params, jcfg, jnp.float32),
            tk1.pack_trunk_weights(net, tcfg, torch.float32),
            th.pack_head_weights(net, tcfg, torch.float32))


@pytest.mark.parametrize("layers,skip", SIZES)
@pytest.mark.parametrize("want_zs", [False, True])
def test_k4_split_emulation_matches_pallas_at_f32(layers, skip, want_zs):
    """The packed logits, gx and zs of K4's float32 arithmetic."""
    jcfg, tcfg, _, jp, jhw, tp, thw = _f32(layers, skip)
    _, enc = _inputs(200)
    ref = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True, want_zs=want_zs)
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    got = th._trunk_heads_fwd_split(tp, thw, tcfg, x, want_zs)
    assert (got[2] is None) != want_zs
    for name, g, r in zip(("out", "gx", "zs"), got, ref):
        assert g.dtype == torch.float32, name
        assert _rel(g[:200], r[:200]) <= SPLIT_BOUND, name
    assert float(got[0][:, 7].abs().max()) == 0.0


@pytest.mark.parametrize("layers,skip", SIZES)
def test_k5_split_emulation_matches_pallas_at_f32(layers, skip):
    """Every weight grad of K5's float32 arithmetic, the heads' included,
    on the Pallas forward's zs and the same cotangents; and its rebuilt
    b_th chain against the exact one."""
    jcfg, tcfg, _, jp, jhw, tp, thw = _f32(layers, skip)
    _, enc = _inputs(200)
    _, _, zs = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True,
                             want_zs=True)
    rng = np.random.RandomState(7)
    cot = rng.normal(size=(200, 8)).astype(np.float32)
    cot[:, 7] = 0.0
    cg = rng.normal(size=(200, 128)).astype(np.float32)
    ref = list(jh._run_bwd_h(jcfg, jp, jhw, enc, jnp.asarray(cot),
                             jnp.asarray(cg), zs, interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    n_p = zs.shape[0]
    pad = lambda v, w: tk1.pad_rows_lanes(v, n_p, w)   # noqa: E731
    got = th._trunk_heads_bwd_split(tp, thw, tcfg, pad(t(enc), 128),
                                    pad(t(cot), 8), pad(t(cg), 128),
                                    _j2t(zs))
    assert len(got) == len(K5_NAMES)
    for name, g, r in zip(K5_NAMES, got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        assert _rel(g, r) <= SPLIT_BOUND, name
    exact = th.uchain_plain(tp, tcfg, _j2t(zs))
    split = th.uchain_plain(tp, tcfg, _j2t(zs), od=tk2.SPLIT3)
    assert _rel(split, exact.numpy()) <= SPLIT_BOUND


def test_head_planes_sum_back_to_the_weights():
    """pack_head_weights' hi and lo planes of wf, w1r and w1p (planes=True;
    by default on a CUDA device at float32) hold each f32 weight to 2^-16
    relative; the f32 matrices the twins read, W_2 among them, stay."""
    _, tcfg, net, _, _, _, _ = _f32(4, 2)
    hw = th.pack_head_weights(net, tcfg, torch.float32, planes=True)
    assert th.pack_head_weights(net, tcfg, torch.float32).keys() \
        == hw.keys() - set(th.HEAD_PLANE_KEYS.values())
    for k, kp in th.HEAD_PLANE_KEYS.items():
        w, pl = hw[k], hw[kp]
        assert w.dtype == torch.float32 and pl.dtype == torch.bfloat16
        assert tuple(pl.shape) == (2,) + tuple(w.shape) and pl.is_contiguous()
        assert torch.equal(pl[0], w.to(torch.bfloat16)), kp
        err = (pl[0].double() + pl[1].double() - w.double()).abs()
        assert bool((err <= 2.0 ** -16 * w.double().abs()).all()), kp
    assert hw["w2r"].dtype == hw["w2p"].dtype == torch.float32


def _flagship(dtype):
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.models.network import init_network
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype=dtype, **FLAGSHIP_HEADS)
    return cfg, init_network(cfg, torch.Generator().manual_seed(0),
                             device="cpu")


@pytest.mark.parametrize("dtype,planes,weights,ok", [
    ("float32", True, torch.float32, True),
    ("float32", False, torch.float32, False),
    ("float32", True, torch.bfloat16, False),
    ("bfloat16", False, torch.bfloat16, True),
    ("bfloat16_all", False, torch.float32, False)])
def test_head_weights_checked_per_dtype(dtype, planes, weights, ok):
    """check_head_weights takes the operands of the configuration's dtype:
    f32 weights with their planes at float32, bf16 weights otherwise;
    head_weight_ptrs hands the kernels the planes at float32."""
    cfg, net = _flagship(dtype)
    hw = th.pack_head_weights(net, cfg, weights, planes=planes)
    x = torch.zeros(64, tk1.LANE)
    if not ok:
        with pytest.raises(ValueError, match="packed head"):
            th.check_head_weights(cfg, hw, x)
        return
    th.check_head_weights(cfg, hw, x)
    ptrs = th.head_weight_ptrs(cfg, hw)
    assert list(ptrs) == ["wf", "bf", "w1r", "b1r", "w2r", "b2r", "w1p",
                          "b1p", "w2p", "b2p"]
    for k in ptrs:
        src = th.HEAD_PLANE_KEYS.get(k, k) if planes else k
        assert ptrs[k] == hw[src].data_ptr(), k


@pytest.mark.parametrize("n", [192, 8448, 131072])
def test_f32_head_plan_caps_each_accumulator(n):
    """At float32 the weight-gradient plan cuts the heads' K (three
    products over n points: 3 n / 64 chunks) as it cuts the trunk's, into
    slices of at most WGRAD_F32_CHUNKS chunks; the bf16 plan is the one it
    was; the forward's blocks and scratch and the saved zs are K2's."""
    st, sh = tk2.wgrad_splits(n, 8, True, 132, True)
    for chunks, splits in ((3 * 2 * n // 64, st), (3 * n // 64, sh)):
        slices = tk2.wgrad_slices(chunks, splits)
        assert slices[0][0] == 0 and slices[-1][1] == chunks
        assert max(b - a for a, b in slices) <= tk2.WGRAD_F32_CHUNKS
    assert tk2.wgrad_splits(131072, 8, True, 132) == (9, 5)
    assert tk2.fwd_plan(n, 8, True) == (min(n // 64, 132),
                                        min(n // 64, 132) * 8 * 64 * 512)
    cfg, _ = _flagship("float32")
    assert tk2.saved_spec(cfg, n) == ((n, 8 * 512), torch.float32)


def test_k5_wrapper_allocates_the_planes(monkeypatch):
    """K5's wrapper at float32 hands the kernel hi and lo planes of every
    weight-gradient operand (x | t and the trunk's: 4 planes; the heads'
    h, xf, a_xf, c_z1: 2), the split flag and the heads' split plan."""
    cfg, net = _flagship("float32")
    seen = {}

    def launch(*args, act="poly", feat=512):
        seen["args"], seen["act"], seen["feat"] = args, act, feat
    monkeypatch.setattr(th, "TRUNK_HEADS_BWD", launch)
    monkeypatch.setattr(th, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(th, "check_head_weights", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: SimpleNamespace(
                            multi_processor_count=132))
    packed = tk1.pack_trunk_weights(net, cfg, torch.float32, planes=True)
    hw = th.pack_head_weights(net, cfg, torch.float32, planes=True)
    n = 128
    scratch = {}
    th._trunk_heads_bwd_cuda(packed, hw, cfg, torch.zeros(n, 128),
                             torch.zeros(n, 8), torch.zeros(n, 128),
                             torch.zeros(n, 8 * 512), scratch_out=scratch)
    assert tuple(scratch["xt"].shape) == (4, n, 128)
    assert tuple(scratch["azbtz"].shape) == (8, 4, n, 512)
    for k, w in (("hl", 512), ("xfb", 512), ("axf", 512), ("cz1", 1024)):
        assert tuple(scratch[k].shape) == (2, n, w), k
    args = seen["args"]
    # zs_f32, split before layers, skip, stream
    assert args[-5:-3] == (1, 1) and seen["act"] == "poly"
    assert seen["feat"] == 512
    st, sh = tk2.wgrad_splits(n, 8, True, 132, True)
    assert (args[27], args[28]) == (st, sh)
    assert args[7] == packed["w0_planes"].data_ptr()
    assert args[12] == hw["wf_planes"].data_ptr()
