"""The float32 configuration of the trunk kernels (compute_dtype float32, the
train CLI's default) and the f32 saved state of the mixed bfloat16 contract.

At float32 the CUDA kernels K1-K3 multiply f32 operands on bf16 tensor
cores as three products of their bf16 hi and lo terms (fused_mlp.split3_mm:
A_hi B_hi + A_lo B_hi + A_hi B_lo), the weights packed once as hi and lo
planes (fused_mlp.split_planes).  Here, on the CPU:
  * split3_mm against exact products: every element within 2^-16 of
    sum_k |a_ik| |b_kj| (the dropped A_lo B_lo and the terms' residuals;
    the f32 sums add a few 2^-24);
  * the planes sum back to the f32 weights within 2^-16 relative;
  * the plain emulations of the split kernels (_trunk_sigma_split with f32
    weights, _trunk_fwd_grad_split, _trunk_bwd_split) against the JAX
    package's Pallas kernels at float32 in interpret mode, to 1e-4 relative
    L2 on every output (measured here at 4 x 64 and 8 x 64 on 200 points:
    at most 2.2e-5; at the flagship 8 x 512 the emulations sit 5e-6 ..
    6e-5 from the exact twins);
  * the zs/us the CUDA wrappers allocate (K2, K4) and take (K3, K5) are
    the dtype the twins save, _saved_dtype, for every compute dtype the
    kernels cover: the wrappers run with their launches recorded instead
    of made (no card here), so the rule is the one they run;
  * K4/K5 take f32 operands too, with their head weights' planes
    (tests/test_torch_port_heads_f32.py holds their split arithmetic).
The kernels themselves are held to their twins on the card by the
`cuda`-marked test below, by tools/f32_check.py and by chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_vjp as jk2

from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as tk4
from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2

from test_torch_port_kernels import _cotangents, _inputs
from torch_port_common import (FLAGSHIP_HEADS, SMALL, model_configs,
                               networks, t)

SPLIT_BOUND = 1e-4
K3_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig")


def _rel(got, ref):
    """relative L2 of a torch tensor against a float64 array"""
    got = got.detach().double().numpy()
    return float(np.linalg.norm(got - ref)
                 / max(np.linalg.norm(ref), 1e-30))


def _j(x):
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


@pytest.mark.parametrize("seed,shape", [(0, (96, 512, 256)),
                                        (1, (64, 128, 512)),
                                        (2, (200, 64, 3))])
def test_split3_mm_is_within_its_bound(seed, shape):
    """The three-product emulation against float64 products of the f32
    operands: each element within 2^-16 of sum_k |a_ik| |b_kj| (plus f32
    summation), and far closer than one bf16 product (whose error reaches
    2^-8 of it)."""
    n, k, m = shape
    rng = np.random.RandomState(seed)
    a = (rng.normal(size=(n, k)) * np.exp2(rng.randint(-8, 8, (n, k)))
         ).astype(np.float32)
    b = rng.normal(size=(k, m)).astype(np.float32)
    got = tk1.split3_mm(torch.from_numpy(a), torch.from_numpy(b)).double()
    exact = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    mag = torch.from_numpy(np.abs(a).astype(np.float64)
                           @ np.abs(b).astype(np.float64))
    err = (got - exact).abs()
    assert bool((err <= (2.0 ** -16 + k * 2.0 ** -24) * mag).all()), \
        float((err / mag).max())
    one = (torch.from_numpy(a).bfloat16().double()
           @ torch.from_numpy(b).bfloat16().double())
    assert float(err.norm()) * 50 < float((one - exact).norm())


def test_planes_sum_back_to_the_weights():
    """pack_trunk_weights' hi and lo planes (planes=True; by default on a
    CUDA device at float32) hold each f32 weight to 2^-16 relative; the f32
    matrices the twins read stay in the pack."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=8, skips=(4,),
                                      compute_dtype="float32"))
    _, net = networks(jcfg, tcfg)
    packed = tk1.pack_trunk_weights(net, tcfg, torch.float32, planes=True)
    assert tk1.pack_trunk_weights(net, tcfg, torch.float32).keys() \
        == packed.keys() - set(tk1.PLANE_KEYS.values())
    for k, kp in tk1.PLANE_KEYS.items():
        w, pl = packed[k], packed[kp]
        assert w.dtype == torch.float32 and pl.dtype == torch.bfloat16
        assert tuple(pl.shape) == (2,) + tuple(w.shape), kp
        assert pl.is_contiguous()
        assert torch.equal(pl[0], w.to(torch.bfloat16)), kp
        back = pl[0].double() + pl[1].double()
        err = (back - w.double()).abs()
        assert bool((err <= 2.0 ** -16 * w.double().abs()).all()), kp


@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
@pytest.mark.parametrize("feats", [False, True])
def test_k1_split_emulation_matches_pallas_at_f32(layers, skip, feats):
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype="float32"))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    s_ref, f_ref = jk1.fused_trunk_sigma(params, jcfg, enc, interpret=True)
    packed = tk1.pack_trunk_weights(net, tcfg, torch.float32)
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    s_got, f_got = tk1._trunk_sigma_split(packed, tcfg, x, feats)
    assert _rel(s_got[:200], _j(s_ref)) <= SPLIT_BOUND
    if feats:
        assert _rel(f_got[:200], _j(f_ref)) <= SPLIT_BOUND


@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
def test_k2_split_emulation_matches_pallas_at_f32(layers, skip):
    """sigma, feats, gx, zs and us of the float32 forward."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype="float32"))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    jpacked = jk1.pack_trunk_weights(params, jcfg, jnp.float32)
    ref = jk2._run_fwd(jcfg, jpacked, enc, interpret=True, want_zs=True)
    packed = tk1.pack_trunk_weights(net, tcfg, torch.float32)
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    got = tk2._trunk_fwd_grad_split(packed, tcfg, x, want_zs=True)
    for name, g, r in zip(("sigma", "feats", "gx", "zs", "us"), got, ref):
        assert g.dtype == torch.float32, name
        assert _rel(g[:200], _j(r)[:200]) <= SPLIT_BOUND, name


@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
def test_k3_split_emulation_matches_pallas_at_f32(layers, skip):
    """Every weight grad of the float32 backward on the Pallas forward's
    zs/us and the same cotangents."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype="float32"))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    jpacked = jk1.pack_trunk_weights(params, jcfg, jnp.float32)
    _, _, _, zs, us = jk2._run_fwd(jcfg, jpacked, enc, interpret=True,
                                   want_zs=True)
    cs, cf, cg = _cotangents(200, 64)
    ref = list(jk2._run_bwd(jcfg, jpacked, enc, jnp.asarray(cs),
                            jnp.asarray(cf), jnp.asarray(cg), zs, us,
                            interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    packed = tk1.pack_trunk_weights(net, tcfg, torch.float32)
    n_p = zs.shape[0]
    pad = lambda v, w: tk1.pad_rows_lanes(t(v), n_p, w)   # noqa: E731
    csp = torch.zeros(n_p)
    csp[:200] = t(cs)
    got = tk2._trunk_bwd_split(packed, tcfg, pad(enc, 128), csp,
                               pad(cf, 64), pad(cg, 128), t(zs), t(us))
    for name, g, r in zip(K3_NAMES, got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        assert _rel(g, _j(r)) <= SPLIT_BOUND, name


# ------------------------------------------------- the wrappers' dtypes

class _Launch:
    """A CudaKernel stand-in that records its arguments."""

    def __init__(self):
        self.args, self.act, self.feat, self.launches = None, None, None, 0

    def __call__(self, *args, act="poly", feat=512):
        self.args, self.act, self.launches = args, act, self.launches + 1
        self.feat = feat


@pytest.fixture
def recorded(monkeypatch):
    """The CUDA wrappers with their launches recorded, not made: the CPU
    stands in for the card's stream and properties, and the input check's
    device test is left out (its dtype and layout tests stay)."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: SimpleNamespace(
                            multi_processor_count=132))
    real = tk1.check_kernel_inputs

    def check(cfg, packed, x):
        # the real check on a stand-in whose is_cuda is True
        real(cfg, packed, SimpleNamespace(
            is_cuda=True, dtype=x.dtype, is_contiguous=x.is_contiguous,
            dim=x.dim, shape=x.shape, device=x.device))
    for mod in (tk1, tk2, tk4):
        monkeypatch.setattr(mod, "check_kernel_inputs", check)
    launches = {}
    for mod, name in ((tk2, "TRUNK_FWD_GRAD"), (tk2, "TRUNK_BWD"),
                      (tk4, "TRUNK_HEADS_FWD"), (tk4, "TRUNK_HEADS_BWD")):
        launches[name] = _Launch()
        monkeypatch.setattr(mod, name, launches[name])
    return launches


def _flagship(dtype):
    """A port network of the flagship width (8 x 512, the RPV heads) at
    dtype: what the CUDA wrappers take."""
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.models.network import init_network
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype=dtype, **FLAGSHIP_HEADS)
    net = init_network(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, net


@pytest.mark.parametrize("dtype", tk1.CUDA_DTYPES)
def test_wrappers_save_what_the_twins_save(recorded, dtype):
    """For every compute dtype the kernels take: K2's wrapper allocates
    zs/us (and feats) in the twin's dtypes and tells the kernel so; K3's
    takes them and refuses the other dtype; K4/K5 likewise with zs, at
    float32 too (split products, the head weights' planes).  The mixed
    bfloat16 contract saves f32 zs/us, which the wrappers refused
    before."""
    assert tk1.cuda_kernels_cover(_flagship(dtype)[0])
    cfg, net = _flagship(dtype)
    n = 64
    x = torch.zeros(n, tk1.LANE)
    packed = tk1.pack_trunk_weights(net, cfg, tk1.weight_dtype(cfg),
                                    planes=tk1.split_operands(cfg))
    twin = tk2._trunk_fwd_grad_plain(packed, cfg, x, want_zs=True)
    sd = tk2._saved_dtype(cfg)
    assert tk2.saved_spec(cfg, n) == ((n, cfg.layers * tk1.FEAT), sd)
    out = tk2._trunk_fwd_grad_cuda(packed, cfg, x, want_zs=True)
    for name, got, ref in zip(("sigma", "feats", "gx", "zs", "us"), out,
                              twin):
        assert got.dtype == ref.dtype, name
        assert tuple(got.shape) == tuple(ref.shape), name
    args = recorded["TRUNK_FWD_GRAD"].args
    assert recorded["TRUNK_FWD_GRAD"].feat == cfg.feat == 512
    # feats_bf16, then zs_f32 and split before layers, skip, stream
    assert args[13] == int(sd == torch.bfloat16)
    assert args[-5:-3] == (int(sd == torch.float32),
                           int(dtype == "float32"))
    zs, us = out[3], out[4]
    cs, cf, cg = torch.zeros(n), torch.zeros(n, tk1.FEAT, dtype=sd), x
    tk2._trunk_bwd_cuda(packed, cfg, x, cs, cf, cg, zs, us)
    assert recorded["TRUNK_BWD"].args[-5:-3] == (int(sd == torch.float32),
                                                  int(dtype == "float32"))
    other = torch.float32 if sd == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError):
        tk2._trunk_bwd_cuda(packed, cfg, x, cs, cf, cg, zs.to(other),
                            us.to(other))
    hw = tk4.pack_head_weights(net, cfg, tk1.weight_dtype(cfg),
                               planes=tk1.split_operands(cfg))
    cot = torch.zeros(n, tk4.HEAD_COLS)
    out4 = tk4._trunk_heads_fwd_cuda(packed, hw, cfg, x, want_zs=True)
    zs_twin = tk4._trunk_heads_fwd_plain(packed, hw, cfg, x, want_zs=True)[2]
    assert out4[2].dtype == zs_twin.dtype == sd
    # zs_f32 and split before layers, skip, stream
    flags = (int(sd == torch.float32), int(dtype == "float32"))
    assert recorded["TRUNK_HEADS_FWD"].args[-5:-3] == flags
    tk4._trunk_heads_bwd_cuda(packed, hw, cfg, x, cot, cg, out4[2])
    assert recorded["TRUNK_HEADS_BWD"].args[-5:-3] == flags
    with pytest.raises(ValueError):
        tk4._trunk_heads_bwd_cuda(packed, hw, cfg, x, cot, cg,
                                  out4[2].to(other))


@pytest.mark.parametrize("dtype,planes,ok", [
    ("float32", True, True), ("float32", False, False),
    ("bfloat16", False, True), ("bfloat16_all", False, True)])
def test_packed_layout_per_dtype(recorded, dtype, planes, ok):
    """At float32 the kernels stream the hi and lo planes (and read their
    pointers); without them the input check raises."""
    cfg, net = _flagship(dtype)
    packed = tk1.pack_trunk_weights(net, cfg, tk1.weight_dtype(cfg),
                                    planes=planes)
    x = torch.zeros(64, tk1.LANE)
    if not ok:
        with pytest.raises(ValueError, match="planes"):
            tk2._trunk_fwd_grad_cuda(packed, cfg, x)
        return
    tk2._trunk_fwd_grad_cuda(packed, cfg, x)
    args = recorded["TRUNK_FWD_GRAD"].args
    keys = tk1.PLANE_KEYS.values() if planes else tk1.PLANE_KEYS
    w0, w_mid, w_skip = (packed[k].data_ptr() for k in keys)
    assert (args[3], args[5], args[7]) == (w0, w_mid, w_skip)


@pytest.mark.parametrize("dtype", tk1.CUDA_DTYPES)
def test_fused_heads_stand_aside_at_f32_on_the_card(dtype):
    """heads_kernel_supports: K4/K5 take every dtype the trunk kernels
    take, float32 included, so the predicate holds for the flagship heads
    at every dtype, on the card as on the CPU (it read False at float32 on
    the card while K4/K5 took bf16 operands only); the predicate reads
    the heads' shapes, not their device."""
    cfg, net = _flagship(dtype)
    assert tk4.heads_kernel_supports(cfg, net, apply_brdf=True)
    on_card = dict(net.items(), fc_net=[SimpleNamespace(w=SimpleNamespace(
        device=torch.device("cuda")))])
    assert tk4.heads_kernel_supports(cfg, on_card, apply_brdf=True)


@pytest.mark.cuda
def test_f32_and_mixed_kernels_match_twins_on_the_card():
    """The float32 instantiations of K1-K3 against their exact twins
    (1e-4 relative L2, ten times closer than the bfloat16_all kernels),
    and K2 -> K3, K4 -> K5 at bfloat16 with f32 zs/us, on 640 points;
    chip_smoke.py makes the same checks at the main paths' shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.tools import f32_check
    torch.backends.cuda.matmul.allow_tf32 = False
    report = f32_check.check_f32(640)
    f32_check.check_mixed(640, report=report)
    assert all(v["rel_l2"] <= f32_check.F32_BOUND for k, v in report.items()
               if "float32" in k)


@pytest.mark.parametrize("n", [192, 8448, 131072])
def test_f32_weight_gradients_cap_each_accumulator(n):
    """The float32 weight-gradient plan cuts the trunk's K (three products
    over [h; th] of n points: 3 x 2n / 64 chunks) into contiguous slices of
    at most WGRAD_F32_CHUNKS chunks, the length past which the tensor
    cores' f32 accumulation loses the split's precision; the bf16 plan is
    unchanged."""
    st, sh = tk2.wgrad_splits(n, 8, False, 132, True)
    chunks = 3 * 2 * n // tk2.WGRAD_CHUNK
    slices = tk2.wgrad_slices(chunks, st)
    assert sh == 0 and slices[0][0] == 0 and slices[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert max(b - a for a, b in slices) <= tk2.WGRAD_F32_CHUNKS
    assert tk2.wgrad_splits(n, 8, False, 132) == tk2.wgrad_splits(
        n, 8, False, 132, False)
