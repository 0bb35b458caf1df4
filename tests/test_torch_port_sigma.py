"""K1's operand split (ops/fused_mlp.py): split_bf16, and the plain
emulation of the kernel's arithmetic, _trunk_sigma_split, against the
Pallas _trunk_kernel (interpret mode on the CPU) and against the twin
_trunk_sigma_plain.

K1 (csrc/trunk_sigma.cu) multiplies each f32 operand a as hi + lo =
bf16(a) + bf16(a - bf16(a)) by the bf16 weights, two bf16 products summed
in f32.  hi + lo holds a to 2^-16 relative, so the emulation agrees with
the f32 arithmetic of the Pallas kernel and the twin to within summation
order: relative L2 <= 1e-4 (measured here, 4 x 64 and 8 x 64 on 200
points: sigma at most 2.3e-6 against Pallas and against the twin, feats
8.4e-6; at the flagship 8 x 512 the emulation gives sigma 2.6e-6 against
the twin on 8,192 points, and the kernel on the card 2.9e-6).
"""

import numpy as np
import pytest
import torch

from brdfnerf_tpu.ops import pallas_mlp as jk1

from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.models import network as tnet

from test_torch_port_kernels import _inputs
from torch_port_common import SMALL, model_configs, networks, t


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16_reconstructs_f32(seed):
    """hi + lo holds a to 2^-16 relative over normal values whose low term
    is normal too (|a| >= 2^-110) up to bf16's largest finite; 0 splits
    exactly, and an f32 subnormal to half of bf16's least subnormal."""
    rng = np.random.RandomState(seed)
    mant = rng.uniform(1.0, 2.0, 4096) * rng.choice([-1.0, 1.0], 4096)
    expo = rng.randint(-110, 127, 4096)
    vals = np.concatenate([
        mant * np.exp2(expo.astype(np.float64)),
        rng.normal(size=4096),
        [1.0, -1.0, 2.0 ** -110, -(2.0 ** -110), 1e38, -1e38,
         3.3e38, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -17, np.pi]]).astype(
             np.float32)
    a = torch.from_numpy(vals)
    hi, lo = tk1.split_bf16(a)
    assert hi.dtype == lo.dtype == torch.bfloat16
    back = hi.double() + lo.double()
    err = (back - a.double()).abs() / a.double().abs()
    assert float(err.max()) <= 2.0 ** -16, float(err.max())
    # the terms are the kernel's: hi rounds a, lo rounds what hi left
    assert torch.equal(hi, a.to(torch.bfloat16))
    assert torch.equal(lo, (a - hi.float()).to(torch.bfloat16))
    zero = torch.zeros(3)
    hz, lz = tk1.split_bf16(zero)
    assert float(hz.abs().max()) == 0.0 and float(lz.abs().max()) == 0.0
    sub = torch.tensor([1e-40, -3e-39, 2.0 ** -140], dtype=torch.float32)
    hs, ls = tk1.split_bf16(sub)
    d = (hs.double() + ls.double() - sub.double()).abs()
    assert float(d.max()) <= 2.0 ** -134


@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
@pytest.mark.parametrize("want_feats", [False, True])
def test_k1_split_matches_pallas_and_twin(layers, skip, want_feats):
    """_trunk_sigma_split (K1's arithmetic) against the Pallas kernel in
    interpret mode and against _trunk_sigma_plain, on the same weights and
    inputs: sigma (and feats) relative L2 <= 1e-4."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype="bfloat16_all"))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    s_ref, f_ref = jk1.fused_trunk_sigma(params, jcfg, enc, interpret=True,
                                         want_feats=want_feats)
    packed = tk1.pack_trunk_weights(net, tcfg, torch.bfloat16)
    x = tk1.pad_rows_lanes(t(enc), 256, tk1.LANE)
    s_got, f_got = tk1._trunk_sigma_split(packed, tcfg, x, want_feats)
    s_tw, f_tw = tk1._trunk_sigma_plain(packed, tcfg, x, want_feats)
    assert tuple(s_got.shape) == (256,)
    assert _rel(s_got[:200], s_ref) <= 1e-4
    assert _rel(s_got, s_tw) <= 1e-4
    if want_feats:
        assert tuple(f_got.shape) == (256, 64)
        assert _rel(f_got[:200], np.asarray(f_ref)) <= 1e-4
        assert _rel(f_got, f_tw) <= 1e-4
    else:
        assert f_got is None and f_ref is None


def test_k1_split_is_closer_than_bf16_activations(monkeypatch):
    """The split is what repairs the bf16 rounding of the activations: the
    same trunk with every operand rounded to bf16 once (K1 before the
    split) lands orders of magnitude further from the twin."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=8, skips=(4,),
                                      compute_dtype="bfloat16_all"))
    _, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    packed = tk1.pack_trunk_weights(net, tcfg, torch.bfloat16)
    x = tk1.pad_rows_lanes(t(enc), 256, tk1.LANE)
    s_tw, _ = tk1._trunk_sigma_plain(packed, tcfg, x, False)
    s_sp, _ = tk1._trunk_sigma_split(packed, tcfg, x, False)
    monkeypatch.setattr(tk1, "split_bf16", lambda a: (
        a.to(torch.bfloat16), torch.zeros_like(a, dtype=torch.bfloat16)))
    s_hi, _ = tk1._trunk_sigma_split(packed, tcfg, x, False)
    assert _rel(s_hi, s_tw) >= 100 * _rel(s_sp, s_tw)


@pytest.mark.cuda
@pytest.mark.parametrize("want_feats", [False, True])
def test_k1_matches_twin_on_the_card(want_feats):
    """K1 against its twin on the card at the flagship width (8 x 512,
    skip 4) on 192 points (3 tiles: a ragged last wave), twice with
    bit-identical outputs, at chip_smoke.py's bounds (sigma max 5e-5 and
    mean 5e-6 of its scale; feats 2e-4 and 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all")
    g = torch.Generator(device="cuda").manual_seed(0)
    net = tnet.init_network(cfg, g, device="cuda")
    xyz = torch.rand(192, 3, device="cuda", generator=g) * 2 - 1
    enc = positional_encoding(xyz, 10, fast=True, pad_to=128)
    packed = tk1.pack_trunk_weights(net, cfg, torch.bfloat16)
    got = tk1._trunk_sigma_cuda(packed, cfg, enc, want_feats)
    again = tk1._trunk_sigma_cuda(packed, cfg, enc, want_feats)
    ref = tk1._trunk_sigma_plain(packed, cfg, enc, want_feats)
    torch.cuda.synchronize()
    bounds = ((5e-5, 5e-6), (2e-4, 2e-5))
    for (k_, a_, r_), (mx, mn) in zip(zip(got, again, ref), bounds):
        if r_ is None:
            assert k_ is None
            continue
        assert torch.equal(k_, a_)
        d = (k_ - r_).abs()
        scale = float(r_.abs().max())
        assert float(d.max()) <= mx * scale
        assert float(d.mean()) <= mn * scale
