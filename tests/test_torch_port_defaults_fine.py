"""The fine model (n_importance > 0) against the JAX package on the CPU: the
render of nerf and of spsbrdf-nerf with a fine network (the fine pass's
inverse-CDF samples on the coarse weights, its inference on the fine
network; spsbrdf's fine pass on the fused kernels' twins, the JAX side's
Pallas kernels in interpret mode), the eval render with chunk_draws,
compute_losses with the fine terms and three fused steps.  The JAX package's
functions run jitted, as its steps do (eager, its fine pass takes tens of
seconds on the CPU).

Tolerances: as tests/test_torch_port_defaults.py's (hold: the _fine keys
by close_slice at FINE_SLICE, measured there).  nerf's fine pass at
perturb 0 places its samples by the coarse weights alone, which agree to
an ulp, so it is held at 1e-5.  spsbrdf's gradient is held by
hold_grads' ulp rule: one ulp of the rays' origins moves the JAX
package's own by 2.2e-2 in relative L2 at these weights, and the port's
lies 1.2e-2 (fine trunk) from it."""

import jax
import pytest
import torch

from test_torch_port_defaults import (N_RAYS, GATES, _inputs, hold,
                                      jax_draws, jax_render, losses_match,
                                      setup, store_with_ts,
                                      three_steps_match)

from brdfnerf_tpu_torch.render import render as trender
from torch_port_common import t


@pytest.mark.parametrize("name,train", [("nerf fine", True),
                                        ("spsbrdf fine", True),
                                        ("spsbrdf fine", False)])
def test_render_rays_matches_jax(name, train):
    """render_rays key by key on the JAX package's draws: the _fine keys
    beside the _coarse ones (no sun march and no solar correction in the
    fine pass)."""
    jm, tm, jr, tr, params, tp, exact = setup(name)
    s = store_with_ts(N_RAYS, seed=2)
    key = jax.random.PRNGKey(3)
    ref = jax_render(params, jm, jr, s, key, train, jit=True)
    with torch.set_grad_enabled(train):
        got = trender.render_rays(tp, tm, tr, _inputs(trender, s, t),
                                  train=train,
                                  draws=jax_draws(key, jm, jr, N_RAYS))
    hold(got, ref, N_RAYS, exact)
    assert got["z_vals_fine"].shape == (
        N_RAYS, got["z_vals_coarse"].shape[1] + jr.n_importance)
    assert "sun_fine" not in got and "weights_sc_fine" not in got


@pytest.mark.parametrize("name", ["spsbrdf fine", "spsbrdf noise"])
def test_chunk_draws_follow_the_render(name):
    """chunk_draws in the order the render takes them from a generator:
    the fine pass's uniforms after the coarse pass's; with noise_std, every
    pass's noise."""
    _, tm, _, tr, _, tp, _ = setup(name)
    s = store_with_ts(N_RAYS, seed=4)
    draws = trender.chunk_draws(tm, tr, N_RAYS, torch.device("cpu"), 6)
    want = {"z", "guided", "sun"} | (
        {"pdf"} if tr.n_importance else
        {"noise_probe", "noise_sun", "noise"})
    assert set(draws) == want, sorted(draws)
    inp = _inputs(trender, s, t)
    with torch.no_grad():
        x = trender.render_rays(tp, tm, tr, inp, draws=draws)
        y = trender.render_rays(tp, tm, tr, inp,
                                generator=torch.Generator().manual_seed(6))
    for k in x:
        assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("name", ["nerf fine", "spsbrdf fine"])
def test_compute_losses_match_jax(name):
    """compute_losses with the fine terms: the loss, every term (the fine
    color and depth terms beside the coarse ones) and every gradient, the
    fine network's included."""
    losses_match(name, GATES, ill_conditioned=name.startswith("spsbrdf"))


def test_three_fused_steps_match_jax():
    """make_fused_train_step with the fine network, spsbrdf-nerf (K2/K3's
    twins twice a step), three steps against the JAX package's."""
    three_steps_match("spsbrdf fine")


@pytest.mark.cuda
@pytest.mark.parametrize("case,want,want_heads", [
    ("fine", [2, 2, 2, 0, 0], [2, 0, 0, 2, 2]),
    ("beta", [2, 1, 1, 0, 0], [2, 1, 1, 0, 0]),
    ("normal_at_surface", [2, 0, 0, 0, 0], [2, 0, 0, 0, 0])])
def test_launches_on_the_card(case, want, want_heads, monkeypatch):
    """At the flagship width, spsbrdf-nerf's stage-2 step launches K1-K5
    (want: [K1, K2, K3, K4, K5] a step) with the fine network (K2/K3 on
    each network), with beta (one K2/K3; with BRDFNERF_FUSED_HEADS set
    K4/K5 refuse the t-embedding) and with normal_at_surface (K1 alone).
    want_heads: with the switch set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from brdfnerf_tpu_torch import config as tconfig
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.parallel import train_step as tts
    from test_torch_port_train import train_configs
    from torch_port_common import FLAGSHIP_HEADS, make_store, torch_batch
    tm = tconfig.ModelConfig(variant="spsbrdf-nerf", siren=True,
                             mapping=True, compute_dtype="bfloat16_all",
                             beta=case == "beta", **FLAGSHIP_HEADS)
    tr = tconfig.RenderConfig(
        n_samples=64, guided_samples=64, apply_brdf=True, use_pallas=True,
        fused_trunk=True, n_importance=64 if case == "fine" else 0,
        normal_at_surface=case == "normal_at_surface")
    _, tt = train_configs(batch_size=256)
    kernels = (k1.TRUNK_SIGMA, k2.TRUNK_FWD_GRAD, k2.TRUNK_BWD,
               k4.TRUNK_HEADS_FWD, k4.TRUNK_HEADS_BWD)
    store = {k: v.cuda() for k, v in torch_batch(make_store(256)).items()}
    for heads, launches in ((False, want), (True, want_heads)):
        if heads:
            monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
        state, opt = tts.create_train_state(
            tm, tt, 1, n_importance=tr.n_importance, device="cuda")
        step = tts.make_fused_train_step(
            tm, tr, tt, opt, tts.GateSchedule(1e18, 1e18, -1.0, 1, 0))
        for k in kernels:
            k.launches = 0
        state, m = step(state, store, torch.arange(256, device="cuda"), 0)
        assert np.isfinite(float(m["loss"]))
        assert [k.launches for k in kernels] == launches, (case, heads)
