"""How well conditioned chip_smoke.py's whole-step check is along the
training run: the same check (one step's parameter gradients on 128 rays,
the kernels on the card against the backward's twin, both twins of the
differentiated trunk, every twin on the card, and the twins on the CPU)
at the weights of the flagship stage-2 run (chip_smoke.py's store, seed,
gates) after a number of steps, trained with the kernels and with every
twin on the card, switch off.  For each point it prints the largest
relative L2 of each comparison and the tensors that reach it, on the whole
batch and on the rays that chip_smoke.ill_conditioned_rays leaves (the
batch chip_smoke.py holds to the bounds); nothing is asserted.  At the weights of chip_smoke.py's last check point (after
WARM_STEPS + TIMED_STEPS steps with the kernels) it also prints where the
kernels-vs-twins gap comes from: each loss term's trunk gradients, the
share of the sigma cotangent's gap that each ray carries, and RPV's
angles on the rays that carry the most.  Run from the repo root (it takes
chip_smoke.py's set-up).

    python3 -m brdfnerf_tpu_torch.tools.step_check_points
"""

from __future__ import annotations

import subprocess
import sys
import tempfile

import numpy as np
import torch

STEPS = (0, 3, 8, 16, 24, 35, 36)


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.data.batcher import DeviceRayBatcher
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.parallel import train_step as ts
    from brdfnerf_tpu_torch.render import inference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.TemporaryDirectory()
    argv = ["--root_dir", tmp.name, "--exp_name", "points",
            "--model", "spsbrdf-nerf", "--fc_layers", "8", "--fc_feat",
            "512", "--mapping", "--siren", "1", "--fast_sin", "1",
            "--compute_dtype", "bfloat16_all", "--normal", "analystic",
            "--sun_v", "analystic", "--funcM", "1", "--funcF", "1",
            "--funcH", "1", "--dim_RPV", "1", "--brdf_on", "0.5",
            "--n_samples", str(cs.N_SAMPLES), "--guided_samples",
            str(cs.N_SAMPLES), "--chunk", str(cs.CHUNK),
            "--lr", "5e-4", "--batch_size", str(cs.BATCH), "--ds_lambda",
            "10", "--nr_reg_an_lambda", "0.1", "--hs_lambda", "0.5"]
    args = opts.postprocess(opts.train_parser().parse_args(argv))
    cfg = opts.to_run_config(args, device="cuda")
    mcfg, rcfg, tcfg = cfg.model, cfg.render, cfg.train
    sched = ts.GateSchedule(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                            steps_per_epoch=1, first_beta_epoch=0)
    twins = ((k1, "_trunk_sigma_cuda", k1._trunk_sigma_plain),
             (k2, "_trunk_fwd_grad_cuda", k2._trunk_fwd_grad_plain),
             (k2, "_trunk_bwd_cuda", k2._trunk_bwd_plain))
    kernels = [(m, name, getattr(m, name)) for m, name, _ in twins]

    def use(swaps):
        for sw in swaps:
            setattr(*sw)

    s = cs.make_store(cs.CHECK_RAYS, np.random.RandomState(1))
    gates = ts.gates_from_step(cs.WARM_STEPS, sched)
    rng = torch.Generator().manual_seed(11)
    n_sun = rcfg.sun_march_count(rcfg.n_samples + rcfg.effective_guided)
    draws = {"z": torch.rand(cs.CHECK_RAYS, rcfg.n_samples, generator=rng),
             "guided": torch.rand(cs.CHECK_RAYS, rcfg.effective_guided,
                                  generator=rng),
             "guided_gt": torch.rand(cs.CHECK_RAYS, rcfg.effective_guided,
                                     generator=rng),
             "sun": torch.rand(cs.CHECK_RAYS, n_sun, generator=rng)}

    def grads_on(net_, dev, rays):
        batch = {k: torch.as_tensor(v[rays], device=dev)
                 for k, v in s.items()}
        rows = torch.as_tensor(rays)
        net_.zero_grad(set_to_none=True)
        loss, _ = ts.compute_losses(
            net_, mcfg, rcfg, tcfg, batch, gates,
            draws={k: v[rows].to(dev) for k, v in draws.items()})
        loss.backward()
        return {k: p.grad.detach().cpu() for k, p in net_.named_parameters()}

    def check(net_, label):
        """The four comparisons on the whole batch and on the rays that
        chip_smoke.ill_conditioned_rays leaves."""
        import copy
        net_cpu = copy.deepcopy(net_).cpu()
        bad = cs.ill_conditioned_rays(
            net_cpu, mcfg, rcfg, {k: torch.as_tensor(v) for k, v in s.items()},
            draws, gates, 0.1).numpy()
        for rays in (np.arange(cs.CHECK_RAYS), np.flatnonzero(~bad)):
            use(kernels)
            g_k = grads_on(net_, "cuda", rays)
            use(twins[2:])
            g_b = grads_on(net_, "cuda", rays)
            use(twins[1:])
            g_fb = grads_on(net_, "cuda", rays)
            use(twins)
            g_t = grads_on(net_, "cuda", rays)
            use(kernels)
            g_p = grads_on(net_cpu, "cpu", rays)
            out = []
            for name, got, ref in (("backward", g_k, g_b),
                                   ("both", g_k, g_fb),
                                   ("all vs CPU", g_k, g_p),
                                   ("twins card vs CPU", g_t, g_p)):
                rels = sorted(((cs.rel_l2(got[k], ref[k]), k) for k in ref),
                              reverse=True)
                out.append(f"{name} {rels[0][0]:.2e} ({rels[0][1]}, "
                           f"{rels[1][1]} {rels[1][0]:.1e})")
            print(f"  {label}, {len(rays)} rays: " + "; ".join(out),
                  flush=True)

    def sources(net_):
        """Each loss term's gradients with the kernels and with both twins
        of the differentiated trunk on the card (K1 the kernel in both),
        the sigma cotangent K3 or its twin is given, and RPV's (brdf, M1,
        F, G, H, cos i, cos v) of every ray."""
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in s.items()}
        seen = {}
        run_bwd, rpv = k2._run_bwd, inference.rpv_brdf

        def bwd(cfg_, packed, x, c_sigma, *rest):
            seen["c_sigma"] = c_sigma.detach().cpu()
            return run_bwd(cfg_, packed, x, c_sigma, *rest)

        def brdf(*a, **k):
            got = rpv(*a, **k)
            seen["rpv"] = [v.detach().cpu() for v in got]
            return got

        k2._run_bwd, inference.rpv_brdf = bwd, brdf
        out = {}
        params = list(net_.parameters())
        names = [k for k, _ in net_.named_parameters()]
        try:
            for path, swaps in (("kernels", kernels), ("twins", twins[1:])):
                use(swaps)
                loss, (terms, _) = ts.compute_losses(
                    net_, mcfg, rcfg, tcfg, batch, gates,
                    draws={k: v.cuda() for k, v in draws.items()})
                grads = {}
                for term, v in list(terms.items()) + [("all", loss)]:
                    if torch.is_tensor(v) and v.requires_grad:
                        gs = torch.autograd.grad(v, params, retain_graph=True,
                                                 allow_unused=True)
                        grads[term] = {
                            n: g.detach().cpu() for n, g in zip(names, gs)
                            if g is not None}
                # the last backward, the whole loss's, left its cotangent
                out[path] = (grads, seen["c_sigma"], seen["rpv"])
        finally:
            k2._run_bwd, inference.rpv_brdf = run_bwd, rpv
            use(kernels)
        return out

    def explain(net_, label):
        out = sources(net_)
        (g_k, cs_k, rpv_k), (g_t, cs_t, _) = out["kernels"], out["twins"]
        for term in g_k:
            rels = sorted(((cs.rel_l2(g_k[term][k], g_t[term][k]), k)
                           for k in g_t[term] if g_t[term][k].norm() > 0),
                          reverse=True)
            print(f"  {label}, {term}: kernels vs both twins on the card "
                  f"{rels[0][0]:.3e} ({rels[0][1]})", flush=True)
        gap = (cs_k - cs_t).reshape(cs.CHECK_RAYS, -1).norm(dim=1) ** 2
        share = gap / gap.sum()
        ci = rpv_k[5].flatten()
        print(f"  {label}: sigma cotangent relative L2 "
              f"{float((cs_k - cs_t).norm() / cs_t.norm()):.3e}; rays with "
              f"|cos i| < 1e-2: {int((ci.abs() < 1e-2).sum())} of "
              f"{cs.CHECK_RAYS}", flush=True)
        for r in torch.argsort(share, descending=True)[:3].tolist():
            print(f"    ray {r}: {float(share[r]):.4%} of the sigma "
                  f"cotangent's squared gap; cos i {float(ci[r]):.3e}, cos v "
                  f"{float(rpv_k[6].flatten()[r]):.3e}, G "
                  f"{float(rpv_k[3].flatten()[r]):.3e}, M1 "
                  f"{float(rpv_k[1].reshape(cs.CHECK_RAYS, -1)[r, 0]):.3e}",
                  flush=True)

    last = cs.WARM_STEPS + cs.TIMED_STEPS
    for path, swaps in (("kernels", kernels), ("twins", twins)):
        use(swaps)
        batcher = DeviceRayBatcher(
            cs.make_store(cs.STORE_BATCHES * cs.BATCH,
                          np.random.RandomState(0)),
            cs.BATCH, seed=0, device="cuda")
        state, optimizer = ts.create_train_state(
            mcfg, tcfg, cs.STORE_BATCHES, seed=0, device="cuda")
        step = ts.make_fused_train_step(mcfg, rcfg, tcfg, optimizer, sched)
        done = 0
        for target in STEPS:
            use(swaps)
            while done < target:
                state, _ = step(state, batcher.store,
                                batcher.next_index_tensor(), 0)
                done += 1
            check(state.params, f"trained with the {path}, {done} steps")
            if path == "kernels" and done == last:
                explain(state.params, f"trained with the kernels, {done} "
                        "steps")
    use(kernels)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
