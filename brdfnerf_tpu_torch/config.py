"""Static run configuration: the port's own copy of the JAX package's
config dataclasses, so both packages read and write one opts.json /
RunConfig contract without the port importing the JAX package.

  * ModelConfig  - architecture switches (head layout, trunk size, encoding)
  * RenderConfig - sampling counts / render-path switches
  * TrainConfig  - optimizer, schedule-gate fractions, loss weights
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

MODEL_VARIANTS = ("nerf", "s-nerf", "sat-nerf", "sps-nerf", "spsbrdf-nerf")
NORMAL_MODES = ("none", "analystic", "learned", "analystic_learned")
SUN_V_MODES = ("none", "analystic", "learned")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of one NeRF-family model (reference: models/*.py)."""

    variant: str = "spsbrdf-nerf"
    layers: int = 8                      # trunk depth   (opt.py:174-175 fc_layers)
    feat: int = 512                      # trunk width   (opt.py:172-173 fc_feat)
    skips: Tuple[int, ...] = (4,)
    siren: bool = True                   # opt.py:225-226
    mapping: bool = False                # positional encoding on/off (opt.py:211-212)
    mapping_sizes: Tuple[int, int] = (10, 4)   # xyz / dir frequencies (nerf.py:165)
    input_viewdir: bool = False          # spsbrdfnerf.py:458 input_sizes [3,3] vs [3,0]
    # heads
    beta: bool = False                   # transient uncertainty head (opt.py:209-210)
    t_embedding_vocab: int = 30          # opt.py:201-202
    t_embedding_tau: int = 4             # opt.py:199-200
    sun_v: str = "none"                  # none | analystic | learned (opt.py:231)
    indirect_light: bool = False         # sky color head (opt.py:228-229)
    normal: str = "none"                 # none|analystic|learned|analystic_learned (opt.py:230)
    # BRDF selection (mutually exclusive branches, spsbrdfnerf.py:483-496)
    roughness: bool = False              # Microfacet (opt.py:271-272)
    func_m: bool = False                 # RPV Minnaert (opt.py:302-303)
    func_f: bool = False                 # RPV HG phase (opt.py:304-305)
    func_h: int = 0                      # RPV hotspot; 2 => rhoc:=albedo (opt.py:306-307, spsbrdfnerf.py:306)
    dim_rpv: int = 1                     # 1 or 3 (opt.py:308-309)
    hapke_b: bool = False                # opt.py:287-288
    hapke_c: bool = False                # opt.py:289-290
    hapke_theta: bool = False            # opt.py:295-296
    hapke_h: bool = False                # opt.py:293-294 (opposition width; unused by blessed cfgs)
    hapke_b0: bool = False               # opt.py:291-292
    shell_hapke: int = 0                 # opt.py:285-286
    hpk_scl: float = 4.0                 # opt.py:283-284
    glossy_scale: float = 1.0            # opt.py:273-274
    fresnel_f0: float = 0.04             # opt.py:279-280
    multi_brdf: bool = False             # per-sample vs per-ray BRDF (opt.py:261-262)
    rgb_padding: float = 0.001           # nerf.py:171
    # matmul compute dtype.  'bfloat16': bf16 operands with float32
    # accumulation, float32 activations.  'bfloat16_all': activations are
    # stored in bf16 too.  'int8' is a serving-only quantized trunk
    # (models/network._linear_int8).
    compute_dtype: str = "float32"
    # polynomial sine for siren activations (ops/fast_math.py), 1.7e-5
    # abs error; False = exact sin.
    fast_sin: bool = True

    @property
    def rpv(self) -> bool:
        """RPV active if any of its sub-functions is on.  The reference
        compares each flag `== True` (spsbrdfnerf.py:468), so funcH=2
        ('rhoc := albedo') does NOT by itself activate the RPV branch."""
        return bool(self.func_m or self.func_f or self.func_h == 1)

    @property
    def uses_hapke(self) -> bool:
        return (not self.roughness and not self.rpv
                and (self.hapke_b or self.shell_hapke > 0))

    @property
    def input_sizes(self) -> Tuple[int, int]:
        if self.variant == "nerf":
            return (3, 3)                           # nerf.py:170
        if self.variant == "spsbrdf-nerf":
            return (3, 3) if self.input_viewdir else (3, 0)   # spsbrdfnerf.py:458
        return (3, 0)                               # snerf.py:84, satnerf.py analog

    @property
    def xyz_in_dim(self) -> int:
        # positional encoding excludes the identity term (nerf.py:63-64)
        return 2 * self.mapping_sizes[0] * 3 if self.mapping else 3

    @property
    def dir_in_dim(self) -> int:
        d = self.input_sizes[1]
        if d == 0:
            return 0
        return 2 * self.mapping_sizes[1] * d if self.mapping else d


@dataclass(frozen=True)
class RenderConfig:
    """Render-path switches (reference: rendering.py:168-334)."""

    n_samples: int = 64                  # opt.py:176-177
    n_importance: int = 0                # opt.py:178-179
    guided_samples: int = 64             # opt.py:217-218
    use_disp: bool = False
    perturb: float = 1.0                 # rendering.py:176 (hardcoded 1.0)
    noise_std: float = 0.0               # opt.py:180-181
    std_range: float = 3.0               # dRange (opt.py:259-260)
    stdscale: float = 1.0                # opt.py:221-222
    margin: float = 0.0001               # opt.py:219-220
    # static render-path structure gates (see module docstring)
    apply_brdf: bool = False
    apply_theta: bool = False
    gsam_only: bool = False
    use_sat_sun: bool = True             # rays carry sun dirs in cols 8:11 (data == 'sat')
    # run the sigma-only passes (coarse depth probe + analytic sun march)
    # through the fused trunk-sigma kernel (ops/fused_mlp.py).  Both passes
    # are consumed only through detached values, so no gradient is needed.
    # Requires a single-skip trunk (the reference architecture).  The field
    # keeps the JAX package's name so opts.json stays one contract.
    use_pallas: bool = False
    # --TestSun_v (opt.py:247, main.py:391): force the analytic
    # sun-visibility march even when apply_brdf is off, so validation/eval
    # can render the sun map before the BRDF phase starts
    force_sun_march: bool = False
    # Sample count of the analytic sun-visibility march.  0 (default) =
    # the REFERENCE'S intent: N_samples (rendering.py:251-253 marches
    # `N_samples`, i.e. 64 at the blessed config — its shape error at
    # spsbrdfnerf.py:266 came from tiling that (N, 64) result against the
    # 128-sample merged pass, which this framework avoids by consuming
    # only the per-ray transparency).  -1 = the merged final count
    # (n_samples + guided, rounds 1-3 behavior).  Any positive int =
    # explicit count.
    sun_march_samples: int = 0
    # run the differentiated trunk of the main inference (sigma + feats +
    # analytic density-gradient normals) through the fused
    # trunk-with-gradient kernel (ops/fused_trunk_vjp.py); same semantics as
    # the autograd path.
    fused_trunk: bool = False
    # deviates from reference semantics, off by default: evaluate the
    # analytic normal once per ray at the expected surface point instead of
    # at every sample (the main pass then runs no fused trunk kernel).
    normal_at_surface: bool = False

    @property
    def total_samples(self) -> int:
        n = self.n_samples
        if self.guided_samples > 0 and not self.gsam_only:
            n += self.effective_guided
        elif self.gsam_only:
            n = self.effective_guided
        return n

    @property
    def effective_guided(self) -> int:
        # guided_samples == 2 degenerates to 1 mean sample (rendering.py:240-242)
        return 1 if self.guided_samples == 2 else self.guided_samples

    def sun_march_count(self, final_count: int) -> int:
        """Sample count of the analytic sun march.  sun_march_samples = 0
        follows the reference (rendering.py:251-253): effective_guided
        under gsam_only, else n_samples; -1 = the merged final count
        (rounds 1-3 behavior); any positive value is explicit."""
        if self.sun_march_samples == -1:
            return final_count
        if self.sun_march_samples > 0:
            return self.sun_march_samples
        return self.effective_guided if self.gsam_only else self.n_samples


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / loss weights (reference: opt.py + main.py)."""

    lr: float = 5e-4                     # opt.py:156-157
    batch_size: int = 1024               # opt.py:158-159
    max_train_steps: int = 300000        # opt.py:162-163
    lr_scheduler: str = "step"           # StepLR gamma=0.9/epoch (train_utils.py:153-155)
    lr_gamma: float = 0.9
    # linear lr warmup from lr/10 (0 = off — the default; -1 = 2 epochs;
    # -2 = explicitly off; positive = explicit step count).  Opt-in even
    # under scale_global_batch: the measured lr-rule grid at equal epochs
    # (examples/results/scaled_batch_convergence.json, batch 8192 on the
    # bumpy AOI vs batch-1024's 32.44 dB) is monotonic in effective lr —
    # linear x8 no-warmup 30.84, +2-epoch warmup 28.71, sqrt-scaled
    # 27.10, unscaled 24.62 — i.e. Goyal et al.'s warmup (built for
    # instability at very large batch) only costs steps at these
    # horizons, so the linear-scaling rule ships WITHOUT it by default
    lr_warmup_steps: int = 0
    # loss weights
    lambda_rgb: float = 1.0              # opt.py:186-187
    sc_lambda: float = 0.0               # opt.py:188-189
    ds_lambda: float = 0.0               # opt.py:190-191
    ds_drop: float = 1.0                 # opt.py:193-194
    ds_noweights: bool = False
    gnll: bool = False                   # opt.py:213-214
    usealldepth: bool = False            # opt.py:215-216
    nr_reg_an_lambda: float = 0.0        # opt.py:232-233
    nr_reg_lr_lambda: float = 0.0
    nr_spv_lambda: float = 0.0
    nr_spv_type: int = 0                 # derived from normal mode (opt.py:328-334)
    hs_lambda: float = 0.0               # opt.py:240-241
    first_beta_epoch: int = 2            # opt.py:197-198
    # schedule gate fractions
    brdf_on: float = 1.0                 # opt.py:242-243
    nrrg_on: float = 0.0                 # opt.py:244-245
    cos_irra_on: float = 1.0             # opt.py:257-258
    gsam_only_on: float = 1.0            # opt.py:255-256


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = ModelConfig()
    render: RenderConfig = RenderConfig()
    train: TrainConfig = TrainConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        d = json.loads(s)
        for k in ("skips", "mapping_sizes"):
            if k in d.get("model", {}):
                d["model"][k] = tuple(d["model"][k])
        return RunConfig(
            model=ModelConfig(**d["model"]),
            render=RenderConfig(**d["render"]),
            train=TrainConfig(**d["train"]),
        )


def derive_nr_spv_type(normal: str, nr_spv_type: int = 0) -> int:
    """Reference post-processing of --nr_spv_type (opt.py:328-334)."""
    if nr_spv_type != 0:
        return nr_spv_type
    return {"analystic_learned": 1, "learned": 2, "analystic": 3}.get(normal, 0)
