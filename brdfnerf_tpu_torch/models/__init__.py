"""The port's model families as torch modules (the JAX package's
models/)."""

from .network import (
    init_network,
    apply_network,
    sigma_fn,
    analytic_normals,
    init_t_embedding,
    model_config_for_variant,
)

__all__ = [
    "init_network",
    "apply_network",
    "sigma_fn",
    "analytic_normals",
    "init_t_embedding",
    "model_config_for_variant",
]
