"""Encoding, sampling and compositing of the port, and the wrappers of its
CUDA kernels (the JAX package's ops/)."""

from .encoding import positional_encoding
from .compositing import composite, depth_std, depth_var
from .sampling import (
    stratified_z_vals,
    sample_pdf,
    sample_gaussian_3sigma,
    sample_gaussian_3sigma_sym,
    samples_around_depth,
    guided_samples,
)

__all__ = [
    "positional_encoding",
    "composite",
    "depth_std",
    "depth_var",
    "stratified_z_vals",
    "sample_pdf",
    "sample_gaussian_3sigma",
    "sample_gaussian_3sigma_sym",
    "samples_around_depth",
    "guided_samples",
]
