"""The port's render_rays step (the JAX package's render/)."""

from .render import render_rays, RenderInputs

__all__ = ["render_rays", "RenderInputs"]
