"""brdfnerf_tpu_torch: the PyTorch / CUDA port of brdfnerf_tpu, for an
NVIDIA H100.

The JAX package `brdfnerf_tpu` stays the reference; this package imports
nothing of it (and no JAX, PIL or cv2) and keeps its own copies of the
host code it needs.  Layout mirrors the JAX package:

  config    - run configuration dataclasses (the shared opts.json contract)
  ops       - encoding, samplers, compositing, and the fused trunk kernels'
              wrappers (fused_mlp: K1, fused_trunk_vjp: K2 and K3,
              fused_trunk_heads: K4 and K5)
  csrc      - the CUDA C++ sources of those kernels, built with nvcc at
              first use, and a host C source (the PNG row unfilter) built
              with the system C compiler
  brdf      - RPV, Hapke and Microfacet physics
  models    - the network as an nn.Module
  render    - render_rays (every variant)
  parallel  - the train step (losses, gates, Adam; N steps a call), the
              render step and the block render of whole images
  losses    - the loss suite;  metrics - mse / psnr / ssim, masked scores
  data      - the ray batchers, the satellite and blender datasets, the
              synthetic AOI and blender scene
  geo       - RPC camera model (host), geodesy, DSM and its registration
  train     - Trainer: the training loop, checkpoints, resume, validation
  cli       - flags and opts.json round-trip; the train, eval, create_dsm,
              brf_probe, depth_qa, convert_ckpt and generate_dataset CLIs
  dataset_gen - offline dataset generation (JSONs, masks, splits, crops)
  serve     - load_renderer / Renderer, the image render (block render or
              chunk loop)
  analysis  - BRF probes; the training store's BRDF observability warning
  utils     - npz checkpoint and optimizer-state I/O, reference .ckpt
              import / export, GeoTIFF, PNG, resampling, the panels (viz),
              the NaN guards, devices

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
