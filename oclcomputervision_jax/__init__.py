"""oclComputerVision in JAX: a JAX/XLA/Pallas computer-vision framework.

A from-scratch rebuild of the capabilities of saturdaycoder/oclComputerVision
(an OpenCL image-processing toolkit), run on NVIDIA GPUs:

- Fused histogram equalization (global + local-block / CLAHE-style)
  replacing the reference's device->host->device roundtrips
  (reference: histeq/eq_global.py, histeq/eq_local_block.py, histeq/hist.cl).
- Bilinear / bicubic (Catmull-Rom) align-corners interpolation
  (reference: basic/interpolation.{py,cl}).
- Gaussian pyramids (reference: pyramid/pyramid.py).
- Pyramidal dense block-matching motion estimation, vectorized over the
  whole image instead of a per-pixel Python loop
  (reference: motion_estimation/me_pyramid.py).
- RAISR single-image super-resolution: fused inference kernel AND a JAX
  least-squares filter-bank trainer (the reference only loads pre-trained
  weights from a missing pickle; reference: super_resolution/raisr.{py,cl}).

Layers:
- ``oracle``   : NumPy reference implementations (the bit-exactness contract).
- ``ops``      : JAX/XLA implementations + a Pallas GPU kernel for RAISR's apply.
- ``models``   : RAISR model (train + apply), batched enhancement pipelines.
- ``parallel`` : jax.sharding Mesh helpers, data/spatial/tensor sharding.
- ``utils``    : image/.flo IO, metrics (PSNR/MAE/EPE), profiling, configs.
- ``compat``   : drop-in API matching the reference's public signatures.
"""

__version__ = "0.1.0"

from oclcomputervision_jax import utils  # noqa: F401
