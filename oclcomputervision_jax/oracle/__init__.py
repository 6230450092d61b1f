"""NumPy reference implementations — the bit-exactness contract.

Every op in ``oclcomputervision_jax.ops`` is tested against these
oracles, which themselves reproduce the observable behavior of the
reference's CPU paths (file:line citations inline). Where the reference
ships a bug, the oracle exposes both 'shipped' behavior (for
bit-matching) and a 'fixed' variant (documented per function).
"""

from oclcomputervision_jax.oracle.histeq import (
    apply_block_mappings,
    calc_transfer_func,
    clip_histogram,
    hist_grid,
    histeq_global,
    histeq_local_block,
)
from oclcomputervision_jax.oracle.interpolation import resize_align_corners
from oclcomputervision_jax.oracle.pyramid import gaussian_pyramid, pyr_down
from oclcomputervision_jax.oracle.motion import (
    estimate_motion_fast,
    estimate_motion_vector,
    upscale_mv,
)

__all__ = [
    "apply_block_mappings",
    "calc_transfer_func",
    "clip_histogram",
    "hist_grid",
    "histeq_global",
    "histeq_local_block",
    "resize_align_corners",
    "gaussian_pyramid",
    "pyr_down",
    "estimate_motion_fast",
    "estimate_motion_vector",
    "upscale_mv",
]
