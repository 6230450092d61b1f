from oclcomputervision_jax.ops.histeq import (
    calc_transfer_func,
    hist_grid,
    histeq_global,
    histeq_local_block,
    histogram256,
)
from oclcomputervision_jax.ops.interpolation import resize, resize_uint8
from oclcomputervision_jax.ops.pyramid import gaussian_pyramid, pyr_down
from oclcomputervision_jax.ops.motion import estimate_motion_vector, upscale_mv

__all__ = [
    "calc_transfer_func",
    "hist_grid",
    "histeq_global",
    "histeq_local_block",
    "histogram256",
    "resize",
    "resize_uint8",
    "gaussian_pyramid",
    "pyr_down",
    "estimate_motion_vector",
    "upscale_mv",
]
