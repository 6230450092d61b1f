from oclcomputervision_jax.utils.assets import asset_path, load_image, load_gray
from oclcomputervision_jax.utils.flo import read_flo, write_flo
from oclcomputervision_jax.utils.metrics import psnr, mae, epe
from oclcomputervision_jax.utils.profiling import timed, Timer

__all__ = [
    "asset_path",
    "load_image",
    "load_gray",
    "read_flo",
    "write_flo",
    "psnr",
    "mae",
    "epe",
    "timed",
    "Timer",
]
