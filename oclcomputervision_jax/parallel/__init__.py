from oclcomputervision_jax.parallel.mesh import (
    make_mesh,
    data_parallel,
    histeq_global_sharded,
    histeq_local_sharded,
    motion_exact_sharded,
    motion_fast_sharded,
    raisr_train_step,
    raisr_upsample_sharded,
)

__all__ = [
    "make_mesh",
    "data_parallel",
    "histeq_global_sharded",
    "histeq_local_sharded",
    "motion_exact_sharded",
    "motion_fast_sharded",
    "raisr_train_step",
    "raisr_upsample_sharded",
]
