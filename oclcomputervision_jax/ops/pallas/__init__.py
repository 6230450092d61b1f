"""Hand-written GPU kernels for hot stages.

Each kernel keeps a plain JAX form beside it in ``oclcomputervision_jax.ops``
(the form other backends run, and the reference its tests compare with).
"""
