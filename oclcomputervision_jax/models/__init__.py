from oclcomputervision_jax.models.raisr import RaisrModel, train_filters

__all__ = ["RaisrModel", "train_filters"]
