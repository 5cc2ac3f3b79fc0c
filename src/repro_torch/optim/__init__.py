"""Local optimizers over the packed client rows."""
from repro_torch.optim.optimizers import Optimizer, adamw, clip_by_global_norm, sgd

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "sgd"]
