"""Optimizers (`repro.optim`): sgd, momentum and adamw over tensor trees."""
from .optimizers import Optimizer, make_optimizer

__all__ = ["Optimizer", "make_optimizer"]
