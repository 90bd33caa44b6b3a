"""Pytree checkpointing over tensors and numpy arrays (`repro.ckpt`'s layout)."""
from .checkpoint import available_steps, latest_step, load_metadata, restore, save

__all__ = ["save", "restore", "latest_step", "available_steps", "load_metadata"]
