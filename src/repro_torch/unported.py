"""The error every option of `repro` that the port does not run yet raises.

Such options are never ignored silently: each raises `NotImplementedError`
naming the ``ROADMAP.md`` item (Queue 1) that will port it.
"""
from __future__ import annotations

__all__ = ["ROADMAP_ITEMS", "unported"]

ROADMAP_ITEMS = {
    "7d": "optimizers (optim/), api.train_step and duck-typed tasks",
}


def unported(what: str, item: int | str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet "
        f"(ROADMAP.md Queue 1 item {item}: {ROADMAP_ITEMS[item]})"
    )
