"""One lock for the port's process-wide counters.

The planner's and the dispatcher's counters, the kernels' ``.launches``,
the runtime guard's counters and ``svd_grad.eigh_reg.widened`` are plain
integers that several threads may tick at once: the superstep of
:mod:`repro_torch.core.spmd` runs one worker thread per shard, and the
serving engine answers from its own thread.  ``x += 1`` is a read, an add
and a write, and the interpreter may switch threads between them, so an
unlocked tick can lose a count.  Every tick of those counters goes through
:func:`tick` or :func:`tick_attr`.
"""
from __future__ import annotations

import threading

LOCK = threading.Lock()


def tick(counters: dict, key: str, n: int = 1) -> None:
    """``counters[key] += n`` under :data:`LOCK` (a missing key counts
    from 0)."""
    with LOCK:
        counters[key] = counters.get(key, 0) + n


def tick_attr(obj, name: str = "launches", n: int = 1) -> None:
    """``obj.<name> += n`` under :data:`LOCK` (a kernel wrapper's launch
    count)."""
    with LOCK:
        setattr(obj, name, getattr(obj, name) + n)
