"""Checkpoint / resume for model training state (orbax-backed).

Beyond-reference auxiliary subsystem (the CUDA reference has no
persistence; SURVEY.md §5): saves and restores arbitrary JAX pytrees —
model params, optimizer state, step counters — so long model fits
survive process restarts and lost machines.  Works for sharded arrays
too: orbax records shardings and restores onto the current mesh.

Usage::

    from bsmr_sddmm.utils.checkpoint import Checkpointer
    ck = Checkpointer("/path/run1", keep=3)
    ck.save(step, {"params": params, "opt": opt_state})
    state = ck.restore()            # latest, or None if empty
    state = ck.restore(step=500)    # specific step
"""

from __future__ import annotations

import os
from typing import Any, Optional


class Checkpointer:
    """Thin orbax CheckpointManager wrapper with a pytree-in/out API."""

    def __init__(self, directory: str, keep: int = 3):
        import orbax.checkpoint as ocp
        self._ocp = ocp
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._mgr = ocp.CheckpointManager(
            self._dir,
            options=ocp.CheckpointManagerOptions(max_to_keep=keep,
                                                 create=True))

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Persist ``state`` (any pytree of arrays/scalars) at ``step``."""
        self._mgr.save(int(step),
                       args=self._ocp.args.StandardSave(state))
        if wait:
            self._mgr.wait_until_finished()

    def restore(self, step: Optional[int] = None,
                like: Any = None) -> Any:
        """Latest (or given-step) state; None if nothing saved.

        ``like``: optional abstract/concrete pytree of the expected
        structure — required to restore custom containers (NamedTuples)
        and sharded arrays onto the current mesh."""
        s = int(step) if step is not None else self._mgr.latest_step()
        if s is None:
            return None
        if like is not None:
            args = self._ocp.args.StandardRestore(like)
            return self._mgr.restore(s, args=args)
        return self._mgr.restore(s)

    @property
    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def all_steps(self):
        return list(self._mgr.all_steps())

    def close(self):
        self._mgr.close()
