"""Device mesh helpers.

The reference is single-process single-GPU (SURVEY.md §2.3); multi-device
scaling is new design surface here: row-panel/block
partitioning of S over a ``jax.sharding.Mesh`` with feature-dim (tensor)
sharding as the second axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("rows", "feat"),
              devices=None) -> Mesh:
    """Build a mesh over available devices.

    Default layout: all devices on the 'rows' axis (block/row-panel data
    parallelism), 'feat' size 1.  Pass explicit ``axis_sizes`` for hybrid
    layouts, e.g. (4, 2) = 4-way row sharding x 2-way feature sharding.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(axis_sizes)
    return Mesh(dev_array, axis_names)
