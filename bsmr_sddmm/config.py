"""Global constants of the BSMR-style pipeline.

Reference counterparts: include/BSMR.hpp:8-10 (ROW_PANEL_SIZE=16,
BLOCK_COL_SIZE=16, BLOCK_SIZE=256) and include/TensorCoreConfig.cuh:10-12
(UIN/NULL_VALUE).  The reference's *logical* 16x16 block granularity is
kept (so the alpha/delta thresholds mean the same thing), and the packed
format groups blocks into wider physical tiles:

- a dense tile is one 16-row panel by ``DENSE_GROUP_BLOCKS`` 16-column
  blocks, i.e. (16, 128): 128 lanes is the packed format's unit of
  column gathering and output layout (reorder/pack.py),
- sentinels are ``-1`` / ``N`` (int32) rather than ``uint32`` 0xFFFFFFFF —
  every index array of the packed format is int32.
"""

# Logical clustering granularity (same semantics as the reference).
ROW_PANEL_SIZE = 16          # rows per panel
BLOCK_COL_SIZE = 16          # columns per dense block
BLOCK_SIZE = ROW_PANEL_SIZE * BLOCK_COL_SIZE  # cells per dense block (256)

# Physical packing: how many 16-col dense blocks form one (16, 128) tile
# of the packed format.
DENSE_GROUP_BLOCKS = 8       # 8 * 16 = 128 lanes per tile

# Sentinel for "no value" in packed index arrays (int32).
NULL_INDEX = -1

# Default reordering thresholds (reference include/Options.hpp:38-41).
DEFAULT_ALPHA = 0.3
DEFAULT_DELTA = 0.3
DEFAULT_K = 32
DEFAULT_NUM_ITERATIONS = 10

# Numerical tolerance contract (reference include/checkData.hpp:14-29).
ABS_TOL = 1e-5
REL_TOL = 1e-3

# Settings are read from BSMR_SDDMM_* environment variables.  Under the
# package's earlier name they were SDDMM_<name>_*; such a variable would
# now be ignored without a word, so its presence is an error.
ENV_PREFIX = "BSMR_SDDMM_"
_STALE_ENV_PREFIX = "SDDMM_"


def check_environment(environ=None) -> None:
    """Raise if a setting still uses the package's earlier variable
    names (checked once, when the package is imported)."""
    import os
    environ = os.environ if environ is None else environ
    stale = sorted(k for k in environ if k.startswith(_STALE_ENV_PREFIX))
    if stale:
        hints = ", ".join(
            f"{k} -> {ENV_PREFIX}{k.split('_', 2)[-1]}" for k in stale)
        raise RuntimeError(
            f"environment settings under the package's earlier name are "
            f"no longer read; rename them: {hints}")
