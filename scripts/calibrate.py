#!/usr/bin/env python3
"""Re-measure the autotuner's device constants on the current device and
write them as JSON for ``autotune.load_calibration``.

The cost model in bsmr_sddmm/reorder/autotune.py ships constants measured
with this script on one NVIDIA H100 (the card and its power limit are in
the comments there).  On different hardware, re-run:

    python scripts/calibrate.py -o results/calibration.json
    BSMR_SDDMM_CALIBRATION=results/calibration.json python bench.py ...

Probes (loop-differenced, hoist-proof; utils/timing.measure_loop_ms):
- ``stream_gbps``: fused read-reduce bandwidth of a large fp32 array.
- ``row_rate_8mb``: gather rows/s by row width at an ~8 MB source.
- ``src_factor``: source-footprint scaling of the 512 B-row gather rate.
- ``dot_g16_ms``: batched tile-dot rates (16-row groups/s) by
  (compute_dtype, tile height).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output", default="results/calibration.json")
    p.add_argument("--quick", action="store_true",
                   help="tiny sizes (mechanics test only — numbers are "
                   "not meaningful)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (mechanics test)")
    p.add_argument("--iterations", type=int, default=None)
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bsmr_sddmm.ops.hybrid import _PRECISION
    from bsmr_sddmm.utils.timing import measure_loop_ms

    rng = np.random.default_rng(0)
    scale = 64 if args.quick else 1
    iters = args.iterations or (20 if args.quick else 200)
    from bsmr_sddmm.utils.device import device_record
    out = {"device": device_record()}

    # -- stream bandwidth ----------------------------------------------
    n_el = (512 * 1024 * 1024 // 4) // scale
    big = jnp.asarray(rng.random(n_el, dtype=np.float32))

    def body_stream(c, x):
        return jnp.sum(jnp.where(c > jnp.float32(-1e30), x, 0))

    ms = measure_loop_ms(body_stream, (big,),
                         iterations=max(iters // 10, 5), repeats=4)
    out["stream_gbps"] = round(n_el * 4 / (ms * 1e6), 1)

    # -- gather row rate by descriptor width at ~8 MB source -----------
    src_bytes = 8 * 1024 * 1024 // scale
    n_idx = 2_000_000 // scale
    row_rate = {}
    for rb in (128, 256, 512, 1024, 2048):
        cols = rb // 4
        rows = max(src_bytes // rb, 16)
        src = jnp.asarray(rng.random((rows, cols), dtype=np.float32))
        idx = jnp.asarray(rng.integers(0, rows, n_idx), dtype=jnp.int32)

        def body_take(c, src, idx):
            i2 = jnp.where(c > jnp.float32(-1e30), idx, 0)
            return jnp.take(src, i2, axis=0)

        ms = measure_loop_ms(body_take, (src, idx),
                             iterations=max(iters // 10, 5), repeats=4)
        row_rate[str(rb)] = round(n_idx / ms / 1e3, 1)  # M rows/s
    out["row_rate_8mb"] = row_rate

    # -- source-footprint factors at 512 B rows ------------------------
    base = row_rate["512"]
    factors = {}
    for mb in (2, 4, 16, 32):
        rows = max(mb * 1024 * 1024 // 512 // scale, 16)
        src = jnp.asarray(rng.random((rows, 128), dtype=np.float32))
        idx = jnp.asarray(rng.integers(0, rows, n_idx), dtype=jnp.int32)

        def body_take(c, src, idx):
            i2 = jnp.where(c > jnp.float32(-1e30), idx, 0)
            return jnp.take(src, i2, axis=0)

        ms = measure_loop_ms(body_take, (src, idx),
                             iterations=max(iters // 10, 5), repeats=4)
        factors[str(mb)] = round((n_idx / ms / 1e3) / max(base, 1e-9), 3)
    out["src_factor"] = factors

    # -- batched tile-dot rates ----------------------------------------
    dn = (((2,), (2,)), ((0,), (0,)))
    dot = {}
    for dtype_name in ("tf32", "bfloat16", "float32"):
        prec = _PRECISION[dtype_name]
        dt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
        for m in (16, 32, 64, 128):
            nb = max((2048 // (m // 16)) // scale, 8)
            a = jnp.asarray(rng.random((nb, m, 128),
                                       dtype=np.float32)).astype(dt)
            b = jnp.asarray(rng.random((nb, 128, 128),
                                       dtype=np.float32)).astype(dt)

            def body_dot(c, a, b):
                a2 = jnp.where(c > jnp.float32(-1e30), a, 0)
                return jax.lax.dot_general(
                    a2, b, dimension_numbers=dn,
                    preferred_element_type=jnp.float32, precision=prec)

            ms = measure_loop_ms(body_dot, (a, b), iterations=iters,
                                 repeats=5)
            dot[f"{dtype_name},{m}"] = round(nb * (m // 16) / ms / 1e3,
                                             1)  # M g16/s
    out["dot_g16_ms"] = dot

    dest = Path(args.output)
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
