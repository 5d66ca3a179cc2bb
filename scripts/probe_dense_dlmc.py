"""Probe: is the all-super hybrid path the right kernel for true-DLMC
density (~0.2), or does a direct dense-tiling formulation win?

At d>=0.1 the packing covers the matrix with dense 128x128 super tiles,
so the hybrid kernel is effectively a full dense matmul executed through
per-tile A/B gathers.  Candidates measured (effective GFLOPS =
2*nnz*K/t, same useful-work accounting as everywhere else):

  hybrid   — committed bench config (a=0.3 d=0.05, all-super)
  einsum   — blocked tile-major product einsum('aik,bjk->abij'):
             output lands directly in super-packed (tile-major) layout,
             no gathers at all
  dot      — plain row-major A@B (upper bound; output layout is NOT the
             packed contract, shown for the relayout-cost attribution)
  dot+x    — plain dot followed by a flat gather into packed order
             (contract-honoring alternative to einsum)

Run on the GPU, with nothing else using the card.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=4096)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--density", type=float, default=0.2)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bsmr_sddmm.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from bsmr_sddmm.data import generate
    from bsmr_sddmm.ops.hybrid import HybridSDDMM, _PRECISION
    from bsmr_sddmm.reorder.autotune import from_params
    from bsmr_sddmm.utils.timing import gflops, measure_loop_ms

    csr = generate.random_sparse(args.m, args.n, density=args.density,
                                 seed=46)
    k = args.k
    nnz = csr.nnz
    print(f"m={args.m} n={args.n} d={args.density} nnz={nnz} k={k}",
          flush=True)

    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    prec = _PRECISION["tf32"]

    # --- hybrid (committed config) ---
    t0 = time.perf_counter()
    cfg = from_params(csr, k, alpha=0.3, delta=0.05)
    runner = HybridSDDMM(cfg.packed, compute_dtype="tf32")
    a_pad, bt_pad = runner.prepare_operands(a, b=b)
    ms = runner.measure_kernel_ms(a_pad, bt_pad,
                                  iterations=args.iterations, repeats=4)
    print(f"hybrid: nS={cfg.packed.num_super} res={cfg.packed.nnz_res} "
          f"{ms:.4f} ms  {gflops(nnz, k, ms):.0f} GFLOPS "
          f"(host prep {time.perf_counter() - t0:.1f}s)", flush=True)

    a_d = jnp.asarray(a)
    bt_d = jnp.asarray(b.T.copy())  # (n, K)

    # Timing contract: the (M, N) HBM write is the strategy's dominant
    # byte term; an unguarded sum-reduce (measure_loop_ms's consumer)
    # could fuse into the dot and elide it.  barrier + tiny slice forces
    # the materialization without adding a full re-read (the same
    # methodology as ops/dense.make_looped_fn).
    def _force_write(x):
        return jax.lax.optimization_barrier(x).reshape(-1)[:8]

    # --- einsum tile-major: (mb,128,K) x (nb,128,K) -> (mb,nb,128,128)
    mb, nb = args.m // 128, args.n // 128
    a_blk = a_d.reshape(mb, 128, k)
    bt_blk = bt_d.reshape(nb, 128, k)

    def einsum_body(c, ab, bb):
        ab = ab + c * jnp.float32(1e-38)
        return _force_write(jnp.einsum("aik,bjk->abij", ab, bb,
                                       preferred_element_type=jnp.float32,
                                       precision=prec))

    ms_e = measure_loop_ms(einsum_body, (a_blk, bt_blk),
                           iterations=args.iterations, repeats=4)
    print(f"einsum tile-major: {ms_e:.4f} ms  "
          f"{gflops(nnz, k, ms_e):.0f} GFLOPS", flush=True)

    # --- plain dot (row-major output; layout-contract-free bound) ---
    def dot_body(c, ad, bd):
        ad = ad + c * jnp.float32(1e-38)
        return _force_write(jnp.dot(ad, bd.T,
                                    preferred_element_type=jnp.float32,
                                    precision=prec))

    ms_d = measure_loop_ms(dot_body, (a_d, bt_d),
                           iterations=args.iterations, repeats=4)
    print(f"plain dot: {ms_d:.4f} ms  {gflops(nnz, k, ms_d):.0f} GFLOPS",
          flush=True)

    # --- diagnostic: same dot WITHOUT the write barrier, to quantify
    #     how much of the (M, N) store XLA's dot->reduce fusion elides
    def dot_body_nb(c, ad, bd):
        ad = ad + c * jnp.float32(1e-38)
        return jnp.dot(ad, bd.T, preferred_element_type=jnp.float32,
                       precision=prec)

    ms_nb = measure_loop_ms(dot_body_nb, (a_d, bt_d),
                            iterations=args.iterations, repeats=4)
    print(f"plain dot (no write barrier): {ms_nb:.4f} ms  "
          f"{gflops(nnz, k, ms_nb):.0f} GFLOPS  "
          f"(elision delta {ms_d - ms_nb:+.4f} ms)", flush=True)

    # --- plain dot + flat gather into packed order ---
    pk = cfg.packed
    if pk.packed_rows is not None:
        flat_idx = (pk.packed_rows.astype(np.int64) * args.n
                    + pk.packed_cols.astype(np.int64))
        # packed slots pointing at the sentinel row map to any valid cell
        flat_idx = np.clip(flat_idx, 0, args.m * args.n - 1)
        flat_d = jnp.asarray(flat_idx.astype(np.int32)) \
            if args.m * args.n < 2**31 else jnp.asarray(flat_idx)

        def dotx_body(c, ad, bd, fi):
            ad = ad + c * jnp.float32(1e-38)
            full = jnp.dot(ad, bd.T, preferred_element_type=jnp.float32,
                           precision=prec)
            return jnp.take(full.reshape(-1), fi)

        ms_x = measure_loop_ms(dotx_body, (a_d, bt_d, flat_d),
                               iterations=max(args.iterations // 2, 10),
                               repeats=4)
        print(f"dot+extract: {ms_x:.4f} ms  "
              f"{gflops(nnz, k, ms_x):.0f} GFLOPS", flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
