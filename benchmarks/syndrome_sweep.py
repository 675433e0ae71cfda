"""Surface-code distance sweep: batched syndrome-extraction throughput
(BASELINE config 4).

For rotated surface codes d=3..11, measures samples/sec of X-sector
syndrome extraction over a large Monte-Carlo batch for two kernel forms:

* dense: int8 matmul with int32 accumulation (`gf2_jax.syndromes_dense`)
* packed: uint32 AND + XOR-parity fold (`gf2_jax.syndromes_packed`)

Prints one JSON line per (distance, kernel).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.codes import families
from qcss_tpu.ops import gf2_jax


def bench(fn, e, h, iters=30):
    """Steady-state seconds per application: `iters` data-dependent chained
    applications inside ONE jitted scan, so host dispatch and output
    transfer amortize away and XLA cannot CSE the repeats. `fold(carry, s)`
    mixes the syndrome back into the carry per sample — elementwise only,
    so no cross-sample reduction serializes iterations on latency."""

    def fold(carry, s):  # carry [B, cols], s [B, R]
        cols = carry.shape[-1]
        r = s.shape[-1]
        if r >= cols:
            bump = s[:, :cols]
        else:
            bump = jnp.pad(s, ((0, 0), (0, cols - r)))
        return carry ^ bump.astype(carry.dtype)

    @jax.jit
    def chained(e):
        def body(carry, _):
            return fold(carry, fn(carry, h)), ()

        out, _ = jax.lax.scan(body, e, None, length=iters)
        return out

    jax.block_until_ready(chained(e))
    t0 = time.perf_counter()
    jax.block_until_ready(chained(e))
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--distances", type=int, nargs="+", default=[3, 5, 7, 9, 11])
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    dense = gf2_jax.syndromes_dense
    packed = gf2_jax.syndromes_packed

    for d in args.distances:
        code = families.rotated_surface(d)
        h = code.parity_check_c2
        errors = rng.integers(0, 2, size=(args.batch, code.n), dtype=np.uint8)
        e_dev = jnp.asarray(errors)
        h_dev = jnp.asarray(h)
        ep = gf2_jax.pack_bits(errors)
        hp = gf2_jax.pack_bits(h)

        results = {
            "dense": bench(dense, e_dev, h_dev),
            "packed": bench(packed, ep, hp),
        }
        for kernel, secs in results.items():
            print(json.dumps({
                "metric": "surface_syndrome_extraction",
                "distance": d,
                "n": code.n,
                "checks": int(h.shape[0]),
                "kernel": kernel,
                "batch": args.batch,
                "value": round(args.batch / secs),
                "unit": "samples/sec/chip",
            }))


if __name__ == "__main__":
    main()
