"""Parallel-window vs forward-streaming decode benchmark.

Records the recorded-stream decode wall time of
`ParallelWindowDecoder.decode_stream` (O(1) batched device calls) vs
`DeviceStreamingDecoder.decode_stream` (R/C dependent calls) on
identical phenomenological streams, plus failure rates of both against
the sampled logical parities. Prints JSON lines:

  {"bench": "parallel_window", "d": ..., "rounds": ..., "batch": ...,
   "pw_shots_per_sec": ..., "fw_shots_per_sec": ..., "speedup": ...,
   "pw_fail": ..., "fw_fail": ...}

Timing protocol: two warm-up calls, then each rep ends in a host read.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=96)
    ap.add_argument("--dmax", type=int, default=7)
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from qcss_tpu.codes import families
    from qcss_tpu.decode.device_streaming import DeviceStreamingDecoder
    from qcss_tpu.decode.parallel_window import ParallelWindowDecoder
    from qcss_tpu.decode.streaming import sample_phenomenological_stream

    for d in (5, 7, 11):
        if d > args.dmax:
            break
        code = families.rotated_surface(d)
        h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
        dets, par = sample_phenomenological_stream(
            jax.random.key(d), args.p, args.p, args.batch, args.rounds,
            jnp.asarray(h, jnp.uint8), jnp.asarray(lz, jnp.uint8))
        dets = jnp.asarray(np.asarray(dets), jnp.uint8)
        par = np.asarray(par)[:, 0]

        pw = ParallelWindowDecoder(h, lz, core=d, buf=int(1.5 * d))
        fw = DeviceStreamingDecoder(h, lz, window=2 * d, commit=d)

        def run(dec):
            obs = dec.decode_stream(dets)
            return np.asarray(obs).astype(np.uint32)

        out = {"bench": "parallel_window", "d": d, "rounds": args.rounds,
               "batch": args.batch, "p": args.p}
        for name, dec in (("pw", pw), ("fw", fw)):
            run(dec)
            run(dec)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                obs = run(dec)
                _ = int(obs[0])  # host fence
            dt = (time.perf_counter() - t0) / args.reps
            out[f"{name}_shots_per_sec"] = round(args.batch / dt, 1)
            out[f"{name}_fail"] = float(np.mean((obs & 1) != par))
        out["speedup"] = round(
            out["pw_shots_per_sec"] / out["fw_shots_per_sec"], 2)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
