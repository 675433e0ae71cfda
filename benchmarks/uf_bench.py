"""Union-find decoder benchmark: threshold curves + decode throughput.

Prints JSON lines:
  {"bench": "uf_threshold_curve", "curve": {d: {p: word_fail}}, ...}
  {"bench": "uf_decode_throughput", "d": 11, "shots_per_sec": ...}
  {"bench": "uf_spacetime_memory", "d": 5, "rounds": 5, ...}

The decoder is a threaded host kernel (`native/uf_decoder.cc`); syndromes
come from the batched device sampler. The reported shots/s is decoder
throughput (the host side is the bottleneck by design — device syndrome
extraction runs at Gsamples/s, see benchmarks/syndrome_sweep.py).

Run on the CPU backend by default: the metric is host-decoder-bound, and
the per-distance device compiles would dominate wall time. Pass
--accelerator to sample on the default JAX device instead.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--accelerator", action="store_true",
                    help="sample on the default JAX device")
    ap.add_argument("--samples", type=int, default=1 << 15)
    ap.add_argument("--dmax", type=int, default=11)
    args = ap.parse_args()

    import jax

    if not args.accelerator:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from qcss_tpu.codes import families
    from qcss_tpu.decode.uf import (
        UFDecoder,
        graph_from_checks,
        uf_logical_error_rate,
    )

    distances = [d for d in (3, 5, 7, 9, 11) if d <= args.dmax]
    ps = [0.06, 0.08, 0.10, 0.12, 0.14, 0.16]

    curve: dict[int, dict[float, float]] = {}
    t0 = time.perf_counter()
    for d in distances:
        code = families.rotated_surface(d)
        curve[d] = {}
        for p in ps:
            r = uf_logical_error_rate(
                code, p, samples=args.samples, batch=args.samples, seed=d * 100
            )
            curve[d][p] = r["word_fail"]
    elapsed = time.perf_counter() - t0
    # threshold bracket: largest p where the max distance still beats d=3
    dmax = distances[-1]
    below = [p for p in ps if curve[dmax][p] < curve[3][p]]
    print(json.dumps({
        "bench": "uf_threshold_curve",
        "noise": "code-capacity depolarizing",
        "samples_per_point": args.samples,
        "curve": {str(d): {str(p): v for p, v in c.items()} for d, c in curve.items()},
        "crossing_below_p": max(below) if below else None,
        "elapsed_s": round(elapsed, 1),
    }))

    # decode throughput (X sector), native threads
    for d in (7, 11):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        h = code.raw_parity_check_c2
        dec = UFDecoder(graph_from_checks(h, code.z_operator_matrix()))
        rng = np.random.default_rng(0)
        B = 1 << 16
        errs = (rng.random((B, code.n)) < 0.05).astype(np.uint8)
        syn = ((errs.astype(np.int64) @ h.T.astype(np.int64)) & 1).astype(np.uint8)
        dec.decode_batch(syn[:2048], want_corrections=False)  # warm/build
        t0 = time.perf_counter()
        dec.decode_batch(syn, want_corrections=False)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "bench": "uf_decode_throughput", "d": d, "p": 0.05,
            "shots_per_sec": round(B / dt),
            "us_per_shot": round(dt * 1e6 / B, 2),
            "threads": min(os.cpu_count() or 1, 16),
        }))

    # exact MWPM (blossom + APSP, native/mwpm_decoder.cc) vs union-find:
    # accuracy and throughput on the same shots
    from qcss_tpu.decode.mwpm import MWPMDecoder

    for d in (7,):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        h = code.raw_parity_check_c2
        lz = code.z_operator_matrix()
        g = graph_from_checks(h, lz)
        uf = UFDecoder(g)
        mw = MWPMDecoder(g)
        rng = np.random.default_rng(0)
        B = 1 << 16
        p = 0.06
        errs = (rng.random((B, code.n)) < p).astype(np.uint8)
        syn = ((errs.astype(np.int64) @ h.T.astype(np.int64)) & 1).astype(np.uint8)
        par = (errs @ lz[0]) % 2
        mw.decode_batch(syn[:2048], want_corrections=False)  # warm/build
        t0 = time.perf_counter()
        _, om = mw.decode_batch(syn, want_corrections=False)
        dt_mw = time.perf_counter() - t0
        _, ou = uf.decode_batch(syn, want_corrections=False)
        print(json.dumps({
            "bench": "mwpm_vs_uf", "d": d, "p": p,
            "mwpm_shots_per_sec": round(B / dt_mw),
            "mwpm_native": mw._native is not None,
            "mwpm_logical_fail": float(np.mean((om & 1) != par)),
            "uf_logical_fail": float(np.mean((ou & 1) != par)),
        }))

    # correlated two-pass decoding: Z-sector conditioned on X corrections
    from qcss_tpu.decode.correlated import correlated_logical_error_rate

    for d in (7,):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        r = correlated_logical_error_rate(
            code, 0.08, samples=args.samples, batch=args.samples, seed=7)
        print(json.dumps({
            "bench": "correlated_vs_independent", "d": d, "p": 0.08,
            "z_fail_independent": r["z_fail"],
            "z_fail_correlated": r["z_fail_corr"],
            "word_fail_independent": r["word_fail"],
            "word_fail_correlated": r["word_fail_corr"],
            "samples": r["samples"],
        }))

    # phenomenological multi-round threshold (p = q, rounds = d): the
    # standard 'threshold with measurement errors' benchmark
    from qcss_tpu.decode.uf import uf_phenomenological_error_rate

    ph_curve: dict[int, dict[float, float]] = {}
    ph_ps = [0.01, 0.015, 0.02, 0.025, 0.03, 0.04]
    t0 = time.perf_counter()
    for d in distances:
        if d > 9:
            continue
        code = families.rotated_surface(d)
        ph_curve[d] = {}
        for p in ph_ps:
            r = uf_phenomenological_error_rate(
                code, p, rounds=d, samples=args.samples, batch=args.samples,
                seed=d * 31 + 7,
            )
            ph_curve[d][p] = r["logical_fail"]
    below = [p for p in ph_ps
             if ph_curve[max(ph_curve)][p] < ph_curve[3][p]]
    print(json.dumps({
        "bench": "uf_phenomenological_threshold_curve",
        "noise": "p data X per round, q=p measurement flips, rounds=d",
        "samples_per_point": args.samples,
        "curve": {str(d): {str(p): v for p, v in c.items()}
                  for d, c in ph_curve.items()},
        "crossing_below_p": max(below) if below else None,
        "elapsed_s": round(time.perf_counter() - t0, 1),
    }))

    # streaming (sliding-window) decode of a 1000-round memory: O(window)
    # state regardless of horizon — the real-time decoding pattern
    from qcss_tpu.decode.streaming import (
        StreamingDecoder,
        sample_phenomenological_stream,
    )
    from qcss_tpu.decode.uf import _pack_parity

    for d in (3, 5, 7):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        h = code.raw_parity_check_c2
        lz = code.z_operator_matrix()
        R, B, p = 1000, 512, 0.005
        dets, par = sample_phenomenological_stream(
            jax.random.key(d), p, p, B, R, h, lz)
        dets = np.asarray(dets)
        par = _pack_parity(np.asarray(par))
        sd = StreamingDecoder(h, lz, window=4 * d, commit=2 * d)
        t0 = time.perf_counter()
        obs = sd.decode_stream(dets)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "bench": "streaming_memory", "d": d, "rounds": R, "p": p,
            "window": 4 * d, "commit": 2 * d,
            "logical_fail": float(np.mean(obs != par)),
            "round_shots_per_sec": round(B * R / dt),
        }))

    # spacetime memory experiment, surface d=5
    from qcss_tpu.experiments.memory import z_memory_experiment
    from qcss_tpu.sim.noise import NoiseModel

    code = families.rotated_surface(5)
    noise = NoiseModel(p_gate2=1e-3, p_meas=5e-3)
    t0 = time.perf_counter()
    r = z_memory_experiment(code, rounds=5, noise=noise, batch=1 << 12,
                            decoder="uf")
    dt = time.perf_counter() - t0
    print(json.dumps({
        "bench": "uf_spacetime_memory", "d": 5, "rounds": 5,
        "p_gate2": 1e-3, "p_meas": 5e-3,
        "logical_fail": r["logical_fail"],
        "shots_per_sec": round((1 << 12) / dt),
    }))


if __name__ == "__main__":
    main()
