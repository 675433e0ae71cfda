"""BP(+OSD) qLDPC decoder benchmark.

Measures the device belief-propagation decoder (`decode.bp`) on the
bivariate-bicycle memories it exists for: code-capacity throughput and
accuracy per code, and the phenomenological spacetime Tanner decode
(R = d rounds with measurement noise). The reference has no qLDPC path
at all (its decoder is the emitted syndrome-table scan, reference:
css_code.py:649-685, exponential in checks and k=1-only), so these rows
are beyond-parity capability; the baseline of note is the host OSD-0
fallback fraction — the device handles the bulk of the batch.

Prints JSON lines:
  {"bench": "bp_code_capacity", "code": .., "p": .., "shots_per_sec": ..,
   "word_fail": .., "bp_converged": ..}
  {"bench": "bp_spacetime", "code": .., "rounds": .., ...}

Timing: two warm-up calls, then each rep ends in a host read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.codes import families
from qcss_tpu.decode.bp import BPDecoder, spacetime_tanner
from qcss_tpu.ops import gf2_jax

CODES = {
    "bb72": families.bb72,
    "bb90": families.bb90,
    "bb144": families.bb144,
    "bb288": families.bb288,
}


def _time_decode(dec: BPDecoder, syn: np.ndarray, reps: int) -> float:
    """Median decode seconds over `reps`, device part host-fenced."""
    syn_j = jnp.asarray(syn, jnp.uint8)
    for _ in range(2):  # warm-up
        e, conv, _ = dec._run(syn_j)
        int(jnp.sum(e.astype(jnp.int32))), int(jnp.sum(conv))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        e, conv, _ = dec._run(syn_j)
        int(jnp.sum(e.astype(jnp.int32))) + int(jnp.sum(conv))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_code_capacity(name: str, p: float, batch: int, iters: int,
                        reps: int, seed: int) -> dict:
    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    lz = code.z_operator_matrix()
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, code.n)) < 2.0 * p / 3.0).astype(np.uint8)
    syn = (errs @ h2.T) & 1
    dec = BPDecoder(h2, 2.0 * p / 3.0, logicals=lz, iters=iters)
    sec = _time_decode(dec, syn, reps)
    flips, conv = dec.decode_obs(syn)
    true_flip = (errs.astype(np.int64) @ lz.T.astype(np.int64)) & 1
    fail = (flips ^ true_flip).any(axis=1)
    return {
        "bench": "bp_code_capacity", "code": name,
        "n": code.n, "k": code.k, "p": p, "batch": batch, "iters": iters,
        "shots_per_sec": round(batch / sec, 1),
        "x_fail": float(fail.mean()),
        "bp_converged": float(np.asarray(conv).mean()),
    }


def bench_spacetime(name: str, rounds: int, p: float, q: float, batch: int,
                    iters: int, reps: int, seed: int) -> dict:
    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    tan, priors, obs, _ = spacetime_tanner(
        h2, rounds, p, q, logicals=code.z_operator_matrix())
    dec = BPDecoder(tan, priors, logicals=obs, iters=iters)
    rng = np.random.default_rng(seed)
    ev = (rng.random((batch, tan.shape[1])) < priors[None, :]).astype(np.uint8)
    syn = (ev @ tan.T) & 1
    sec = _time_decode(dec, syn, reps)
    flips, conv = dec.decode_obs(syn)
    true_flip = (ev.astype(np.int64) @ obs.T.astype(np.int64)) & 1
    fail = (flips ^ true_flip).any(axis=1)
    return {
        "bench": "bp_spacetime", "code": name, "rounds": rounds,
        "p": p, "q": q, "batch": batch, "iters": iters,
        "detectors": int(tan.shape[0]), "variables": int(tan.shape[1]),
        "shots_per_sec": round(batch / sec, 1),
        "word_fail": float(fail.mean()),
        "bp_converged": float(np.asarray(conv).mean()),
    }


def bench_stream(name: str, rounds: int, p: float, q: float, batch: int,
                 window: int, commit: int, iters: int, seed: int) -> dict:
    """Sliding-window BP streaming: end-to-end (sample + decode) rate."""
    from qcss_tpu.decode.bp_streaming import BPStreamingDecoder
    from qcss_tpu.decode.streaming import sample_phenomenological_stream

    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    lz = code.z_operator_matrix()
    dec = BPStreamingDecoder(h2, lz, p, q, window=window, commit=commit,
                             iters=iters)
    dets, par = sample_phenomenological_stream(
        jax.random.key(seed), p, q, batch, rounds, h2, lz)
    dets = np.asarray(dets, np.uint8)
    dec.decode_stream(dets[: max(8, batch // 8)])  # warm the window kernels
    t0 = time.perf_counter()
    flips, conv = dec.decode_stream(dets)
    sec = time.perf_counter() - t0
    fail = (flips ^ np.asarray(par, np.uint8)).any(axis=1)
    return {
        "bench": "bp_stream", "code": name, "rounds": rounds,
        "p": p, "q": q, "batch": batch, "window": window, "commit": commit,
        "round_shots_per_sec": round(batch * rounds / sec, 1),
        "x_fail": float(fail.mean()),
        "all_windows_converged": float(np.asarray(conv).mean()),
    }


def bench_circuit_stream(name: str, rounds: int, p: float, batch: int,
                         window: int, commit: int, iters: int,
                         seed: int) -> dict:
    """Circuit-level sliding-window BP: end-to-end (two-sector extraction
    sampling + windowed decode) rate under uniform circuit noise p."""
    from qcss_tpu.experiments.memory_qldpc import qldpc_stream_memory_rate
    from qcss_tpu.sim.noise import NoiseModel

    code = CODES[name]()
    noise = NoiseModel(p_gate2=p, p_gate1=p, p_meas=p, p_reset=p)
    out = qldpc_stream_memory_rate(code, noise, rounds=rounds, batch=batch,
                                   window=window, commit=commit,
                                   iters=iters, seed=seed)
    out["bench"] = "bp_circuit_stream"
    out["code"] = name
    out["p"] = p
    return out


def bench_circuit(name: str, rounds: int, p: float, batch: int,
                  iters: int, seed: int, sectors: str,
                  bp_kwargs: dict | None = None) -> dict:
    """Whole-history circuit-level memory: two-sector extraction-circuit
    sampling + exact detector-fault Tanner BP(+OSD). Wall time covers the
    WHOLE call — including the one-time per-(code, R, noise) Tanner graph
    build and XLA compile — so shots_per_sec is a cold-start figure; use
    --circuit-stream for steady-state circuit-level throughput."""
    from qcss_tpu.experiments.memory_qldpc import qldpc_memory_experiment
    from qcss_tpu.sim.noise import NoiseModel

    code = CODES[name]()
    noise = NoiseModel(p_gate2=p, p_gate1=p, p_meas=p, p_reset=p)
    t0 = time.perf_counter()
    out = qldpc_memory_experiment(code, rounds=rounds, noise=noise,
                                  batch=batch, iters=iters, seed=seed,
                                  sectors=sectors, bp_kwargs=bp_kwargs)
    sec = time.perf_counter() - t0
    out.update({
        "bench": "bp_circuit_memory", "code": name, "p": p,
        "wall_sec": round(sec, 1),
        "shots_per_sec": round(batch / sec, 1),
    })
    return out


def bench_gap(name: str, p: float, batch: int, iters: int,
              seed: int, taus=(0.0, 5.0, 10.0, 20.0)) -> dict:
    """Soft-output gap post-selection curve at code capacity."""
    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    lz = code.z_operator_matrix()
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, code.n)) < 2.0 * p / 3.0).astype(np.uint8)
    syn = (errs @ h2.T) & 1
    dec = BPDecoder(h2, 2.0 * p / 3.0, logicals=lz, iters=iters)
    t0 = time.perf_counter()
    flips, _, gap = dec.decode_obs_gap(syn)
    sec = time.perf_counter() - t0
    true_flip = (errs.astype(np.int64) @ lz.T.astype(np.int64)) & 1
    fail = (flips ^ true_flip).any(axis=1)
    curve = []
    for tau in taus:
        keep = gap >= tau
        curve.append({"tau": tau, "keep": float(keep.mean()),
                      "cond_fail": float(fail[keep].mean())
                      if keep.any() else None})
    return {
        "bench": "bp_gap_postselect", "code": name, "p": p, "batch": batch,
        "shots_per_sec": round(batch / sec, 1),
        "word_fail": float(fail.mean()), "curve": curve,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--codes", default="bb72,bb144")
    ap.add_argument("--p", type=float, default=0.003)
    ap.add_argument("--q", type=float, default=0.003)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spacetime", action="store_true",
                    help="also run the R=d phenomenological Tanner decode")
    ap.add_argument("--stream", type=int, default=0, metavar="R",
                    help="also run R-round sliding-window BP streaming")
    ap.add_argument("--gap", action="store_true",
                    help="also run the soft-output gap post-selection curve")
    ap.add_argument("--circuit", type=int, default=0, metavar="R",
                    help="also run the R-round whole-history CIRCUIT-LEVEL "
                    "memory (uniform circuit noise --p)")
    ap.add_argument("--sectors", default="z", choices=["z", "both"])
    ap.add_argument("--circuit-stream", type=int, default=0, metavar="R",
                    help="also run R-round CIRCUIT-LEVEL sliding-window BP "
                    "(two-sector sampling + window decodes, uniform "
                    "circuit noise --p)")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--commit", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=0,
                    help="spacetime rounds (default: the code's distance)")
    ap.add_argument("--gamma", type=float, default=0.0,
                    help="min-sum message damping (memory-BP)")
    ap.add_argument("--restarts", type=int, default=0,
                    help="perturbed re-decodes of the unconverged tail")
    ap.add_argument("--osd-order", type=int, default=0,
                    help="OSD-E combination-sweep order (0 = OSD-0)")
    args = ap.parse_args()
    bp_kwargs = {}
    if args.gamma:
        bp_kwargs["gamma"] = args.gamma
    if args.restarts:
        bp_kwargs["restarts"] = args.restarts
    if args.osd_order:
        bp_kwargs["osd_order"] = args.osd_order
    dists = {"bb72": 6, "bb90": 10, "bb144": 12, "bb288": 18}
    for name in args.codes.split(","):
        print(json.dumps(bench_code_capacity(
            name, args.p, args.batch, args.iters, args.reps, args.seed)),
            flush=True)
        if args.spacetime:
            rounds = args.rounds or dists[name]
            print(json.dumps(bench_spacetime(
                name, rounds, args.p, args.q, args.batch, args.iters,
                args.reps, args.seed)), flush=True)
        if args.stream:
            print(json.dumps(bench_stream(
                name, args.stream, args.p, args.q, args.batch,
                args.window, args.commit, args.iters, args.seed)),
                flush=True)
        if args.gap:
            print(json.dumps(bench_gap(
                name, args.p, args.batch, args.iters, args.seed)),
                flush=True)
        if args.circuit:
            print(json.dumps(bench_circuit(
                name, args.circuit, args.p, args.batch, args.iters,
                args.seed, args.sectors, bp_kwargs=bp_kwargs)), flush=True)
        if args.circuit_stream:
            print(json.dumps(bench_circuit_stream(
                name, args.circuit_stream, args.p, args.batch,
                args.window, args.commit, args.iters, args.seed)),
                flush=True)


if __name__ == "__main__":
    main()
