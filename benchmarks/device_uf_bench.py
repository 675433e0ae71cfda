"""Device union-find decoder benchmark.

A memory pipeline with a host decoder is decode-bound. This harness
measures sampling AND union-find decoding fused into one compiled device
program (`decode.device_uf` + `experiments.memory`) against the host
path on the same shots.

Prints JSON lines:
  {"bench": "fused_sample_decode", "d": .., "rounds": .., "graph": ..,
   "shots_per_sec": .., "logical_fail": .., ...}

Each timed rep ends in a host read of its failure count; one warm-up
call compiles before timing.
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

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode.device_uf import make_obs_decoder
from qcss_tpu.decode.spacetime import detector_history
from qcss_tpu.decode.uf import UFDecoder, spacetime_graph
from qcss_tpu.experiments import memory as M
from qcss_tpu.ops import gf2_jax
from qcss_tpu.sim import frame as fr
from qcss_tpu.sim.noise import NoiseModel


def build_pipeline(code, rounds, noise, graph_kind: str,
                   decoder: str = "dense", d_max: int = 48):
    """(graph, sample_j, fused_j, sample_dets_j, decode_fn) for a memory
    experiment: ``fused_j(key, batch, rounds) -> (failures, all
    converged)`` is the one-program sample + decode + count;
    ``sample_dets_j`` returns (detectors, true observable parity) and
    ``decode_fn(detectors) -> (obs, converged)`` is its decoder."""
    raw = code.raw_parity_check_c2
    logicals = code.z_operator_matrix()
    if graph_kind == "dem":
        from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list

        graph = circuit_level_graph(
            raw, extraction_gate_list(code, raw), rounds,
            p_gate2=noise.p_gate2, p_meas=noise.p_meas,
            p_reset=noise.p_reset, logicals=logicals)
    else:
        graph = spacetime_graph(raw, logicals, rounds)
    if decoder == "dense":
        decode_fn = make_obs_decoder(graph)
    elif decoder == "sparse":
        from qcss_tpu.decode.device_sparse import make_sparse_obs_decoder

        decode_fn = make_sparse_obs_decoder(graph, d_max=d_max)
        assert decode_fn is not None, "graph refused the sparse path"
    else:
        from qcss_tpu.decode.device_sparse import make_hybrid_obs_decoder

        decode_fn = make_hybrid_obs_decoder(graph, d_max=d_max)
    ext = tuple(map(jnp.asarray, M.z_extraction_circuit(
        code, checks=raw).to_arrays()))
    comp = fr.maybe_compile(ext, code.n + raw.shape[0])
    raw_j = jnp.asarray(raw, jnp.uint8)
    log_row = jnp.asarray(logicals[0], jnp.int32)

    def sample(key, batch, rounds):
        return M._memory_circuit_frames(
            key, batch, rounds, code, noise, ext, n_anc=raw.shape[0],
            extract_comp=comp)

    def dets_of(syns, word):
        final = gf2_jax.syndromes_dense(word, raw_j)
        return detector_history(syns, final)

    def fused(key, batch, rounds):
        syns, word = sample(key, batch, rounds)
        obs, conv = decode_fn(dets_of(syns, word))
        outcome = (word.astype(jnp.int32) * log_row[None, :]).sum(-1) & 1
        return jnp.sum((outcome ^ (obs & 1)).astype(jnp.int32)), jnp.all(conv)

    sample_j = jax.jit(sample, static_argnames=("batch", "rounds"))
    fused_j = jax.jit(fused, static_argnames=("batch", "rounds"))

    def sample_dets(key, batch, rounds):
        syns, word = sample(key, batch, rounds)
        par = (word.astype(jnp.int32) * log_row[None, :]).sum(-1) & 1
        return dets_of(syns, word), par

    return graph, sample_j, fused_j, jax.jit(
        sample_dets, static_argnames=("batch", "rounds")), decode_fn


def run(d: int, rounds: int, batch: int, reps: int, noise: NoiseModel,
        graph_kind: str, host_compare: bool, decoder: str = "dense"):
    code = rotated_surface(d)
    graph, sample_j, fused_j, sample_dets_j, _ = build_pipeline(
        code, rounds, noise, graph_kind, decoder=decoder)
    keys = jax.random.split(jax.random.key(0), reps + 2)

    for k in keys[:2]:
        int(fused_j(k, batch, rounds)[0])  # compile + warm-up

    t0 = time.time()
    fails = 0
    for k in keys[2:]:
        f, conv = fused_j(k, batch, rounds)
        fails += int(f)  # host fence per rep
        assert bool(conv)
    dt = time.time() - t0
    fused_rate = reps * batch / dt

    # sampling-only rate (fenced via a cheap reduction)
    sample_only = jax.jit(
        lambda k, b, r: sample_j(k, b, r)[1].sum(),
        static_argnames=("b", "r"))
    for k in keys[:2]:
        int(sample_only(k, batch, rounds))
    t0 = time.time()
    for k in keys[2:]:
        int(sample_only(k, batch, rounds))
    dt_s = time.time() - t0
    out = {
        "bench": "fused_sample_decode", "d": d, "rounds": rounds,
        "graph": graph_kind, "decoder": decoder,
        "batch": batch, "reps": reps,
        "detectors": graph.num_nodes, "edges": graph.num_edges,
        "shots_per_sec": round(fused_rate),
        "sample_only_shots_per_sec": round(reps * batch / dt_s),
        "logical_fail": fails / (reps * batch),
        "p_gate2": noise.p_gate2, "p_meas": noise.p_meas,
    }
    print(json.dumps(out))

    if host_compare:
        dets, par = sample_dets_j(keys[2], batch, rounds)
        dets_h = np.asarray(dets)
        par_h = np.asarray(par)
        dec = UFDecoder(graph)
        _, obs0 = dec.decode_batch(dets_h[:128], want_corrections=False)
        t0 = time.time()
        _, obs = dec.decode_batch(dets_h, want_corrections=False)
        dt_h = time.time() - t0
        print(json.dumps({
            "bench": "host_uf_same_shots", "d": d, "rounds": rounds,
            "graph": graph_kind,
            "shots_per_sec": round(batch / dt_h),
            "logical_fail": float(np.mean((obs & 1) != par_h)),
        }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[11])
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--p-gate2", type=float, default=2e-3)
    ap.add_argument("--p-meas", type=float, default=1e-2)
    ap.add_argument("--graph", choices=["dem", "spacetime"], default="dem")
    ap.add_argument("--decoder", choices=["dense", "sparse", "hybrid"],
                    default="dense")
    ap.add_argument("--no-host", action="store_true")
    args = ap.parse_args()
    noise = NoiseModel(p_gate2=args.p_gate2, p_meas=args.p_meas)
    for d in args.d:
        run(d, args.rounds or d, args.batch, args.reps, noise,
            args.graph, not args.no_host, decoder=args.decoder)


if __name__ == "__main__":
    main()
