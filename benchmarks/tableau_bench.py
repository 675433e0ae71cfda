"""Stabilizer-tableau engine throughput: packed (uint32 words) vs unpacked
(byte-per-bit) at surface-code scale.

Measures batched measurement throughput (the dominant cost of FT protocols:
every EC round measures whole ancilla blocks) for growing physical qubit
counts. Prints one JSON line per (n, engine).

Usage: python benchmarks/tableau_bench.py [--batch 256] [--qubits 49 121 363]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import numpy as np

from qcss_tpu.circuits.ir import Circuit
from qcss_tpu.sim import tableau as tb
from qcss_tpu.sim import tableau_packed as tp


def ladder_circuit(n):
    """H layer + CNOT ladder: entangles everything (worst case for
    measurement, every row dense)."""
    circ = Circuit()
    for q in range(n):
        circ.h(q)
    for q in range(n - 1):
        circ.cnot(q, q + 1)
    return circ


def bench_engine(module, state, n, key, n_measure=32):
    qubits = np.arange(n_measure) * (n // n_measure)

    @jax.jit
    def run(state, key):
        return module.measure_many(state, qubits, key)

    _, outs = run(state, jax.random.fold_in(key, 100))
    jax.block_until_ready(outs)
    reps = 3
    t0 = time.perf_counter()
    acc = 0
    for i in range(reps):
        st2, outs = run(state, jax.random.fold_in(key, i))
        acc += int(outs.sum())
    dt = time.perf_counter() - t0
    return (dt / reps) / n_measure, acc  # seconds per single-qubit measurement


def main():
    ap = argparse.ArgumentParser()
    # Batch 4096 by default: at small batches the measurement loop is
    # op-latency bound and under-reports the engine.
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--qubits", type=int, nargs="+", default=[49, 121, 363])
    args = ap.parse_args()

    for n in args.qubits:
        circ = ladder_circuit(n)
        key = jax.random.key(0)
        u = tb.run_circuit(tb.zero_state(args.batch, n), circ)
        p = tp.run_circuit(tp.zero_state(args.batch, n), circ)

        engines = [("unpacked", tb, u), ("packed", tp, p)]
        for name, module, state in engines:
            secs, _ = bench_engine(module, state, n, key)
            print(json.dumps({
                "metric": "tableau_measure_throughput",
                "engine": name,
                "n_qubits": n,
                "batch": args.batch,
                "value": round(args.batch / secs),
                "unit": "measurements*samples/sec/chip",
            }))


if __name__ == "__main__":
    main()
