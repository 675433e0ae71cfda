"""Fidelity benchmark: raw vs FT-encoded program under circuit-level noise.

The device-native replacement for the reference's fidelity harness, which runs
100,000 noisy-QVM shots of a raw X-gate program against 20 Steane-encoded
shots and prints counts and wall time without recording anything
(reference: test/test_fidelity.py:38-46). Here both pipelines run batched
on device with an explicit seeded Pauli noise model, and the comparison is
printed as JSON (logical error rates + throughput).

Usage: python benchmarks/fidelity.py [--p 0.001] [--shots 1024]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import numpy as np

from qcss_tpu.circuits import Program
from qcss_tpu.codes import families
from qcss_tpu.ftqc import rewrite_program
from qcss_tpu.sim import noise as noise_mod
from qcss_tpu.sim import tableau as tb


def raw_x_program_error_rate(shots: int, model: noise_mod.NoiseModel, key) -> float:
    """Unencoded single-qubit X-then-measure under the same noise model."""
    t = tb.zero_state(shots, 1)
    k1, k2, k3 = jax.random.split(key, 3)
    t = noise_mod.noisy_gate(t, "X", (0,), model, k1)
    t, outcome = tb.measure_z(t, 0, k2)
    if model.p_meas:
        outcome = noise_mod.flip_bits(outcome, model.p_meas, k3)
    return float(1.0 - np.asarray(outcome).mean())


def encoded_x_program_error_rate(shots: int, model: noise_mod.NoiseModel, key,
                                 ec_extractions: int = 1,
                                 tableau: str = "unpacked") -> tuple[float, float]:
    prog = Program()
    ro = prog.declare("ro", 1)
    prog.x(0).measure(0, ro[0])
    enc = rewrite_program(prog, families.steane(), noise=model,
                          ec_extractions=ec_extractions, tableau=tableau)
    enc.run(shots, key=jax.random.key(123))  # compile warm-up
    t0 = time.perf_counter()
    res = enc.run(shots, key=key)
    res["ro"].sum()  # host fence
    elapsed = time.perf_counter() - t0
    return float(1.0 - res["ro"][:, 0].mean()), elapsed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=float, default=0.001, help="physical error rate")
    ap.add_argument("--shots", type=int, default=1024)
    ap.add_argument("--t1", type=float, default=None,
                    help="use a Pauli-twirled T1/T2 decoherence model "
                    "instead of uniform depolarizing (matches the "
                    "reference QVM harness: T1=T2=300e-6, ro=0.99)")
    ap.add_argument("--t2", type=float, default=None)
    ap.add_argument("--ro", type=float, default=0.99, help="readout fidelity")
    ap.add_argument("--ec-extractions", type=int, default=1,
                    help="2 = Shor-style repeated syndrome extraction")
    ap.add_argument("--tableau", default="unpacked")
    args = ap.parse_args()

    if args.t1 is not None:
        model = noise_mod.NoiseModel.from_decoherence(
            t1=args.t1, t2=args.t2 if args.t2 is not None else args.t1,
            ro_fidelity=args.ro,
        )
    else:
        model = noise_mod.NoiseModel(
            p_gate1=args.p, p_gate2=args.p, p_meas=args.p, p_reset=args.p
        )
    key = jax.random.key(0)
    k_raw, k_enc = jax.random.split(key)

    raw_rate = raw_x_program_error_rate(args.shots, model, k_raw)
    enc_rate, enc_time = encoded_x_program_error_rate(
        args.shots, model, k_enc, args.ec_extractions, args.tableau)

    print(json.dumps({
        "p_physical": args.p if args.t1 is None else None,
        "noise": "uniform-depolarizing" if args.t1 is None else {
            "t1": args.t1, "t2": args.t2 or args.t1, "ro_fidelity": args.ro,
            "pauli1": model.pauli1, "pauli2": model.pauli2,
        },
        "shots": args.shots,
        "ec_extractions": args.ec_extractions,
        "raw_logical_error_rate": raw_rate,
        "encoded_logical_error_rate": enc_rate,
        "encoded_shots_per_sec": round(args.shots / enc_time, 1),
    }))


if __name__ == "__main__":
    main()
