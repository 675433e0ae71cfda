"""Scaling probe for the FT break-even study: encoded-vs-raw error rate at
several physical rates, to establish the encoded pipeline's scaling
exponent and locate the pseudo-threshold bracket. JSON line per point."""

import argparse
import json
import sys
import time

import jax

sys.path.insert(0, ".")

from benchmarks.fidelity import raw_x_program_error_rate  # noqa: E402
from qcss_tpu.circuits import Program  # noqa: E402
from qcss_tpu.codes import families  # noqa: E402
from qcss_tpu.ftqc import rewrite_program  # noqa: E402
from qcss_tpu.sim import noise as noise_mod  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ps", type=float, nargs="+",
                    default=[3e-3, 1e-3, 3e-4])
    ap.add_argument("--shots", type=int, default=1 << 16)
    ap.add_argument("--tableau", default="packed")
    args = ap.parse_args()

    code = families.steane()
    for p in args.ps:
        model = noise_mod.NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)
        prog = Program()
        ro = prog.declare("ro", 1)
        prog.x(0).measure(0, ro[0])
        enc = rewrite_program(prog, code, noise=model, tableau=args.tableau)
        # warm-up: compiles outside the timed call
        enc.run(256, key=jax.random.key(99))
        enc.run(256, key=jax.random.key(98))
        t0 = time.perf_counter()
        res = enc.run(args.shots, key=jax.random.key(1))
        enc_fails = int((1 - res["ro"][:, 0]).sum())
        dt = time.perf_counter() - t0
        raw = raw_x_program_error_rate(args.shots, model, jax.random.key(2))
        print(json.dumps({
            "p": p,
            "shots": args.shots,
            "raw_rate": raw,
            "enc_fails": enc_fails,
            "enc_rate": enc_fails / args.shots,
            "prep_fail": int(res["__prep_fail__"].sum()),
            "enc_shots_per_sec": round(args.shots / dt),
        }), flush=True)


if __name__ == "__main__":
    main()
