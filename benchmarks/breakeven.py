"""Raw-vs-encoded break-even sweep (pseudo-threshold).

For each physical rate p, runs the unencoded X-then-measure program and the
Steane-FT-encoded one under the same uniform circuit-level noise
(p_gate1 = p_gate2 = p_meas = p_reset = p) and reports both logical error
rates. The pseudo-threshold p* is the largest swept p with encoded < raw.

The reference never demonstrates break-even — its own harness measures the
encoded pipeline WORSE than raw and attributes part of that to the shared
-ancilla compromise (reference: ftqc.py:153-160, test/test_fidelity.py).
Two framework changes make the crossing measurable here: the
verification-ordering fix in ftqc/schedule.py::_encode_ft (the reference's
detect-X-then-Z order leaks a first-order weight-2 error path), and enough
throughput to resolve sub-1e-4 rates.

Prints one JSON line per point; shots are chunked to bound device memory.
"""

import argparse
import json
import math
import sys
import time

import jax

sys.path.insert(0, ".")

from benchmarks.fidelity import raw_x_program_error_rate  # noqa: E402
from qcss_tpu.circuits import Program  # noqa: E402
from qcss_tpu.codes import families  # noqa: E402
from qcss_tpu.ftqc import rewrite_program  # noqa: E402
from qcss_tpu.sim.noise import NoiseModel  # noqa: E402


def wilson(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion (95% default)."""
    if n == 0:
        return (0.0, 1.0)
    ph = k / n
    den = 1 + z * z / n
    mid = (ph + z * z / (2 * n)) / den
    half = z * math.sqrt(ph * (1 - ph) / n + z * z / (4 * n * n)) / den
    return (max(mid - half, 0.0), min(mid + half, 1.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ps", type=float, nargs="+",
                    default=[1e-3, 3e-4, 1e-4, 3e-5])
    ap.add_argument("--min-shots", type=int, default=1 << 17)
    ap.add_argument("--chunk", type=int, default=1 << 16)
    ap.add_argument("--tableau", default="packed")
    ap.add_argument("--ancillas", default="shared")
    ap.add_argument("--ec-extractions", type=int, default=1,
                    help="2 = Shor-style repeated extraction per EC sector")
    ap.add_argument("--idle-frac", type=float, default=0.0,
                    help="p_idle = idle_frac * p (0 = no idle locations)")
    ap.add_argument("--ec-schedule", default="serial",
                    choices=["serial", "parallel"])
    ap.add_argument("--code", default="steane",
                    choices=["steane", "golay", "color5"],
                    help="encoded code: steane [[7,1,3]], golay [[23,1,7]] "
                    "(transversal-S distance 7), color5 [[19,1,5]]")
    args = ap.parse_args()

    code = {
        "steane": families.steane,
        "golay": families.golay,
        "color5": lambda: families.triangular_color(5),
    }[args.code]()
    results = []
    for p in args.ps:
        # enough shots to expect >= ~40 raw failures (raw rate ~ 1.7p)
        shots = max(args.min_shots, int(40 / (1.7 * p)))
        shots = ((shots + args.chunk - 1) // args.chunk) * args.chunk
        model = NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p,
                           p_idle=args.idle_frac * p)
        prog = Program()
        ro = prog.declare("ro", 1)
        prog.x(0).measure(0, ro[0])
        enc = rewrite_program(prog, code, noise=model, tableau=args.tableau,
                              ancillas=args.ancillas,
                              ec_extractions=args.ec_extractions,
                              ec_schedule=args.ec_schedule)
        # warm at the CHUNK size (batch is a static arg: a different warmup
        # size would leave the real compile inside the timed loop)
        enc.run(args.chunk, key=jax.random.key(99))
        enc.run(args.chunk, key=jax.random.key(98))
        fails = prep_fails = 0
        t0 = time.perf_counter()
        for i in range(shots // args.chunk):
            res = enc.run(args.chunk, key=jax.random.key(1000 + i))
            fails += int((1 - res["ro"][:, 0]).sum())
            prep_fails += int(res["__prep_fail__"].sum())
        dt = time.perf_counter() - t0
        raw = raw_x_program_error_rate(shots, model, jax.random.key(2))
        raw_k = int(round(raw * shots))
        row = {
            "bench": "breakeven",
            "code": args.code,
            "idle_frac": args.idle_frac,
            "p": p,
            "shots": shots,
            "raw_rate": raw,
            "raw_ci": wilson(raw_k, shots),
            "enc_fails": fails,
            "enc_rate": fails / shots,
            "enc_ci": wilson(fails, shots),
            "prep_fail_frac": prep_fails / shots,
            "enc_shots_per_sec": round(shots / dt),
            "encoded_wins": fails / shots < raw,
            # CI-resolved verdicts: encoded wins/loses beyond statistics
            "encoded_wins_ci": wilson(fails, shots)[1] < wilson(raw_k, shots)[0],
            "encoded_loses_ci": wilson(fails, shots)[0] > wilson(raw_k, shots)[1],
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    wins = [r["p"] for r in results if r["encoded_wins"]]
    # resolve the crossing: the bracketing (largest CI-certain win,
    # smallest CI-certain loss) plus a log-log interpolation of the
    # encoded/raw ratio through 1
    ci_wins = sorted(r["p"] for r in results if r["encoded_wins_ci"])
    ci_loses = sorted(r["p"] for r in results if r["encoded_loses_ci"])
    p_star = None
    lo = max(ci_wins) if ci_wins else None
    hi = min(ci_loses) if ci_loses else None
    if lo is not None and hi is not None and lo < hi:
        pts = sorted((r["p"], r["enc_rate"] / max(r["raw_rate"], 1e-12))
                     for r in results
                     if lo <= r["p"] <= hi and r["enc_rate"] > 0)
        for (p0, r0), (p1, r1) in zip(pts, pts[1:]):
            if r0 < 1 <= r1:
                f = (0 - math.log(r0)) / (math.log(r1) - math.log(r0))
                p_star = math.exp(
                    math.log(p0) + f * (math.log(p1) - math.log(p0)))
                break
    print(json.dumps({
        "bench": "breakeven_summary",
        "pseudo_threshold_lower_bound": max(wins) if wins else None,
        "p_star_ci_bracket": [lo, hi],
        "p_star_interpolated": p_star,
        "ancillas": args.ancillas,
        "ec_extractions": args.ec_extractions,
    }), flush=True)


if __name__ == "__main__":
    main()
