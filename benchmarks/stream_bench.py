"""Device streaming memory end-to-end rate (round 3, VERDICT task 7).

Times `decode.device_streaming.stream_memory_rate` — phenomenological
sampling AND sliding-window union-find decoding interleaved on device
with O(window) state — and prints one JSON line per distance:

  {"bench": "device_stream", "d": .., "rounds": .., "round_shots_per_sec": ..}

Wall time includes the window-step compiles; long horizons amortize them
(the honest serving number), short ones expose them — both are reported
via the wall_s field. stream_memory_rate reads its convergence flag on
the host after the final window, which ends each timed run.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

from qcss_tpu.codes.families import rotated_surface  # noqa: E402
from qcss_tpu.decode import stream_memory_rate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[7])
    ap.add_argument("--rounds", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--q", type=float, default=0.004)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--commit", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    for d in args.d:
        code = rotated_surface(d)
        t0 = time.perf_counter()
        out = stream_memory_rate(
            code.raw_parity_check_c2, code.z_operator_matrix(),
            args.p, args.q, rounds=args.rounds, batch=args.batch,
            window=args.window, commit=args.commit, seed=args.seed)
        wall = time.perf_counter() - t0
        print(json.dumps({
            "bench": "device_stream", "d": d,
            "rounds": args.rounds, "batch": args.batch,
            "p": args.p, "q": args.q,
            "window": args.window, "commit": args.commit,
            "round_shots_per_sec": round(args.rounds * args.batch / wall),
            "wall_s": round(wall, 1),
            "logical_fail": out["logical_fail"],
        }), flush=True)


if __name__ == "__main__":
    main()
