"""Profile the dense union-find kernel (`decode.device_uf`) on the card.

The dense XLA union-find runs on the main path in two places: the hybrid
decoder's rescue of shots with more than ``d_max`` defects (d=11 R=11
circuit-level memory), and every mid-stream window of the d=11 streaming
decoder. Its fixpoints are nested ``lax.while_loop``s, and an XLA while
loop on a GPU reads its predicate on the host once per iteration, so each
iteration costs a device-to-host copy and a host round trip. This script
traces a few calls of each and reduces the trace to:

* device busy and idle share over the traced calls (busy = union of the
  intervals in which a kernel or copy runs on the device);
* kernels and device-to-host copies per call (one copy per while-loop
  iteration, all loops together);
* the copies per call of each while loop, told apart by the ``hlo_op``
  of the copy, in the order the loops first run. In both kernels that
  order is the outer growth-round loop, then the label-propagation
  fixpoint, then the activity fixpoint (activity reads the labels that
  propagation wrote, so it runs second in every round);
* the mean device-idle gap between consecutive device activities.

Usage: python benchmarks/dense_uf_trace.py [--out DIR] [--reduce-only]
(on a GPU; prints one JSON line per place, traces under DIR). Both
places run at their cells' sizes: d=11, 16384 heavy shots for the
rescue (d=11 rounds), 8192 shots for the mid-window decode.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

#: code distance of both places (the d=11 memory and streaming cells)
D = 11
#: hybrid rescue batch (the fused memory cell) and streaming batch
RESCUE_BATCH = 1 << 14
STREAM_BATCH = 1 << 13
#: traced calls per place
CALLS = 3


def _union(intervals):
    """Merge [start, end) intervals; returns the merged sorted list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path: str, annotation: str) -> dict:
    """Device metrics of every host span named ``annotation`` in the
    ``.xplane.pb`` at ``path``: per span the device activity (events on
    the device planes' stream lines) inside it. Returns totals over the
    spans; device planes are those named ``/device:...``."""
    data = jax.profiler.ProfileData.from_file(path)
    # outermost spans only: a host function of the same name may nest
    # inside an annotation, and a span may sit on more than one line
    spans = []
    for s, t in sorted({(e.start_ns, e.end_ns)
                        for pl in data.planes if pl.name.startswith("/host:")
                        for ln in pl.lines for e in ln.events
                        if e.name == annotation}):
        if not spans or s >= spans[-1][1]:
            spans.append((s, t))
    acts, d2h, names, loops = [], 0, {}, {}
    for pl in data.planes:
        if not pl.name.startswith("/device:"):
            continue
        for ln in pl.lines:
            if not ln.name.startswith("Stream"):
                continue
            for e in ln.events:
                if not any(s <= e.start_ns < t for s, t in spans):
                    continue
                acts.append((e.start_ns, e.end_ns))
                if e.name.lower().replace("dtoh", "d2h").startswith(
                        "memcpyd2h"):
                    d2h += 1
                    op = dict(e.stats).get("hlo_op", "?")
                    first, k = loops.get(op, (e.start_ns, 0))
                    loops[op] = (min(first, e.start_ns), k + 1)
                names[e.name] = names.get(e.name, 0) + 1
    window = float(sum(t - s for s, t in spans))
    busy_iv = _union(acts)
    busy = float(sum(e - s for s, e in busy_iv))
    gaps = [b[0] - a[1] for a, b in zip(busy_iv, busy_iv[1:])]
    n = max(len(spans), 1)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {
        "calls": len(spans),
        "window_ms_per_call": window / n / 1e6,
        "device_busy_share": busy / window if window else None,
        "device_idle_share": 1.0 - busy / window if window else None,
        "device_events_per_call": len(acts) / n,
        "d2h_copies_per_call": d2h / n,
        "d2h_copies_per_loop_per_call": [
            [op, k / n] for op, (_, k) in sorted(
                loops.items(), key=lambda kv: kv[1][0])],
        "idle_us_per_d2h": (window - busy) / d2h / 1e3 if d2h else None,
        "mean_idle_gap_us": float(np.mean(gaps)) / 1e3 if gaps else None,
        "top_events": top,
    }


def _trace(fn, arg, out_dir: str, name: str) -> dict:
    jax.block_until_ready(fn(arg))  # compile outside the trace
    d = os.path.join(out_dir, name)
    with jax.profiler.trace(d):
        for _ in range(CALLS):
            with jax.profiler.TraceAnnotation(name):
                jax.block_until_ready(fn(arg))
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    return reduce_trace(path, name)


def rescue_batch(d: int, rounds: int, batch: int, groups: int = 3):
    """A d x d, `rounds`-round circuit-level batch whose shots XOR
    `groups` independent operating-noise shots (detectors are linear in
    faults, so this is a valid heavier-noise record), with the dense
    decoder of its graph."""
    from benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode.device_uf import make_obs_decoder
    from qcss_tpu.sim.noise import NoiseModel

    graph, _, _, sample_dets_j, _ = build_pipeline(
        rotated_surface(d), rounds, NoiseModel(p_gate2=2e-3, p_meas=1e-2),
        "dem", decoder="dense")
    dets = sample_dets_j(jax.random.key(0), batch, rounds)[0]
    for g in range(1, groups):
        dets = dets ^ sample_dets_j(jax.random.key(g), batch, rounds)[0]
    return jax.jit(make_obs_decoder(graph)), dets


def mid_window(d: int, batch: int, p: float = 0.004):
    """The d x d streaming decoder's mid-window decode and one window of
    operating-noise detectors."""
    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode.device_streaming import DeviceStreamingDecoder
    from qcss_tpu.decode.streaming import sample_phenomenological_stream

    code = rotated_surface(d)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    dec = DeviceStreamingDecoder(h, lz, window=8, commit=4, p_space=p,
                                 p_time=p)
    dets, _ = sample_phenomenological_stream(jax.random.key(1), p, p,
                                             batch, 16, h, lz)
    return dec._mid_fn, jnp.asarray(dets[:, :8].reshape(batch, -1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/dense_uf_trace")
    ap.add_argument("--reduce-only", action="store_true",
                    help="re-reduce traces already under --out")
    args = ap.parse_args()
    if args.reduce_only:
        for name in ("rescue", "mid_window"):
            path = sorted(glob.glob(os.path.join(
                args.out, name, "**", "*.xplane.pb"), recursive=True))[-1]
            print(json.dumps({"place": name, **reduce_trace(path, name)}))
        return
    dev = jax.devices()[0]
    for name, (fn, arg) in (
            ("rescue", rescue_batch(D, D, RESCUE_BATCH)),
            ("mid_window", mid_window(D, STREAM_BATCH))):
        res = _trace(fn, arg, args.out, name)
        print(json.dumps({"place": name, "platform": dev.platform,
                          "device_kind": dev.device_kind,
                          "batch": int(arg.shape[0]), **res}), flush=True)


if __name__ == "__main__":
    main()
