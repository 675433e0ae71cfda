"""The trace-to-metrics reduction of `benchmarks/dense_uf_trace.py`,
checked on a small trace recorded here (CPU: host spans, no device
planes)."""

from __future__ import annotations

import glob
import os

import jax
import jax.numpy as jnp

from benchmarks.dense_uf_trace import _union, reduce_trace


def test_union_merges_overlaps():
    assert _union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]


def test_reduce_recorded_trace(tmp_path):
    f = jax.jit(lambda x: jax.lax.while_loop(
        lambda s: s[1] < 5, lambda s: (s[0] * 2, s[1] + 1), (x, 0))[0])
    jax.block_until_ready(f(jnp.ones(4)))
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            with jax.profiler.TraceAnnotation("call"):
                jax.block_until_ready(f(jnp.ones(4)))
    path = glob.glob(os.path.join(tmp_path, "**", "*.xplane.pb"),
                     recursive=True)[0]
    res = reduce_trace(path, "call")
    assert res["calls"] == 2 and res["window_ms_per_call"] > 0
    # the CPU backend writes no device planes: nothing counted as busy
    assert res["device_events_per_call"] == 0
    assert res["device_idle_share"] == 1.0
