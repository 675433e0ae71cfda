"""Roofline accounting for the hottest device kernels.

For each kernel, measure wall time at a production shape, compute the
ALGORITHMIC work (flops / bytes the algorithm requires, not what XLA
happens to materialize), and report achieved rates as a fraction of the
device's published peaks (`PEAKS`, keyed by ``device_kind``; an unknown
device is an error). The pinned float32 contractions run at
``Precision.HIGHEST`` (no TF32), so their compute roof is the float32
rate outside the tensor cores.

A kernel near the memory line is bandwidth-bound (more flops are free); a
kernel near neither line is latency/occupancy-bound — the honest
classification for small-tensor fixpoint loops.

Kernels:
  bp_totals   — BP min-sum variable-totals matmul [B, r*Dc] @ [r*Dc, n]
                (the per-iteration workhorse of decode/bp.py)
  osd0_device — blocked delayed-update GF(2) elimination
                (bp._osd0_device_kernel), bb144-circuit shape
  sparse_fetch— sparse-UF APSP fetch (the two one-hot contractions of
                decode/device_sparse.py) at the d=11 R=11 shape

Prints one JSON line per kernel.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

#: Published dense peaks per device kind (NVIDIA H100 data sheet, SXM5
#: part, without sparsity; rates assume the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12,
    },
}


def peaks(device=None) -> dict:
    """The `PEAKS` row of ``device`` (default: the first JAX device)."""
    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


def fence(x):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), x)


def bench(fn, reps=6):
    fence(fn())
    fence(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        fence(fn())
    return (time.perf_counter() - t0) / reps


def bp_totals():
    from qcss_tpu.codes.families import bb144
    from qcss_tpu.decode.bp import BPDecoder

    code = bb144()
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    B = 4096
    dec = BPDecoder(h, 0.003, iters=8, osd=False)
    r, n, dc = dec.r, dec.n, dec._chk_var.shape[1]
    m = jnp.zeros((B, r * dc), jnp.float32)
    scat = dec._scat

    f = jax.jit(lambda m: jnp.matmul(
        m, scat, precision=jax.lax.Precision.HIGHEST).sum())
    dt = bench(lambda: f(m))
    pk = peaks()
    flops = 2.0 * B * r * dc * n
    byts = 4.0 * (B * r * dc + r * dc * n + B * n)
    return {"kernel": "bp_totals", "shape": f"[{B},{r*dc}]x[{r*dc},{n}]",
            "ms": round(dt * 1e3, 2),
            "tflops": round(flops / dt / 1e12, 2),
            "frac_f32_peak": round(flops / dt / pk["f32"], 3),
            "gbps": round(byts / dt / 1e9, 1),
            "frac_hbm": round(byts / dt / pk["hbm"], 3),
            "bound": "compute" if flops / byts > pk["f32"] / pk["hbm"]
            else "bandwidth"}


def osd0_device():
    from qcss_tpu.codes.families import bb144
    from qcss_tpu.decode.bp import _osd0_device_kernel
    from qcss_tpu.decode.bp_dem import build_circuit_tanner
    from qcss_tpu.sim.noise import NoiseModel

    code = bb144()
    noise = NoiseModel(p_gate2=2e-3, p_meas=2e-3, p_reset=2e-3)
    tan = build_circuit_tanner(code, 12, noise, sector="z")
    h = tan.checks
    r, n = h.shape
    B = 1024
    C = min(n, r + 256)
    rng = np.random.default_rng(0)
    e = (rng.random((B, n)) < 0.002).astype(np.uint8)
    synd = jnp.asarray((e @ h.T) & 1)
    soft = jnp.asarray(rng.standard_normal((B, n)), jnp.float32)
    h_t = jnp.asarray(h.T)

    f = jax.jit(lambda s, so: _osd0_device_kernel(h_t, s, so, C)[0].sum())
    dt = bench(lambda: f(synd, soft), reps=3)
    W = (C + 31) // 32
    # phase-2 replay traffic per 32-col block: read+write [B, r, W] words
    byts = 2.0 * (C / 32) * B * r * W * 4
    bitops = float(B) * r * C * r / 64  # elimination bit-ops (upper bound)
    return {"kernel": "osd0_device", "shape": f"B={B} r={r} C={C}",
            "ms": round(dt * 1e3, 2),
            "gbps": round(byts / dt / 1e9, 1),
            "frac_hbm": round(byts / dt / peaks()["hbm"], 3),
            "bound": "bandwidth (blocked delayed-update traffic)"}


def sparse_fetch():
    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
    from qcss_tpu.decode.device_sparse import build_sparse_tables
    from qcss_tpu.sim.noise import NoiseModel

    code = rotated_surface(11)
    raw = code.raw_parity_check_c2
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    g = circuit_level_graph(raw, extraction_gate_list(code, raw), 11,
                            p_gate2=noise.p_gate2, p_meas=noise.p_meas,
                            p_reset=noise.p_reset,
                            logicals=code.z_operator_matrix())
    t = build_sparse_tables(g)
    V = t.num_nodes
    B, D = 16384, 48
    dist = jnp.asarray(t.dist).astype(jnp.float32)
    rng = np.random.default_rng(0)
    oh = jnp.asarray((rng.random((B, D, V)) < (20.0 / V / D)),
                     jnp.float32)

    hi = jax.lax.Precision.HIGHEST

    def go(oh):
        rows = jax.lax.dot_general(oh.reshape(B * D, V), dist,
                                   (((1,), (0,)), ((), ())), precision=hi,
                                   preferred_element_type=jnp.float32)
        dm = jnp.einsum("bdv,bev->bde", rows.reshape(B, D, V), oh,
                        precision=hi, preferred_element_type=jnp.float32)
        return dm.sum()

    f = jax.jit(go)
    dt = bench(lambda: f(oh), reps=4)
    pk = peaks()
    flops = 2.0 * B * D * V * V + 2.0 * B * D * D * V
    byts = 4.0 * (2 * B * D * V + V * V + B * D * D)
    return {"kernel": "sparse_fetch", "shape": f"B={B} D={D} V={V}",
            "ms": round(dt * 1e3, 2),
            "tflops": round(flops / dt / 1e12, 2),
            "frac_f32_peak": round(flops / dt / pk["f32"], 3),
            "gbps": round(byts / dt / 1e9, 1),
            "frac_hbm": round(byts / dt / pk["hbm"], 3),
            "bound": "compute" if flops / byts > pk["f32"] / pk["hbm"]
            else "bandwidth"}


def main():
    dev = jax.devices()[0]
    for fn in (bp_totals, sparse_fetch, osd0_device):
        print(json.dumps({"device_kind": dev.device_kind, **fn()}),
              flush=True)


if __name__ == "__main__":
    main()
