"""Sliding-window decoding ON DEVICE — unbounded-round memories, fused.

`decode.streaming.StreamingDecoder` bounds memory and work per round at
O(window * r), but decodes each window on the HOST via the edge-indicator
trick, so the device idles between windows. This module keeps the window
algebra and moves the decode into the device union-find
(`decode.device_uf`), using its parity LABEL LANES to read off exactly
what the commit rule needs without ever materializing per-edge
corrections:

* lane 0 carries each space edge's observable bit ONLY in the commit
  region (slices < C) — its decoded value IS the committed correction's
  observable contribution;
* lane 1 carries, on each time edge crossing the commit boundary
  (slice C-1 -> C, check c), the bit ``1 << c`` — its decoded value IS
  the carry-defect toggle mask for the next window.

Both are XORs of edge labels over the selected correction, which is
precisely what the union-find's path-parity readout computes for ANY
edge labeling. The final (closed-future) window decodes the plain
observable lane.

`stream_memory_rate` goes one step further and interleaves phenomenological
SAMPLING with windowed decoding in one loop of jitted device steps —
an unbounded-round memory experiment with O(window) state end to end
(VERDICT round-2 item 7; the host pipeline's counterpart is
`streaming.sample_phenomenological_stream` + `StreamingDecoder`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.decode.device_uf import build_device_graph, decode_labels
from qcss_tpu.decode.streaming import _window_graph


class DeviceStreamingDecoder:
    """Forward sliding-window decoder with device-side window decodes.

    Same contract as `streaming.StreamingDecoder.decode_stream`
    (detectors [B, S, r], last slice from perfect readout, returns [B]
    observable-flip masks), restricted to single-observable codes. Wide
    codes split the carry across ceil(r / 30) label lanes (lane counts
    are unconstrained in the device kernel)."""

    def __init__(self, h, logicals, *, window: int = 6, commit: int = 3,
                 p_space: float | None = None, p_time: float | None = None):
        if commit < 1 or window <= commit:
            raise ValueError("need window > commit >= 1")
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.r = self.h.shape[0]
        self.window = window
        self.commit = commit
        self._probs = (p_space, p_time)
        self._logicals = np.asarray(logicals, dtype=np.uint8) & 1
        if self._logicals.shape[0] != 1:
            raise ValueError("device streaming supports one observable")
        g, meta = _window_graph(self.h, self._logicals, window, True,
                                p_space, p_time)
        kind, sl = meta[:, 0], meta[:, 1]
        committed_obs = np.where(
            (kind == 0) & (sl < commit), g.edge_obs & 1, 0).astype(np.int64)
        carry_check = np.where((kind == 1) & (sl == commit - 1),
                               meta[:, 2], -1).astype(np.int32)
        self._setup(g, committed_obs, carry_check)

        def final_builder(slices):
            return _window_graph(self.h, self._logicals, slices, False,
                                 *self._probs)[0]

        self._final_builder = final_builder
        self._final: dict[int, object] = {}

    @classmethod
    def from_dem(cls, h, logicals, extraction_gates=None, *,
                 window: int = 8, commit: int = 4,
                 p_gate2: float = 0.0, p_meas: float = 0.0,
                 p_reset: float = 0.0, rate2=None):
        """Circuit-level streaming: sliding windows over the exact
        single-fault DEM of the extraction circuit (diagonal hook edges
        and all — `dem.circuit_level_window_graph`). The commit rule is
        unchanged: crossing edges all land on next-window slice 0, so
        the same carry-defect lanes drive the window stepping."""
        from qcss_tpu.decode.dem import (circuit_level_graph,
                                         circuit_level_window_graph)

        self = object.__new__(cls)
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.r = self.h.shape[0]
        self.window = window
        self.commit = commit
        self._logicals = np.asarray(logicals, dtype=np.uint8) & 1
        if self._logicals.shape[0] != 1:
            raise ValueError("device streaming supports one observable")
        if extraction_gates is None:
            gates = []
            for i in range(self.h.shape[0]):
                for j in np.nonzero(self.h[i])[0]:
                    gates.append((int(j), int(i)))
            extraction_gates = gates
        g, committed_obs, carry_check = circuit_level_window_graph(
            self.h, extraction_gates, window, commit,
            p_gate2=p_gate2, p_meas=p_meas, p_reset=p_reset,
            logicals=self._logicals, rate2=rate2)
        self._setup(g, committed_obs.astype(np.int64), carry_check)

        def final_builder(slices):
            return circuit_level_graph(
                self.h, extraction_gates, rounds=slices - 1,
                p_gate2=p_gate2, p_meas=p_meas, p_reset=p_reset,
                logicals=self._logicals, rate2=rate2)

        self._final_builder = final_builder
        self._final = {}
        return self

    def _setup(self, g, committed_obs, carry_check):
        """Build the mid-window device graph: lane 0 = committed-region
        obs; carry bits (crossing edges' next-window checks) split
        across ceil(r/30) lanes of <= 30 bits each."""
        self._n_carry = -(-self.r // 30)
        lanes = []
        for li in range(self._n_carry):
            lo, hi = 30 * li, min(30 * (li + 1), self.r)
            in_lane = (carry_check >= lo) & (carry_check < hi)
            lanes.append(np.where(
                in_lane,
                np.int64(1) << np.maximum(carry_check - lo, 0), 0))
        g_committed = g.__class__(
            num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
            edge_obs=committed_obs.astype(np.uint32), n_qubits=g.n_qubits,
            edge_weight=g.edge_weight)
        self._mid = build_device_graph(g_committed, extra_lanes=tuple(lanes))
        self._mid_fn = jax.jit(partial(decode_labels, self._mid))

    def _final_fn(self, slices: int):
        fn = self._final.get(slices)
        if fn is None:
            g = self._final_builder(slices)
            fn = jax.jit(partial(decode_labels, build_device_graph(g)))
            self._final[slices] = fn
        return fn

    def window_step(self, win, carry, obs):
        """One mid-stream window on device: returns (new obs, new carry).
        win: [B, W, r]; carry/obs: [B, r] uint8 / [B] int32. Pure."""
        W, r = self.window, self.r
        win = win.astype(jnp.uint8)
        win = win.at[:, 0, :].set(win[:, 0, :] ^ carry)
        labels, conv = self._mid_fn(win.reshape(win.shape[0], W * r))
        obs = obs ^ labels[0]
        chunks = []
        for li in range(self._n_carry):
            width = min(30 * (li + 1), r) - 30 * li
            chunks.append(((labels[1 + li][:, None]
                            >> jnp.arange(width)[None, :]) & 1
                           ).astype(jnp.uint8))
        carry = jnp.concatenate(chunks, axis=1)
        return obs, carry, conv

    def final_step(self, win, carry, obs, slices: int):
        r = self.r
        win = win.astype(jnp.uint8)
        win = win.at[:, 0, :].set(win[:, 0, :] ^ carry)
        (full_obs,), conv = self._final_fn(slices)(
            win.reshape(win.shape[0], slices * r))
        return obs ^ full_obs, conv

    def decode_stream(self, dets) -> np.ndarray:
        dets = jnp.asarray(dets)
        B, S, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} detectors/slice, graph {self.r}")
        W, C = self.window, self.commit
        obs = jnp.zeros(B, jnp.int32)
        carry = jnp.zeros((B, r), jnp.uint8)
        # convergence is accumulated ON DEVICE and checked once at the
        # end — a per-window host sync would stall the dispatch queue
        conv_all = jnp.bool_(True)
        s0 = 0
        while True:
            remaining = S - s0
            if remaining <= W:
                obs, conv = self.final_step(
                    dets[:, s0:s0 + remaining], carry, obs, remaining)
                conv_all = conv_all & jnp.all(conv)
                break
            obs, carry, conv = self.window_step(
                dets[:, s0:s0 + W], carry, obs)
            conv_all = conv_all & jnp.all(conv)
            s0 += C
        if not bool(conv_all):
            raise RuntimeError("growth cap hit")
        return np.asarray(obs).astype(np.uint32)


def stream_memory_rate(h, logicals, p, q, *, rounds: int, batch: int,
                       window: int = 8, commit: int = 4, seed: int = 0,
                       weighted: bool = True) -> dict[str, float]:
    """Unbounded-round phenomenological X-memory, sampled AND decoded on
    device with O(window) state: interleaves `commit`-round sampling
    chunks with sliding-window union-find decodes, so an R = 10^4-round
    memory never materializes more than one window of detectors.

    Physics identical to `streaming.sample_phenomenological_stream` (IID
    data-X layers at rate p per round, measurement flips at rate q,
    perfect final readout)."""
    from qcss_tpu.ops import gf2_jax

    h_j = jnp.asarray(np.asarray(h, np.uint8) & 1)
    lz = jnp.asarray(np.asarray(logicals, np.uint8) & 1)
    r, n = h_j.shape
    dec = DeviceStreamingDecoder(
        h, logicals, window=window, commit=commit,
        p_space=p if weighted else None, p_time=q if weighted else None)
    W, C = window, commit
    if rounds < W:
        raise ValueError("need rounds >= window")

    @partial(jax.jit, static_argnames=("m",))
    def sample_chunk(cum, prev_syn, key, m):
        def body(carry, kr):
            cum, prev = carry
            ke, kf = jax.random.split(kr)
            cum = cum ^ (jax.random.uniform(ke, (batch, n)) < p
                         ).astype(jnp.uint8)
            syn = gf2_jax.syndromes_dense(cum, h_j) ^ (
                jax.random.uniform(kf, (batch, r)) < q).astype(jnp.uint8)
            return (cum, syn), syn ^ prev
        keys = jax.random.split(key, m)
        (cum, prev_syn), dets = jax.lax.scan(body, (cum, prev_syn), keys)
        return cum, prev_syn, jnp.moveaxis(dets, 0, 1)  # [B, m, r]

    window_step = jax.jit(dec.window_step)

    key = jax.random.key(seed)
    cum = jnp.zeros((batch, n), jnp.uint8)
    prev = jnp.zeros((batch, r), jnp.uint8)
    obs = jnp.zeros(batch, jnp.int32)
    carry = jnp.zeros((batch, r), jnp.uint8)

    key, k0 = jax.random.split(key)
    cum, prev, buf = sample_chunk(cum, prev, k0, W)  # [B, W, r]
    sampled = W
    while sampled < rounds:
        m = min(C, rounds - sampled)
        if m < C:
            break  # tail handled by the final window below
        obs, carry, conv = window_step(buf, carry, obs)
        key, kc = jax.random.split(key)
        cum, prev, fresh = sample_chunk(cum, prev, kc, C)
        buf = jnp.concatenate([buf[:, C:], fresh], axis=1)
        sampled += C
    # remaining rounds (rounds - sampled < C): sample them, then close
    # with the perfect final readout slice
    tail = rounds - sampled
    if tail:
        key, kt = jax.random.split(key)
        cum, prev, fresh = sample_chunk(cum, prev, kt, tail)
        buf = jnp.concatenate([buf, fresh], axis=1)
    key, kf = jax.random.split(key)
    cum = cum ^ (jax.random.uniform(kf, (batch, n)) < p).astype(jnp.uint8)
    final_slice = (gf2_jax.syndromes_dense(cum, h_j) ^ prev)[:, None, :]
    buf = jnp.concatenate([buf, final_slice], axis=1)
    obs, conv = dec.final_step(buf, carry, obs, int(buf.shape[1]))
    if not bool(jnp.all(conv)):
        raise RuntimeError("growth cap hit")
    par = gf2_jax.mod2_matmul(cum, lz.T)[:, 0]
    fails = int(jnp.sum((obs & 1).astype(jnp.int32) ^ par.astype(jnp.int32)))
    return {
        "logical_fail": fails / batch,
        "rounds": rounds,
        "samples": batch,
        "window": window,
        "commit": commit,
    }


def stream_memory_rate_dem(code, noise, *, rounds: int, batch: int,
                           window: int = 8, commit: int = 4,
                           seed: int = 0) -> dict[str, float]:
    """Unbounded-round CIRCUIT-LEVEL Z-memory, sampled AND decoded on
    device with O(window) state: Pauli-frame sampling of the real
    extraction circuit (same physics and per-round key split as
    `experiments.memory._memory_circuit_frames`) interleaved with
    sliding-window decodes on the exact single-fault DEM
    (`DeviceStreamingDecoder.from_dem`). The DEM covers the
    p_gate2/p_meas/p_reset species; idle noise is NOT supported by this
    single-sector sampler (raises — use the two-sector qLDPC pipelines,
    which sample AND model idle)."""
    from qcss_tpu.decode.dem import extraction_gate_list
    from qcss_tpu.experiments import memory as M
    from qcss_tpu.ops import gf2_jax

    if noise.p_idle:
        raise ValueError("stream_memory_rate_dem's single-sector sampler "
                         "does not model idle noise; use "
                         "experiments.qldpc_stream_memory_rate")
    from qcss_tpu.sim import frame as fr

    raw = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    lz = jnp.asarray(np.asarray(code.z_operator_matrix(), np.uint8) & 1)
    r = raw.shape[0]
    n = code.n
    gates = extraction_gate_list(code, raw)
    dec = DeviceStreamingDecoder.from_dem(
        raw, code.z_operator_matrix(), gates, window=window,
        commit=commit, p_gate2=noise.p_gate2, p_meas=noise.p_meas,
        p_reset=noise.p_reset, rate2=noise.pauli2)
    W, C = window, commit
    if rounds < W:
        raise ValueError("need rounds >= window")
    ext = tuple(map(jnp.asarray, M.z_extraction_circuit(
        code, checks=raw).to_arrays()))
    comp = fr.maybe_compile(ext, n + r)
    anc = jnp.arange(n, n + r, dtype=jnp.int32)
    data = jnp.arange(n, dtype=jnp.int32)
    raw_j = jnp.asarray(raw, jnp.uint8)

    @partial(jax.jit, static_argnames=("m",))
    def sample_chunk(f, prev_syn, key, m):
        def body(carry, k):
            f, prev = carry
            k1, _k2, k3, k4 = jax.random.split(k, 4)
            if comp is not None:
                f = fr.run_compiled_noisy(f, comp, noise, k1)
            else:
                f = fr.run_arrays_noisy(f, *ext, noise, k1)
            f, syn = fr.measure_deviations(f, anc, k3, noise.p_meas)
            f = fr.reset_qubits(f, anc, k4)
            return (f, syn), syn ^ prev
        keys = jax.random.split(key, m)
        (f, prev_syn), dets = jax.lax.scan(body, (f, prev_syn), keys)
        return f, prev_syn, jnp.moveaxis(dets, 0, 1)  # [B, m, r]

    window_step = jax.jit(dec.window_step)

    key = jax.random.key(seed)
    f = fr.zero_frames(batch, n + r)
    prev = jnp.zeros((batch, r), jnp.uint8)
    obs = jnp.zeros(batch, jnp.int32)
    carry = jnp.zeros((batch, r), jnp.uint8)

    key, k0 = jax.random.split(key)
    f, prev, buf = sample_chunk(f, prev, k0, W)
    sampled = W
    while sampled < rounds:
        m = min(C, rounds - sampled)
        if m < C:
            break  # tail handled by the final window below
        obs, carry, conv = window_step(buf, carry, obs)
        key, kc = jax.random.split(key)
        f, prev, fresh = sample_chunk(f, prev, kc, C)
        buf = jnp.concatenate([buf[:, C:], fresh], axis=1)
        sampled += C
    tail = rounds - sampled
    if tail:
        key, kt = jax.random.split(key)
        f, prev, fresh = sample_chunk(f, prev, kt, tail)
        buf = jnp.concatenate([buf, fresh], axis=1)
    # perfect final readout of the data deviations
    _, word = fr.measure_deviations(f, data)
    final_slice = (gf2_jax.syndromes_dense(word, raw_j) ^ prev)[:, None, :]
    buf = jnp.concatenate([buf, final_slice], axis=1)
    obs, conv = dec.final_step(buf, carry, obs, int(buf.shape[1]))
    if not bool(jnp.all(conv)):
        raise RuntimeError("growth cap hit")
    par = gf2_jax.mod2_matmul(word, lz.T)[:, 0]
    fails = int(jnp.sum((obs & 1).astype(jnp.int32) ^ par.astype(jnp.int32)))
    return {
        "logical_fail": fails / batch,
        "rounds": rounds,
        "samples": batch,
        "window": window,
        "commit": commit,
    }
