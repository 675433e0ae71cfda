"""Parallel-window decoding — every window of a long memory in O(1) calls.

The forward sliding window (`decode.streaming`, `decode.device_streaming`)
is inherently SEQUENTIAL: window k+1's defects depend on window k's
committed corrections (the carry toggles), so an R-round memory costs
R/C dependent device round-trips — the decoder's latency grows linearly
in R even though each window is embarrassingly batch-parallel.

Parallel-window decoding (Skoric et al., Nat. Commun. 14, 7040 (2023),
arXiv:2209.08552; also Tan et al., arXiv:2209.09219) removes the
sequential chain with a two-layer commit schedule:

* **Layer A** — K non-overlapping "core" regions of `core` slices,
  separated by `buf`-slice seams. Window k decodes its core plus the
  adjacent seams (open time boundaries on both sides — a chain may exit
  toward a neighbour's core and be re-decoded there) and commits ONLY
  the core. All K windows are INDEPENDENT: they fold into the batch
  axis and decode in ONE device union-find call.
* **Layer B** — the K-1 seams. A committed chain that crossed a core
  boundary toggles an artificial defect on the seam side (the same
  commit rule the forward decoder applies at its single boundary, here
  applied at both core boundaries). Every seam's defect record is then
  fully determined, its time boundaries are CLOSED (both neighbours
  committed right up to its edges), and all K-1 seams decode in one
  more batched call.

Total: at most 4 device calls (first/interior/last A shapes + seams)
for ANY number of rounds — decode latency is O(1) in R instead of
O(R), and the windows exploit exactly the resource an accelerator has to spare:
batch parallelism. Commit-rule outputs ride the union-find kernel's
label lanes as in `device_streaming`: lane 0 is the committed-region
observable, and each core-boundary crossing carries ``1 << check`` on
ceil(r/30) carry lanes per side.

Accuracy (measured, d=5 surface, identical shots): at operating
density (p=q=0.004, R=40) buf=8 (~1.5d) reaches 99.5% whole-history
agreement and failure-rate parity (0.51% vs 0.49%; forward streaming
0.51%). Near threshold (p=q=0.012) a small excess remains (5.6% vs
5.2%) that larger buffers do not remove — layer-A windows decide with
OPEN boundaries on both sides, while the forward window's past
boundary is exact; that is the price of the O(1) latency and is
inherent to the published scheme. tests/test_parallel_window.py pins
both regimes.

The reference decodes one syndrome at a time inside the emitted
program and has no multi-round machinery at all (reference:
css_code.py:649-685).
"""

from __future__ import annotations

from functools import partial, reduce

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.decode.device_uf import build_device_graph, decode_labels
from qcss_tpu.decode.uf import (
    MatchingGraph,
    graph_from_checks,
    weights_from_probs,
)


def _pw_graph(h, logicals, slices: int, *, open_past: bool,
              open_future: bool, commit_lo: int, commit_hi: int,
              p_space, p_time):
    """Spacetime window graph with a two-sided commit rule.

    Returns (graph, left_check, right_check): the graph's `edge_obs`
    holds the observable bit of space edges inside the commit region
    [commit_lo, commit_hi) only; `left_check[e]` is the detector column
    of a time edge crossing the LEFT commit boundary (slice
    commit_lo-1 -> commit_lo; toggle lands on slice commit_lo-1, the
    uncommitted side), -1 elsewhere; `right_check` likewise for the
    right boundary (toggle lands on slice commit_hi)."""
    base = graph_from_checks(h, logicals)
    r = base.num_nodes
    edges, eobs, lchk, rchk, probs = [], [], [], [], []
    for t in range(slices):
        off = t * r
        committed = commit_lo <= t < commit_hi
        for (a, b), o in zip(base.edges, base.edge_obs):
            edges.append((off + a, -1 if b < 0 else off + b))
            eobs.append(int(o) if committed else 0)
            lchk.append(-1)
            rchk.append(-1)
            probs.append(p_space)
    for t in range(slices - 1):
        for c in range(r):
            edges.append((t * r + c, (t + 1) * r + c))
            eobs.append(0)
            lchk.append(c if (commit_lo > 0 and t == commit_lo - 1) else -1)
            rchk.append(c if (commit_hi < slices and t == commit_hi - 1)
                        else -1)
            probs.append(p_time)
    if open_past:
        for c in range(r):
            edges.append((c, -1))
            eobs.append(0)
            lchk.append(-1)
            rchk.append(-1)
            probs.append(p_time)
    if open_future:
        for c in range(r):
            edges.append(((slices - 1) * r + c, -1))
            eobs.append(0)
            lchk.append(-1)
            rchk.append(-1)
            probs.append(p_time)
    weight = None
    if p_space is not None or p_time is not None:
        if p_space is None or p_time is None:
            raise ValueError("pass both p_space and p_time, or neither")
        weight = weights_from_probs(probs)
    n_e = len(edges)
    graph = MatchingGraph(
        num_nodes=slices * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.arange(n_e, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n_e,
        edge_weight=weight,
    )
    return (graph, np.asarray(lchk, dtype=np.int32),
            np.asarray(rchk, dtype=np.int32))


class ParallelWindowDecoder:
    """Two-layer parallel-window decoder over an r-detector stream.

    Same contract as `StreamingDecoder.decode_stream`: `decode_stream`
    takes `[B, S, r]` detection events (last slice from perfect
    readout) and returns `[B]` uint32 observable-flip masks —
    restricted to single-observable matchable codes whose matching
    graph has at least one space boundary edge (a closed code's seam
    could strand odd defect parity in a closed seam graph).

    core: slices committed by each layer-A window;
    buf:  seam width between cores (also each A window's one-sided
          lookahead) — buf >= d recovers whole-history accuracy.
    """

    def __init__(self, h, logicals, *, core: int = 3, buf: int = 3,
                 p_space: float | None = None, p_time: float | None = None):
        if core < 1 or buf < 1:
            raise ValueError("need core >= 1 and buf >= 1")
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.r = self.h.shape[0]
        self.core, self.buf = core, buf
        self._probs = (p_space, p_time)
        self._logicals = np.asarray(logicals, dtype=np.uint8) & 1
        if self._logicals.shape[0] != 1:
            raise ValueError("parallel windows support one observable")
        base = graph_from_checks(self.h, self._logicals)
        if not np.any(base.edges < 0):
            raise ValueError(
                "matching graph has no space boundary edges; closed-code "
                "seams can strand odd defect parity — use the forward "
                "StreamingDecoder instead")
        self._n_carry = -(-self.r // 30)
        c, b = core, buf
        # Layer-B windows extend `ext` slices into each neighbouring
        # committed core: the extension region's residual defects are
        # zero, but seam chains may ROUTE through it (to the space
        # boundary, or around a toggle) — without it, a chain crossing
        # the whole seam is forced into a short closed box and the
        # decode measurably degrades (95.5% -> 99.5% whole-history
        # agreement at d=5, p=q=0.012). Extensions of adjacent seams
        # stay disjoint (ext <= core // 2) so every edge is committed
        # by EXACTLY one window and the global correction is a plain
        # XOR of window corrections.
        self._ext = ext = min(b, c // 2)
        self._first = self._build(c + b, open_past=False, open_future=True,
                                  commit_lo=0, commit_hi=c)
        self._mid = self._build(c + 2 * b, open_past=True, open_future=True,
                                commit_lo=b, commit_hi=b + c)
        sb = b + 2 * ext
        self._seam = self._build(sb, open_past=False, open_future=False,
                                 commit_lo=0, commit_hi=sb)
        self._last: dict[int, object] = {}   # keyed by last-core width
        self._whole: dict[int, object] = {}  # K < 2 fallback, keyed by S

    # -- graph/jit construction -------------------------------------------

    def _carry_lanes(self, check):
        lanes = []
        for li in range(self._n_carry):
            lo, hi = 30 * li, min(30 * (li + 1), self.r)
            in_lane = (check >= lo) & (check < hi)
            lanes.append(np.where(
                in_lane, np.int64(1) << np.maximum(check - lo, 0), 0))
        return lanes

    def _build(self, slices, **kw):
        g, lchk, rchk = _pw_graph(self.h, self._logicals, slices,
                                  p_space=self._probs[0],
                                  p_time=self._probs[1], **kw)
        lanes = []
        if kw["commit_lo"] > 0:
            lanes.extend(self._carry_lanes(lchk))
        if kw["commit_hi"] < slices:
            lanes.extend(self._carry_lanes(rchk))
        dg = build_device_graph(g, extra_lanes=tuple(lanes))
        return jax.jit(partial(decode_labels, dg))

    def _last_fn(self, core_last: int):
        fn = self._last.get(core_last)
        if fn is None:
            fn = self._build(self.buf + core_last, open_past=True,
                             open_future=False, commit_lo=self.buf,
                             commit_hi=self.buf + core_last)
            self._last[core_last] = fn
        return fn

    def _whole_fn(self, slices: int):
        fn = self._whole.get(slices)
        if fn is None:
            fn = self._build(slices, open_past=False, open_future=False,
                             commit_lo=0, commit_hi=slices)
            self._whole[slices] = fn
        return fn

    def _unpack(self, lanes):
        """ceil(r/30) packed [N] int32 lanes -> [N, r] uint8 toggles."""
        chunks = []
        for li, lab in enumerate(lanes):
            width = min(30 * (li + 1), self.r) - 30 * li
            chunks.append(((lab[:, None] >> jnp.arange(width)[None, :]) & 1
                           ).astype(jnp.uint8))
        return jnp.concatenate(chunks, axis=1)

    # -- decoding ----------------------------------------------------------

    def decode_stream(self, dets) -> np.ndarray:
        obs, conv_all = self.decode_traced(jnp.asarray(dets))
        if not bool(conv_all):
            raise RuntimeError("growth cap hit")
        return np.asarray(obs).astype(np.uint32)

    def decode_traced(self, dets):
        """Pure traced decode: [B, S, r] -> (obs [B] int32, converged
        bool). Jit-composable — embed after a sampler so sampling and
        ALL window decodes compile into one device program
        (`parallel_window_memory_rate`)."""
        dets = dets.astype(jnp.uint8)
        B, S, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} detectors/slice, graph {self.r}")
        c, b, nc = self.core, self.buf, self._n_carry
        stride = c + b
        K = (S + b) // stride
        if K < 2:
            (obs,), conv = self._whole_fn(S)(dets.reshape(B, S * r))
            return obs, jnp.all(conv)
        core_last = S - (K * c + (K - 1) * b) + c

        conv_all = jnp.bool_(True)
        # layer A, first window: commits core 0, right carry into seam 0
        lab, cv = self._first(dets[:, :c + b].reshape(B, -1))
        conv_all &= jnp.all(cv)
        obs = lab[0]
        right = [self._unpack(lab[1:1 + nc])]          # per core k: [B, r]
        left = [None]                                   # core 0 has no left
        # layer A, interior windows: ONE batched call for all K-2
        if K > 2:
            starts = np.arange(1, K - 1) * stride - b
            idx = starts[:, None] + np.arange(c + 2 * b)[None, :]
            win = dets[:, idx, :].reshape(B * (K - 2), -1)
            lab, cv = self._mid(win)
            conv_all &= jnp.all(cv)
            obs_k = lab[0].reshape(B, K - 2)
            obs = obs ^ reduce(jnp.bitwise_xor,
                               [obs_k[:, i] for i in range(K - 2)])
            lmid = self._unpack(lab[1:1 + nc]).reshape(B, K - 2, r)
            rmid = self._unpack(lab[1 + nc:1 + 2 * nc]).reshape(B, K - 2, r)
            left.extend(lmid[:, i] for i in range(K - 2))
            right.extend(rmid[:, i] for i in range(K - 2))
        # layer A, last window: commits the (possibly wider) last core
        lab, cv = self._last_fn(core_last)(
            dets[:, S - (b + core_last):].reshape(B, -1))
        conv_all &= jnp.all(cv)
        obs = obs ^ lab[0]
        left.append(self._unpack(lab[1:1 + nc]))
        # layer B: all K-1 seams in one batched call, boundaries closed.
        # Window = seam + `ext` slices into each committed neighbour
        # core; the extension's residual defects are zero by commit
        # (A explained them), so only the seam slices carry data and
        # the two boundary toggles.
        ext = self._ext
        sstarts = np.arange(K - 1) * stride + c - ext
        sidx = sstarts[:, None] + np.arange(b + 2 * ext)[None, :]
        seams = dets[:, sidx, :]                        # [B, K-1, b+2e, r]
        mask = np.zeros((1, 1, b + 2 * ext, 1), np.uint8)
        mask[:, :, ext:ext + b, :] = 1
        seams = seams * jnp.asarray(mask)
        rstack = jnp.stack(right, axis=1)               # [B, K-1, r]
        lstack = jnp.stack(left[1:], axis=1)            # [B, K-1, r]
        seams = seams.at[:, :, ext, :].set(seams[:, :, ext, :] ^ rstack)
        seams = seams.at[:, :, ext + b - 1, :].set(
            seams[:, :, ext + b - 1, :] ^ lstack)
        lab, cv = self._seam(seams.reshape(B * (K - 1), -1))
        conv_all &= jnp.all(cv)
        obs_k = lab[0].reshape(B, K - 1)
        obs = obs ^ reduce(jnp.bitwise_xor,
                           [obs_k[:, i] for i in range(K - 1)])
        return obs, conv_all


def parallel_window_memory_rate(h, logicals, p, q, *, rounds: int,
                                batch: int, core: int, buf: int,
                                seed: int = 0, weighted: bool = True):
    """Phenomenological memory experiment with the WHOLE pipeline — a
    `lax.scan` stream sampler plus every layer-A window, every seam, and
    the failure count — compiled into ONE device program. The
    parallel-window counterpart of `device_streaming.stream_memory_rate`:
    that one bounds MEMORY (O(window) state, sequential round-trips);
    this one bounds LATENCY (the recorded stream decodes in O(1) device
    calls, here fused to literally one). Returns
    dict(logical_fail, samples, rounds)."""
    import jax

    from qcss_tpu.decode.streaming import sample_phenomenological_stream

    h = np.asarray(h, np.uint8) & 1
    logicals = np.atleast_2d(np.asarray(logicals, np.uint8) & 1)[:1]
    pw = ParallelWindowDecoder(
        h, logicals, core=core, buf=buf,
        p_space=p if weighted else None, p_time=q if weighted else None)

    @jax.jit
    def run(key):
        dets, par = sample_phenomenological_stream(
            key, jnp.float32(p), jnp.float32(q), batch, rounds,
            jnp.asarray(h, jnp.uint8), jnp.asarray(logicals, jnp.uint8))
        obs, conv = pw.decode_traced(dets)
        fail = (obs & 1).astype(jnp.uint8) != par[:, 0]
        return jnp.sum(fail.astype(jnp.int32)), conv

    fails, conv = run(jax.random.key(seed))
    if not bool(conv):
        raise RuntimeError("growth cap hit")
    return {"logical_fail": int(fails) / batch, "samples": batch,
            "rounds": rounds}
