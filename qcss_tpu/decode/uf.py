"""Union-find decoding for matchable CSS codes — the scalable decoder.

The reference's only decoder is a dense syndrome LUT, exponential in the
number of checks (reference: css_code.py:649-735): surface d=5 (12 checks
per sector) is its practical ceiling. This module decodes matching graphs
of arbitrary distance — including 3D spacetime graphs for multi-round
memory experiments — with the Delfosse-Nickerson union-find algorithm
(arXiv:1709.06218).

Division of labor, device-first: error sampling and syndrome extraction run
batched on the device (`jax`), producing compact `[B, r]` syndrome bit
arrays plus `[B]` logical-parity bits; the irregular, data-dependent
grow-and-peel runs as a threaded native host kernel
(`qcss_tpu/native/uf_decoder.cc`, ctypes), with a pure-Python fallback.
A logical failure is recorded when the decoder's predicted observable
parity disagrees with the actual error's.

Graph model: each detector is a node; each elementary fault is an edge
between the (at most two) detectors it flips, with the boundary as a
virtual node for single-detector faults. `edge_qubit` maps an edge back to
the data qubit it corrects (-1 for measurement-error edges), `edge_obs` is
a bitmask of logical observables the fault flips.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu import native
from qcss_tpu.ops import gf2_jax


@dataclass(frozen=True)
class MatchingGraph:
    """A decoding graph. ``edges`` is [E, 2] int32 (-1 = boundary),
    ``edge_qubit`` [E] int32 (-1 = no data qubit), ``edge_obs`` [E] uint32
    observable bitmasks, ``edge_weight`` [E] uint8 growth halves to
    saturation (2 everywhere = unweighted; ~ -log fault probability when
    weighted, see `weights_from_probs`)."""

    num_nodes: int
    edges: np.ndarray
    edge_qubit: np.ndarray
    edge_obs: np.ndarray
    n_qubits: int
    edge_weight: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "edges", np.ascontiguousarray(self.edges, np.int32))
        object.__setattr__(
            self, "edge_qubit", np.ascontiguousarray(self.edge_qubit, np.int32)
        )
        object.__setattr__(
            self, "edge_obs", np.ascontiguousarray(self.edge_obs, np.uint32)
        )
        w = self.edge_weight
        if w is None:
            w = np.full(self.edges.shape[0], 2, dtype=np.uint8)
        object.__setattr__(
            self, "edge_weight", np.ascontiguousarray(w, np.uint8)
        )

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]


def weights_from_probs(probs) -> np.ndarray:
    """Integer growth weights from per-edge fault probabilities:
    w_e = max(2, round(2 * ln(p_e) / ln(p_max))) — the most likely edge
    gets weight 2 (one half per endpoint per round, the unweighted pace),
    less likely edges proportionally more; clamped to 250 (uint8
    support counters)."""
    probs = np.asarray(probs, dtype=np.float64)
    if np.any(probs <= 0) or np.any(probs >= 1):
        raise ValueError("edge probabilities must lie in (0, 1)")
    base = np.log(probs.max())
    w = np.rint(2.0 * np.log(probs) / base)
    return np.clip(w, 2, 250).astype(np.uint8)


def _column_obs_masks(logicals: np.ndarray) -> np.ndarray:
    """obs[j] = bitmask over logical rows containing qubit j."""
    k, n = logicals.shape
    if k > 32:
        raise ValueError("at most 32 logical observables supported")
    masks = np.zeros(n, dtype=np.uint32)
    for i in range(k):
        masks |= (logicals[i].astype(np.uint32)) << i
    return masks


def graph_from_checks(h: np.ndarray, logicals: np.ndarray) -> MatchingGraph:
    """Code-capacity matching graph: one edge per data qubit, connecting the
    (at most two) checks it participates in. Raises for non-matchable codes
    (some qubit in more than two checks, e.g. Steane — use the LUT path for
    those)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    obs = _column_obs_masks(np.asarray(logicals, dtype=np.uint8) & 1)
    edges, equbit, eobs = [], [], []
    for j in range(n):
        checks = np.nonzero(h[:, j])[0]
        if checks.size > 2:
            raise ValueError(
                f"qubit {j} participates in {checks.size} checks; "
                "not a matchable code"
            )
        if checks.size == 0:
            continue  # undetectable fault: no edge can decode it
        a = int(checks[0])
        b = int(checks[1]) if checks.size == 2 else -1
        edges.append((a, b))
        equbit.append(j)
        eobs.append(int(obs[j]))
    return MatchingGraph(
        num_nodes=r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.asarray(equbit, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n,
    )


def spacetime_graph(h: np.ndarray, logicals: np.ndarray, rounds: int,
                    p_space: float | None = None,
                    p_time: float | None = None) -> MatchingGraph:
    """Phenomenological spacetime graph for an R-round memory experiment
    with a final perfect readout: R+1 detector slices (slice t holds the
    detection events syn[t] ^ syn[t-1]; slice R comes from the perfect
    final-word syndrome), space edges per slice (data errors arising in
    that round), and time edges between consecutive slices t, t+1 for
    t < R (measurement errors in round t).

    With ``p_space``/``p_time`` (per-round data-error and measurement-flip
    probabilities), edges carry -log-likelihood growth weights
    (`weights_from_probs`), so e.g. accurate measurements make the decoder
    reluctant to blame time edges. Both default to None = unweighted."""
    base = graph_from_checks(h, logicals)
    r = base.num_nodes
    slices = rounds + 1
    edges, equbit, eobs = [], [], []
    for t in range(slices):
        off = t * r
        for (a, b), q, o in zip(base.edges, base.edge_qubit, base.edge_obs):
            edges.append((off + a, -1 if b < 0 else off + b))
            equbit.append(int(q))
            eobs.append(int(o))
    n_space = len(edges)
    for t in range(rounds):
        for c in range(r):
            edges.append((t * r + c, (t + 1) * r + c))
            equbit.append(-1)
            eobs.append(0)
    weight = None
    if p_space is not None or p_time is not None:
        if p_space is None or p_time is None:
            raise ValueError("pass both p_space and p_time, or neither")
        probs = np.concatenate([
            np.full(n_space, p_space),
            np.full(len(edges) - n_space, p_time),
        ])
        weight = weights_from_probs(probs)
    return MatchingGraph(
        num_nodes=slices * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.asarray(equbit, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=base.n_qubits,
        edge_weight=weight,
    )


# -- pure-Python decoder (fallback + differential oracle) ----------------------


def _decode_one_py(g: MatchingGraph, syn: np.ndarray, want_corr: bool,
                   wt: np.ndarray | None = None):
    """Single-shot union-find decode; mirrors `uf_decoder.cc` step for step
    (same growth order, same head-insertion adjacency → identical output).
    ``wt`` overrides the graph's edge weights for this shot."""
    N = g.num_nodes
    B = N
    parent = list(range(N + 1))
    rnk = [0] * (N + 1)
    parity = [int(x) & 1 for x in syn] + [0]
    boundary = [False] * N + [True]
    defect = parity[:]
    defect[B] = 0
    support = [0] * g.num_edges
    corr = np.zeros(g.n_qubits, dtype=np.uint8) if want_corr else None
    obs = 0

    if not any(parity[:N]):
        return corr, 0

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def unite(a, b):
        if a == b:
            return a
        if rnk[a] < rnk[b]:
            a, b = b, a
        parent[b] = a
        parity[a] ^= parity[b]
        boundary[a] = boundary[a] or boundary[b]
        if rnk[a] == rnk[b]:
            rnk[a] += 1
        return a

    def active(root):
        return parity[root] and not boundary[root]

    # Canonical simultaneous growth (mirrors uf_decoder.cc): grow against
    # the start-of-round cluster state, then merge saturated edges.
    ed = g.edges
    wt = g.edge_weight if wt is None else wt
    while any(active(find(i)) for i in range(N)):
        grew = False
        merges: list[int] = []
        for e in range(g.num_edges):
            if support[e] >= wt[e]:
                continue
            u, v = int(ed[e, 0]), int(ed[e, 1])
            ru = find(B if u < 0 else u)
            rv = find(B if v < 0 else v)
            if ru == rv:
                continue
            inc = int(active(ru)) + int(active(rv))
            if not inc:
                continue
            grew = True
            support[e] += inc
            if support[e] >= wt[e]:
                support[e] = wt[e]
                merges.append(e)
        for e in merges:
            u, v = int(ed[e, 0]), int(ed[e, 1])
            unite(find(B if u < 0 else u), find(B if v < 0 else v))
        if not grew:
            break

    # peeling: adjacency in reverse edge order (head-insertion semantics)
    adj: list[list[tuple[int, int]]] = [[] for _ in range(N + 1)]
    for e in range(g.num_edges):
        if support[e] < wt[e]:
            continue
        u, v = int(ed[e, 0]), int(ed[e, 1])
        a = B if u < 0 else u
        b = B if v < 0 else v
        adj[a].append((b, e))
        adj[b].append((a, e))

    visited = [False] * (N + 1)
    order: list[int] = []
    parent_vert = [-2] * (N + 1)
    parent_edge = [-1] * (N + 1)

    def bfs_from(root):
        visited[root] = True
        qhead = len(order)
        order.append(root)
        while qhead < len(order):
            v = order[qhead]
            qhead += 1
            for w, e in reversed(adj[v]):
                if visited[w]:
                    continue
                visited[w] = True
                parent_vert[w] = v
                parent_edge[w] = e
                order.append(w)

    bfs_from(B)
    for i in range(N):
        if not visited[i] and defect[i]:
            bfs_from(i)

    for v in reversed(order):
        if not defect[v] or parent_vert[v] < 0:
            continue
        e = parent_edge[v]
        defect[v] = 0
        defect[parent_vert[v]] ^= 1
        obs ^= int(g.edge_obs[e])
        q = int(g.edge_qubit[e])
        if corr is not None and q >= 0:
            corr[q] ^= 1
    return corr, obs


def _decode_batch_py(g: MatchingGraph, syndromes: np.ndarray, want_corr: bool,
                     shot_weights: np.ndarray | None = None):
    batch = syndromes.shape[0]
    corr = np.zeros((batch, g.n_qubits), dtype=np.uint8) if want_corr else None
    obs = np.zeros(batch, dtype=np.uint32)
    for b in range(batch):
        wt = None if shot_weights is None else shot_weights[b]
        c, o = _decode_one_py(g, syndromes[b], want_corr, wt)
        if corr is not None:
            corr[b] = c
        obs[b] = o
    return corr, obs


class UFDecoder:
    """Batched union-find decoder over a fixed MatchingGraph.

    `decode_batch(syndromes)` takes `[B, num_nodes]` 0/1 detection events
    and returns `(corrections [B, n_qubits] uint8 | None, obs_flips [B]
    uint32)`. Native (threaded C++) when available, pure Python otherwise;
    the two are bit-identical (differentially tested)."""

    def __init__(self, graph: MatchingGraph, use_native: bool | None = None):
        self.graph = graph
        self.use_native = native.available() if use_native is None else use_native

    def decode_batch(self, syndromes, want_corrections: bool = True,
                     n_threads: int | None = None,
                     shot_weights: np.ndarray | None = None):
        """``shot_weights`` ([B, num_edges] uint8, values >= 1) overrides
        the graph's growth weights per shot — the hook correlated two-pass
        decoding uses (`decode.correlated`)."""
        syndromes = np.ascontiguousarray(np.asarray(syndromes), dtype=np.uint8)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.graph.num_nodes:
            raise ValueError(
                f"syndromes must be [B, {self.graph.num_nodes}], "
                f"got {syndromes.shape}"
            )
        g = self.graph
        if shot_weights is not None:
            shot_weights = np.ascontiguousarray(shot_weights, dtype=np.uint8)
            if shot_weights.shape != (syndromes.shape[0], g.num_edges):
                raise ValueError("shot_weights must be [B, num_edges]")
        if self.use_native:
            out = native.uf_decode_batch_native(
                g.edges, g.edge_qubit, g.edge_obs, g.edge_weight,
                g.num_nodes, g.n_qubits,
                syndromes, want_corrections, n_threads, shot_weights,
            )
            if out is not None:
                return out
        return _decode_batch_py(g, syndromes, want_corrections, shot_weights)


# -- Monte-Carlo harness -------------------------------------------------------


@partial(jax.jit, static_argnames=("batch",))
def _sample_and_extract(key, p, batch, h2, h1, lz, lx):
    """Device side of the UF pipeline: sample depolarizing errors, extract
    both syndrome sectors, and reduce each error to its logical parities —
    only [B, r] bits + [B] parities cross the host boundary."""
    from qcss_tpu.decode.montecarlo import sample_depolarizing

    x_err, z_err = sample_depolarizing(key, batch, h2.shape[1], p)
    syn_x = gf2_jax.syndromes_dense(x_err, h2)
    syn_z = gf2_jax.syndromes_dense(z_err, h1)
    par_x = gf2_jax.mod2_matmul(x_err, lz.T)  # [B, k]
    par_z = gf2_jax.mod2_matmul(z_err, lx.T)
    return syn_x, syn_z, par_x, par_z


def _pack_parity(par: np.ndarray) -> np.ndarray:
    """[B, k] 0/1 -> [B] uint32 bitmask matching `edge_obs` bit order."""
    k = par.shape[1]
    weights = (1 << np.arange(k, dtype=np.uint32)).astype(np.uint32)
    return (par.astype(np.uint32) @ weights).astype(np.uint32)


@partial(jax.jit, static_argnames=("batch", "rounds"))
def _sample_phenomenological(key, p, q, batch, rounds, h, lz):
    """Device side of the multi-round pipeline: rounds+1 layers of IID X
    errors (layer t arises before measurement round t; layer `rounds`
    before the perfect final readout), measurement flips with probability
    q on each of the `rounds` noisy syndrome extractions. Returns
    (detector histories [B, (rounds+1)*r], logical parities [B, k])."""
    n = h.shape[1]
    r = h.shape[0]
    ke, kf = jax.random.split(key)
    errs = (
        jax.random.uniform(ke, (rounds + 1, batch, n)) < p
    ).astype(jnp.uint8)
    flips = (
        jax.random.uniform(kf, (rounds, batch, r)) < q
    ).astype(jnp.uint8)
    cum = jnp.cumsum(errs.astype(jnp.int32), axis=0).astype(jnp.uint8) & 1
    syns = [gf2_jax.syndromes_dense(cum[t], h) ^ flips[t] for t in range(rounds)]
    final = gf2_jax.syndromes_dense(cum[rounds], h)
    dets = [syns[0]]
    for t in range(1, rounds):
        dets.append(syns[t] ^ syns[t - 1])
    dets.append(final ^ syns[rounds - 1])
    detectors = jnp.concatenate(dets, axis=-1)
    par = gf2_jax.mod2_matmul(cum[rounds], lz.T)
    return detectors, par


def uf_phenomenological_error_rate(
    code,
    p,
    q=None,
    *,
    rounds: int | None = None,
    samples: int = 1 << 14,
    batch: int = 1 << 14,
    seed: int = 0,
    n_threads: int | None = None,
    use_native: bool | None = None,
    weighted: bool = False,
) -> dict[str, float]:
    """Multi-round phenomenological X-memory logical error rate, decoded
    with spacetime union-find — the standard 'threshold with measurement
    errors' benchmark (crossing near p ≈ 2.5-3% for p=q on surface codes).
    `rounds` defaults to the code distance (via t); `q` defaults to p.
    ``weighted=True`` grows edges at -log-likelihood pace (helps when
    p and q differ substantially)."""
    h = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if rounds is None:
        rounds = 2 * code.t + 1
    q = p if q is None else q
    if weighted:
        graph = spacetime_graph(h, lz, rounds, p_space=p, p_time=q)
    else:
        graph = spacetime_graph(h, lz, rounds)
    dec = UFDecoder(graph, use_native=use_native)
    h_j = jnp.asarray(h, jnp.uint8)
    lz_j = jnp.asarray(lz, jnp.uint8)

    n_rounds = -(-samples // batch)
    keys = jax.random.split(jax.random.key(seed), n_rounds)
    fails = 0
    # Double-buffer: dispatch the next device batch (async under jit)
    # before the host decodes the current one, so device sampling and the
    # threaded host decoder overlap.
    pending = _sample_phenomenological(
        keys[0], jnp.float32(p), jnp.float32(q), batch, rounds, h_j, lz_j)
    for i in range(n_rounds):
        dets, par = pending
        if i + 1 < n_rounds:
            pending = _sample_phenomenological(
                keys[i + 1], jnp.float32(p), jnp.float32(q), batch, rounds,
                h_j, lz_j)
        _, obs = dec.decode_batch(np.asarray(dets), want_corrections=False,
                                  n_threads=n_threads)
        fails += int(np.sum(obs != _pack_parity(np.asarray(par))))
    n_samples = n_rounds * batch
    return {
        "logical_fail": fails / n_samples,
        "samples": n_samples,
        "rounds": rounds,
        "p": p,
        "q": q,
    }


def uf_logical_error_rate(
    code,
    p,
    *,
    samples: int = 1 << 16,
    batch: int = 1 << 16,
    seed: int = 0,
    n_threads: int | None = None,
    use_native: bool | None = None,
) -> dict[str, float]:
    """Code-capacity logical error rate under depolarizing noise, decoded
    with union-find — same statistical contract as
    `decode.montecarlo.logical_error_rate`, but with no LUT scaling wall:
    surface codes decode at any distance."""
    # Matching needs the local (pre-row-reduction) checks; the standard-form
    # matrices the LUT path uses are row-combined and not matchable.
    h2_raw = code.raw_parity_check_c2
    h1_raw = code.raw_parity_check_c1
    gx = graph_from_checks(h2_raw, code.z_operator_matrix())
    gz = graph_from_checks(h1_raw, code.x_operator_matrix())
    dec_x = UFDecoder(gx, use_native=use_native)
    dec_z = UFDecoder(gz, use_native=use_native)

    rounds = -(-samples // batch)
    keys = jax.random.split(jax.random.key(seed), rounds)
    fails = {"x_fail": 0, "z_fail": 0, "word_fail": 0}
    h2_j = jnp.asarray(h2_raw, jnp.uint8)
    h1_j = jnp.asarray(h1_raw, jnp.uint8)
    lz_j = jnp.asarray(code.z_operator_matrix(), jnp.uint8)
    lx_j = jnp.asarray(code.x_operator_matrix(), jnp.uint8)
    # Double-buffer: next device batch dispatches before the host decode
    # of the current one (device sampling overlaps the threaded decoder).
    pending = _sample_and_extract(
        keys[0], jnp.float32(p), batch, h2_j, h1_j, lz_j, lx_j)
    for i in range(rounds):
        cur = pending
        if i + 1 < rounds:
            pending = _sample_and_extract(
                keys[i + 1], jnp.float32(p), batch, h2_j, h1_j, lz_j, lx_j)
        syn_x, syn_z, par_x, par_z = map(np.asarray, cur)
        _, obs_x = dec_x.decode_batch(syn_x, want_corrections=False,
                                      n_threads=n_threads)
        _, obs_z = dec_z.decode_batch(syn_z, want_corrections=False,
                                      n_threads=n_threads)
        xf = obs_x != _pack_parity(par_x)
        zf = obs_z != _pack_parity(par_z)
        fails["x_fail"] += int(np.sum(xf))
        fails["z_fail"] += int(np.sum(zf))
        fails["word_fail"] += int(np.sum(xf | zf))
    n_samples = rounds * batch
    out = {k: v / n_samples for k, v in fails.items()}
    out["samples"] = n_samples
    return out
