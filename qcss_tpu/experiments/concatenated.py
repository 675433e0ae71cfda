"""Two-level concatenated memory: lattice surgery as the LOGICAL-level
error-correction layer.

Level 1 is the surface-code patch (distance d, decoded per shot by the
schedule pipeline). Level 2 treats the k data patches as the qubits of
a length-k repetition code and the compiler's non-destructive
`mzz(i, i+1)` joints as its syndrome extraction: `rounds_l` sweeps of
adjacent-pair measurements, then the final transversal readouts.

The level-2 decoding problem is EXACTLY the phenomenological
repetition-code spacetime matching this framework already solves at
level 1:

  * a level-1 logical X̄ failure on patch j that happens between sweep
    r-1 and sweep r flips every later Z̄_j readout — a SPACE edge in
    detector layer r linking checks (j-1, j) (boundary at the chain
    ends), carrying observable bit j;
  * a failed mzz joint (the ancilla's own patch-level failure) flips
    that single syndrome bit — a TIME edge between layers r and r+1;
  * a level-1 failure localized in the final readout phase flips z_j
    against the last sweep — a space edge in the closure layer.

Detectors are consecutive-sweep syndrome differences plus a closure
layer comparing the last sweep against the final readouts' pair
parities — all computed from `schedule_decoded_obs`' DEVIATION record
(fault-linear observables, so the expected syndrome is identically 0
and `x` frame ops need no special-casing). The level-2 graph is a
`MatchingGraph` decoded by the same union-find kernel as level 1.

This composition is the scalability story of surgery-based
architectures (distance in TIME at the logical level), and nothing in
the reference's one-code-block world can express it (reference:
ftqc.py:42-120 — one logical qubit, no joint measurements).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.decode.uf import MatchingGraph, UFDecoder
from qcss_tpu.experiments.logical import LogicalProgram
from qcss_tpu.experiments.patches import schedule_decoded_obs


def repetition_spacetime_graph(k: int, layers: int,
                               layout: str = "chain") -> MatchingGraph:
    """Level-2 spacetime matching graph over `k` chain patches and
    `layers` detector layers of k-1 checks each (layer L-1 is the
    closure layer). Four mechanism families, all ≤ 2 detectors:

      * space edges (layer r, patch j), obs bit j — a patch flip
        between sweeps;
      * time edges (r, i)-(r+1, i) — a failed mzz joint;
      * PAIR edges (r, i-1)-(r, i+1), obs bits {i, i+1} — a residual
        level-1 logical during the mzz(i, i+1) merge window rides the
        ancilla worldline onto BOTH endpoints (check i cancels); with
        single-detector boundary signatures at the chain ends;
      * DIAGONAL edges (r, j)-(r+1, j-1), obs bit j — a patch-j flip
        WITHIN sweep r, between its two joints (joint (j-1,j) already
        measured, joint (j,j+1) not yet).

    The families were identified empirically from the failure record
    (misdecoded shots all carried pair/diagonal signatures); they are
    the dominant correlated mechanisms the mzz schedule creates beyond
    i.i.d. patch flips. Pair/diagonal edges get weight 3 vs the
    single-mechanism 2: at the chain ends a pair flip and an end-patch
    flip share ONE detector (an irreducible k=3 degeneracy), and the
    measured frequencies favor the single mechanism ~5:1 — the weights
    encode that prior, exactly like level-1 likelihood weighting."""
    if k < 2 or layers < 1:
        raise ValueError("need k >= 2 chain qubits and >= 1 layer")
    n_checks = k - 1
    node = lambda r, i: r * n_checks + i
    edges, qub, obs, wt = [], [], [], []

    def add(a, b, mask, w):
        edges.append((a, b))
        qub.append(len(qub))
        obs.append(np.uint32(mask))
        wt.append(w)

    for r in range(layers):
        for j in range(k):
            a = node(r, j - 1) if j > 0 else -1
            b = node(r, j) if j < k - 1 else -1
            add(a, b, 1 << j, 2)
        for i in range(n_checks):          # pair flip via mzz(i, i+1)
            a = node(r, i - 1) if i > 0 else -1
            b = node(r, i + 1) if i + 1 < n_checks else -1
            add(a, b, (1 << i) | (1 << (i + 1)), 3)
    for r in range(layers - 1):
        for i in range(n_checks):
            add(node(r, i), node(r + 1, i), 0, 2)
        # within-sweep diagonals: a flip on interior patch j BETWEEN its
        # two adjacent joints fires the later-measured joint this sweep
        # and the earlier-measured one next sweep. 'chain' measures
        # joints in index order (earlier = j-1); 'brickwork' measures
        # the even-indexed layer first (see _build_program)
        for j in range(1, n_checks):
            f, s = j - 1, j
            if layout == "brickwork" and (j - 1) % 2 == 1:
                f, s = j, j - 1
            add(node(r, s), node(r + 1, f), 1 << j, 3)
    return MatchingGraph(
        num_nodes=layers * n_checks,
        edges=np.asarray(edges, np.int32),
        edge_qubit=np.asarray(qub, np.int32),
        edge_obs=np.asarray(obs, np.uint32),
        n_qubits=len(qub),
        edge_weight=np.asarray(wt, np.uint8))


def _build_program(d: int, k: int, rounds_l: int, layout: str = "chain"):
    """Compile the mzz-sweep program. layout='chain' runs the k-1
    joints of each sweep sequentially on the routing-row bus;
    'brickwork' runs them as TWO parallel `mzz_layer`s (odd pairs,
    then even pairs) — the schedule a real architecture uses, with
    per-sweep phase count independent of k (fewer phases = fewer
    fault locations; pays for k >= 4). Returns (prog, model, perm)
    where perm reorders the mzz observable columns into
    (sweep, check-index) order."""
    if k < 2 or rounds_l < 1:
        raise ValueError("need k >= 2 patches and rounds_l >= 1")
    if layout not in ("chain", "brickwork"):
        raise ValueError("layout must be 'chain' or 'brickwork'")
    prog = LogicalProgram(d, k)
    order: list[int] = []
    for _ in range(rounds_l):
        if layout == "chain":
            for i in range(k - 1):
                prog.mzz(i, i + 1)
                order.append(i)
        else:
            for start in (0, 1):
                pairs = [(i, i + 1) for i in range(start, k - 1, 2)]
                if pairs:
                    prog.mzz_layer(pairs)
                    order.extend(i for i, _ in pairs)
    prog.measure()
    model = prog.build()
    # emission order: rounds_l * (k-1) mzz rows, then z0..z{k-1}
    assert model.meta["obs_names"][-k:] == [f"z{i}" for i in range(k)]
    n_checks = k - 1
    perm = np.empty(rounds_l * n_checks, np.int64)
    for j, i in enumerate(order):
        perm[(j // n_checks) * n_checks + i] = j
    return prog, model, perm


def _level2_detectors(mzz, z):
    """Detector layers from the deviation record: first-sweep raw,
    consecutive-sweep diffs, closure vs the final readouts' adjacent-
    pair parities. mzz [B, rounds_l, k-1], z [B, k] -> [B, L*(k-1)]."""
    closure = z[:, :-1] ^ z[:, 1:]
    layers = jnp.concatenate(
        [mzz[:, :1], mzz[:, 1:] ^ mzz[:, :-1],
         (mzz[:, -1] ^ closure)[:, None]], axis=1)
    return layers.reshape(mzz.shape[0], -1)


def logical_repetition_memory(d: int, k: int, rounds_l: int, p: float,
                              q: float | None = None, *,
                              batch: int = 1 << 12, seed: int = 0,
                              decoder: str = "host",
                              reps: int = 1,
                              noise=None,
                              layout: str = "chain",
                              use_native: bool | None = None) -> dict:
    """Run the two-level memory and decode BOTH levels.

    Returns word failure over the k data readouts with level-2
    correction applied (`word_fail_l2`) and without (`word_fail_l1` —
    the same shots, same schedule, mzz record ignored), plus the raw
    level-1 channel rates. Level 2 pays off when patch failures are
    likely over the program duration but the level-2 spacetime decode
    localizes them (d small / p high / rounds_l ample).

    decoder='host' decodes both levels with the C++ union-find;
    decoder='device-uf' fuses EVERYTHING — fault sampling, level-1
    detector assembly, level-1 union-find, level-2 detector assembly
    from the decoded deviation record, level-2 union-find, and failure
    counting — into ONE compiled device program (hierarchical decoding
    with only counts crossing the host boundary; `reps` re-runs the
    compiled step with fresh keys).

    Passing `noise` (a NoiseModel) runs level 1 at CIRCUIT LEVEL
    instead: real two-sector extraction circuits frame-sampled and
    BP(+OSD)-decoded (`experiments.schedule_circuit`; p/q ignored).
    The level-2 graph is unchanged — its mechanism FAMILIES are
    schedule-structural (patch flips, failed joints, merge-window pair
    rides, within-sweep diagonals), only their rates shift.

    layout='brickwork' runs each sweep's joints as TWO parallel
    `mzz_layer`s instead of the serialized routing-row bus — per-sweep
    phase count independent of k (fewer phases = fewer level-1 fault
    locations; pays for k >= 4). The level-2 graph's within-sweep
    diagonals follow the layer measurement order.
    """
    if noise is not None:
        if decoder != "host":
            raise ValueError("circuit-level two-level memory decodes "
                             "level 1 on the host BP path")
        from qcss_tpu.experiments.schedule_circuit import (
            build_circuit_schedule, circuit_decoded_obs)
    if decoder == "device-uf":
        return _device_two_level(d, k, rounds_l, p, q, batch=batch,
                                 seed=seed, reps=reps, layout=layout)
    if decoder != "host":
        raise ValueError("decoder must be 'host' or 'device-uf'")
    prog, model, perm = _build_program(d, k, rounds_l, layout)
    n_checks = k - 1
    if noise is not None:
        cmodel = build_circuit_schedule(
            prog.n, prog._phases, np.stack(prog._active), prog._obs,
            prog._conj_checks, readouts=tuple(prog._readouts),
            conjugate_init=tuple(prog._conj), noise=noise)
        vals = circuit_decoded_obs(cmodel, noise, batch=batch, seed=seed)
    else:
        vals = schedule_decoded_obs(model, p, q, batch=batch, seed=seed,
                                    use_native=use_native)
    mzz = vals[:, perm].reshape(-1, rounds_l, n_checks)
    z = vals[:, rounds_l * n_checks:]
    dets = np.asarray(_level2_detectors(jnp.asarray(mzz), jnp.asarray(z)))

    graph = repetition_spacetime_graph(k, rounds_l + 1, layout)
    dec = UFDecoder(graph, use_native=use_native)
    _, corr = dec.decode_batch(dets, want_corrections=False)
    corr_bits = (corr[:, None].astype(np.int64) >> np.arange(k)[None, :]) & 1
    z_corrected = z ^ corr_bits.astype(np.uint8)

    return {
        "d": d, "k": k, "rounds_l": rounds_l,
        "p": float(p), "q": float(p if q is None else q),
        "level": "circuit" if noise is not None else "phenomenological",
        "samples": len(vals),
        "grid_qubits": prog.n,
        "word_fail_l1": float(z.any(axis=1).mean()),
        "word_fail_l2": float(z_corrected.any(axis=1).mean()),
        "mean_z_fail_l1": float(z.mean()),
        "mean_z_fail_l2": float(z_corrected.mean()),
        "mzz_flip_rate": float(mzz.mean()),
    }


def _device_two_level(d: int, k: int, rounds_l: int, p: float,
                      q: float | None, *, batch: int, seed: int,
                      reps: int, layout: str = "chain") -> dict:
    """The fully fused hierarchical pipeline (see logical_repetition_
    memory). Level-1 obs rows pack into one int32 (the schedule device
    path's 24-row cap applies: rounds_l*(k-1) + k <= 24)."""
    from qcss_tpu.decode.device_uf import make_obs_decoder
    from qcss_tpu.experiments.patches import _sample

    q = p if q is None else q
    prog, model, perm = _build_program(d, k, rounds_l, layout)
    n_checks = k - 1
    n_obs = model.obs.shape[0]
    if n_obs > 24:
        raise ValueError("device path packs obs rows into one int32: "
                         f"rounds_l*(k-1)+k = {n_obs} > 24")
    dec1 = make_obs_decoder(model.graph)
    dec2 = make_obs_decoder(
        repetition_spacetime_graph(k, rounds_l + 1, layout))
    cls = jnp.asarray(model.fault_probs_class)
    f_t = jnp.asarray(model.F.T.astype(np.int32))
    obs_t = jnp.asarray(model.obs.T.astype(np.int32))
    bits1 = jnp.asarray(1 << np.arange(n_obs), jnp.int32)

    @jax.jit
    def step(key):
        dets, ob = _sample(key, jnp.float32(p), jnp.float32(q), batch,
                           cls, f_t, obs_t)
        flips, conv1 = dec1(dets)
        truth = (ob.astype(jnp.int32) * bits1[None, :]).sum(axis=1)
        v = flips.astype(jnp.int32) ^ truth          # deviation bitmask
        mzz = ((v[:, None] >> jnp.asarray(perm)) & 1
               ).reshape(-1, rounds_l, n_checks).astype(jnp.uint8)
        z = ((v[:, None] >> (rounds_l * n_checks + jnp.arange(k))) & 1
             ).astype(jnp.uint8)
        dets2 = _level2_detectors(mzz, z)
        flips2, conv2 = dec2(dets2)
        zbits = (v >> (rounds_l * n_checks)) & ((1 << k) - 1)
        zcorr = zbits ^ flips2.astype(jnp.int32)
        return ((zbits != 0).sum(), (zcorr != 0).sum(),
                (1 - conv1.astype(jnp.int32)).sum()
                + (1 - conv2.astype(jnp.int32)).sum())

    l1 = l2 = bad = 0
    for r in range(reps):
        a, b, c = step(jax.random.fold_in(jax.random.key(seed), r))
        l1 += int(a)
        l2 += int(b)
        bad += int(c)
    if bad:
        raise RuntimeError("device union-find hit its growth cap")
    total = batch * reps
    return {
        "d": d, "k": k, "rounds_l": rounds_l,
        "p": float(p), "q": float(q), "samples": total,
        "grid_qubits": prog.n, "decoder": "device-uf",
        "word_fail_l1": l1 / total,
        "word_fail_l2": l2 / total,
    }
