"""Physical-protocol execution of compiled logical programs on the
batched stabilizer-tableau engine.

This is the PROTOCOL, not the fault model: every phase's stabilizer
extraction rounds run as real projective measurements (data-collection
CNOTs onto dedicated Z-check ancillas; H-sandwiched fan-outs for the
X checks), transitions perform the declared scored readouts / silent
conjugate measurements / conjugate-basis initializations, and the
final word is read transversally — producing the raw outcome vector(s)
the builder's outcome-space recipes (`build(with_recipe=True)` /
`build_x(with_recipe=True)`) consume. The tableau golds in
tests/test_logical.py assert every detector combination is zero and
every observable combination matches the truth table on random
measurement branches; users can run it to sanity-check a compiled
schedule against the actual stabilizer protocol.

Performance shape (the reason this lives here rather than inline in
the tests): each round is ONE `run_circuit_scanned` pass over a
NOP-padded gate array covering every check (each check measured onto
its own ancilla), ONE `measure_many` over the padded ancilla list, and
ONE data-dependent conditional-X reset pass — three fixed-shape
executables per round instead of ~three per CHECK. The per-int-index
tableau forms would both dispatch one executable per (op, qubit) and trip the
XLA:CPU in-process executable-count segfault edge documented in
tests/conftest.py on >=77-qubit grids.

The reference has no multi-patch machinery and its only protocol
runner is the external QVM process (reference: ftqc.py:42-120).
"""

from __future__ import annotations

import numpy as np


def run_compiled_protocol(prog, model, rng_key, *, prep_x_flips=(),
                          skip_h_phases=(), x_model=None,
                          final_basis="z", premeasure_x=None):
    """Run a `LogicalProgram`'s compiled schedule projectively.

    Returns the raw outcome vector in `model`'s recipe order. With
    `x_model` (a `build_x(with_recipe=True)` model) the SAME run also
    measures every phase's X checks and the X-basis measure-outs,
    returning `(outcomes, outcomes_x, pre)`; `final_basis='x'` reads
    the final word transversally in X (the X recipe's boundary
    convention — the Z recipe's final slots are then meaningless).
    `premeasure_x` is an optional `(phase, support)`: measure that
    X-type operator projectively at the start of the phase (after its
    conjugate inits) and return the outcome in `pre` — the reference
    value for preserved X products like the T gadget's X̄_D X̄_M.
    """
    import jax

    from qcss_tpu.experiments import surgery
    from qcss_tpu.sim import tableau as tb

    # drop executables accumulated earlier in this process: the XLA:CPU
    # compiler segfaults past an in-process executable count
    # (tests/conftest.py documents the edge)
    jax.clear_caches()

    n = prog.n
    rz_max = max(ph.checks.shape[0] for ph in prog._phases)
    rx_max = max(h.shape[0] for h in prog._conj_checks)
    anc_z, anc_x = n, n + rz_max
    measure_x_checks = x_model is not None

    recipe = model.meta["recipe"]
    n_meas, n_read = recipe["n_meas"], recipe["n_read"]
    outcomes = np.zeros(n_meas + n_read + n, np.uint8)
    meas_pos = {k: i for i, k in enumerate(recipe["meas_order"])}
    read_pos = {k: i for i, k in enumerate(recipe["read_order"])}

    outcomes_x = None
    meas_pos_x = read_pos_x = None
    pre: list[int] = []
    if x_model is not None:
        recipe_x = x_model.meta["recipe"]
        outcomes_x = np.zeros(recipe_x["n_meas"] + recipe_x["n_read"] + n,
                              np.uint8)
        meas_pos_x = {k: i for i, k in enumerate(recipe_x["meas_order"])}
        read_pos_x = {k: i for i, k in enumerate(recipe_x["read_order"])}

    key_box = [rng_key]

    def nk():
        key_box[0], k = jax.random.split(key_box[0])
        return k

    t = tb.zero_state(1, n + rz_max + rx_max)

    # transversal-H frame ops rotate patches mid-program: from the
    # recorded boundary on, the Z-sector model's rows on those qubits
    # are PHYSICALLY X-type operators (and the X-sector's rows Z-type)
    # — see LogicalProgram.h. rot_phase[ph, q] = 1 when qubit q is
    # rotated during phase ph; rot_phase[n_ph] is the end state.
    frame_ops = model.meta.get("frame_ops")
    n_ph_total = len(prog._phases)
    rot_phase = np.zeros((n_ph_total + 1, n), np.uint8)
    if frame_ops:
        for kind, b, qubits in frame_ops:
            if kind == "h":
                rot_phase[b:, list(qubits)] ^= 1

    # -- per-phase round programs (NOP-padded to shared shapes) -----------
    # X and Z extraction run as SEPARATE segments (scan + measure +
    # reset each): within a segment the parallel per-check circuits
    # measure exactly their check operators (distinct ancillas;
    # same-segment CNOTs on a shared data qubit commute through each
    # other's measured chains), but a Z-collect and an X-fan-out on the
    # same data qubit do not — interleaving them in one pre-measurement
    # scan would contaminate the measured operators.
    def segment_arrays(ph, sector):
        ops, q0, q1 = [], [], []
        h = prog._phases[ph].checks if sector == "z" \
            else prog._conj_checks[ph]
        base = anc_z if sector == "z" else anc_x
        rot = rot_phase[ph]
        for c in range(h.shape[0]):
            sup = np.nonzero(h[c])[0]
            r = bool(rot[sup].any())
            if r:
                assert rot[sup].all(), \
                    "check row straddles a rotation boundary"
            # a rotated patch's Z-sector rows are X-type measurements
            # (and vice versa); unrotated rows keep their sector type
            as_x = (sector == "z") == r
            a = base + c
            if as_x:
                ops.append(4)                  # H sandwich
                q0.append(a)
                q1.append(0)
                for j in sup:
                    ops.append(6)              # CNOT X ancilla -> data
                    q0.append(a)
                    q1.append(int(j))
                ops.append(4)
                q0.append(a)
                q1.append(0)
            else:
                for j in sup:
                    ops.append(6)              # CNOT data -> Z ancilla
                    q0.append(int(j))
                    q1.append(a)
        ancs = [base + c for c in range(h.shape[0])]
        return ops, q0, q1, ancs

    sectors = ("x", "z") if measure_x_checks else ("z",)
    per_phase = {s: [segment_arrays(ph, s)
                     for ph in range(len(prog._phases))] for s in sectors}
    max_ops = max(len(p[0]) for s in sectors for p in per_phase[s])
    max_anc = max(len(p[3]) for s in sectors for p in per_phase[s])
    padded = {}
    for s in sectors:
        rows = []
        for ops, q0, q1, ancs in per_phase[s]:
            pad = max_ops - len(ops)
            arrs = (np.asarray(ops + [0] * pad, np.int32),
                    np.asarray(q0 + [0] * pad, np.int32),
                    np.asarray(q1 + [0] * pad, np.int32))
            # pad the measurement list by re-measuring the last ancilla
            # (deterministic repeat; the extra outcomes are discarded)
            mlist = ancs + [ancs[-1]] * (max_anc - len(ancs))
            rows.append((arrs, np.asarray(mlist, np.int32), len(ancs)))
        padded[s] = rows

    def run_segment(ph, sector):
        nonlocal t
        (ops_a, q0_a, q1_a), mlist, n_real = padded[sector][ph]
        t = tb.run_circuit_scanned(t, ops_a, q0_a, q1_a)
        t, outs = tb.measure_many(t, mlist, nk())
        outs = np.asarray(outs)[0]
        # conditional ancilla reset: one scanned X-or-NOP pass keyed on
        # each ancilla's FIRST outcome (padded repeats excluded)
        r_ops = np.zeros(max_anc, np.int32)
        r_ops[:n_real] = np.where(outs[:n_real] > 0, 1, 0)
        t = tb.run_circuit_scanned(t, r_ops, mlist,
                                   np.zeros(max_anc, np.int32))
        return outs

    def measure_in_z(qubits, reset_to_zero=True):
        """Batched scored-basis readout: measure, conditionally X back."""
        nonlocal t
        q = np.asarray(qubits, np.int32)
        t, outs = tb.measure_many(t, q, nk())
        outs = np.asarray(outs)[0]
        if reset_to_zero:
            t = tb.run_circuit_scanned(
                t, np.where(outs > 0, 1, 0).astype(np.int32), q,
                np.zeros(len(q), np.int32))
        return outs

    def measure_in_x(qubits):
        """Batched conjugate-basis measure-out: H, measure, X-reset."""
        nonlocal t
        q = np.asarray(qubits, np.int32)
        t = tb.apply_h_many(t, q)
        t, outs = tb.measure_many(t, q, nk())
        outs = np.asarray(outs)[0]
        t = tb.run_circuit_scanned(
            t, np.where(outs > 0, 1, 0).astype(np.int32), q,
            np.zeros(len(q), np.int32))
        return outs

    def measure_x_op(support):
        """One X-type operator projectively via the first Z ancilla."""
        nonlocal t
        sup = [int(qb) for qb in np.nonzero(support)[0]]
        ops = [4] + [6] * len(sup) + [4]
        q0 = [anc_z] + [anc_z] * len(sup) + [anc_z]
        q1 = [0] + sup + [0]
        t = tb.run_circuit_scanned(t, np.asarray(ops, np.int32),
                                   np.asarray(q0, np.int32),
                                   np.asarray(q1, np.int32))
        out = measure_in_z([anc_z])
        return int(out[0])

    def measure_z_op(support):
        """One Z-type operator projectively via the first Z ancilla."""
        nonlocal t
        sup = [int(qb) for qb in np.nonzero(support)[0]]
        ops = [6] * len(sup)
        q0 = sup
        q1 = [anc_z] * len(sup)
        t = tb.run_circuit_scanned(t, np.asarray(ops, np.int32),
                                   np.asarray(q0, np.int32),
                                   np.asarray(q1, np.int32))
        out = measure_in_z([anc_z])
        return int(out[0])

    def prep_encoded_plus(ph, qubits, with_h=True):
        """Encoded-arrival prep of a fresh block (LogicalProgram._prep
        encoded=True): transversal H to |+⟩^⊗n (X checks +1), then
        project the phase's Z checks on the block and apply the GF(2)
        X-type fixup so they all read +1 — an encoded |+̄⟩ with EVERY
        stabilizer deterministic, the state an injection factory hands
        over. with_h=False skips the H (the Z-definite |0̄⟩ stand-in:
        Z checks already +1, then the X-check projection + Z fixup
        makes it encoded |0̄⟩)."""
        nonlocal t
        qset = set(int(qb) for qb in qubits)
        if with_h:
            t = tb.apply_h_many(t, np.asarray(sorted(qset), np.int32))
            h = prog._phases[ph].checks
            rows = [c for c in range(h.shape[0])
                    if h[c].any() and set(np.nonzero(h[c])[0]) <= qset]
            outs = [measure_z_op(h[c]) for c in rows]
            fix = surgery._solve_gf2(h[rows].T,
                                     np.asarray(outs, np.uint8))
            assert fix is not None
            if fix.any():
                t = tb.apply_x_many(t,
                                    np.nonzero(fix)[0].astype(np.int32))
        else:
            h = prog._conj_checks[ph]
            rows = [c for c in range(h.shape[0])
                    if h[c].any() and set(np.nonzero(h[c])[0]) <= qset]
            outs = [measure_x_op(h[c]) for c in rows]
            fix = surgery._solve_gf2(h[rows].T,
                                     np.asarray(outs, np.uint8))
            assert fix is not None
            if fix.any():
                t = tb.apply_z_many(t,
                                    np.nonzero(fix)[0].astype(np.int32))

    # -- data preparation: |0...0⟩, X checks projected with Z fixups ------
    # phase 0's conjugate check set IS the per-patch X checks; one round
    # of it yields every patch's projection outcomes at once
    hx0 = prog._conj_checks[0]
    outs0 = []
    for c in range(hx0.shape[0]):
        outs0.append(measure_x_op(hx0[c]))
    # per-patch GF(2) fixup so every X check starts +1
    fix = surgery._solve_gf2(hx0.T, np.asarray(outs0, np.uint8))
    assert fix is not None
    if fix.any():
        t = tb.apply_z_many(t, np.nonzero(fix)[0].astype(np.int32))
    if prep_x_flips:
        t = tb.apply_x_many(t, np.asarray(prep_x_flips, np.int32))

    # frame ops (x/z/h chains) by boundary, in program order; legacy
    # models without frame_ops meta fall back to x_ops
    fops_at: dict[int, list] = {}
    if frame_ops is not None:
        for kind, b, qubits in frame_ops:
            fops_at.setdefault(b, []).append((kind, qubits))
    else:
        for phx, chain in model.meta.get("x_ops", []):
            fops_at.setdefault(phx, []).append(("x", chain))

    def apply_frame_ops(ph):
        nonlocal t
        for kind, qubits in fops_at.get(ph, ()):
            qa = np.asarray(sorted(qubits), np.int32)
            if kind == "x":
                t = tb.apply_x_many(t, qa)
            elif kind == "z":
                t = tb.apply_z_many(t, qa)
            elif kind == "h":
                t = tb.apply_h_many(t, qa)
            else:
                raise ValueError(f"unknown frame op {kind!r}")
    conj_at: dict[int, list] = {}
    for ci in prog._conj:
        conj_at.setdefault(ci.phase, []).extend(ci.qubits)
    enc_at: dict[int, list] = {}
    for ei in getattr(prog, "_enc_init", ()):
        enc_at.setdefault(ei.phase, []).extend(ei.qubits)
    reads_at: dict[int, list] = {}
    for ro in prog._readouts:
        reads_at.setdefault(ro.phase, []).extend(ro.qubits)

    active = np.stack(prog._active)
    starts = np.concatenate(
        [[0], np.cumsum([ph.rounds for ph in prog._phases])])
    n_ph = len(prog._phases)
    for ph in range(n_ph):
        if ph > 0:
            gone = np.nonzero(active[ph - 1] & (1 - active[ph]))[0]
            # mid-program measure-outs of rotated patches are not
            # modeled (gadgets require even H parity)
            assert not rot_phase[ph - 1][gone].any(), \
                "transition readout touches a rotated patch"
            scored = sorted(set(reads_at.get(ph, [])))
            if scored:
                outs = measure_in_z(scored)
                for qb, b in zip(scored, outs):
                    outcomes[n_meas + read_pos[(ph, int(qb))]] = b
            silent = [int(qb) for qb in gone if int(qb) not in set(scored)]
            if silent:
                outs = measure_in_x(silent)
                for qb, b in zip(silent, outs):
                    if read_pos_x is not None and (ph, qb) in read_pos_x:
                        outcomes_x[recipe_x["n_meas"]
                                   + read_pos_x[(ph, qb)]] = b
        # conjugate-basis initializations of this phase (fresh |+⟩)
        if ph in conj_at and ph not in skip_h_phases:
            t = tb.apply_h_many(t, np.asarray(sorted(conj_at[ph]),
                                              np.int32))
        # encoded-arrival blocks: |+̄⟩ with every stabilizer projected
        # deterministic (skip_h_phases selects the |0̄⟩ stand-in)
        if ph in enc_at:
            prep_encoded_plus(ph, enc_at[ph],
                              with_h=ph not in skip_h_phases)
        # program-order frame ops (x/z chains, transversal h) landing
        # at this boundary
        apply_frame_ops(ph)
        if premeasure_x is not None and premeasure_x[0] == ph:
            pre.append(measure_x_op(premeasure_x[1]))
        rz = prog._phases[ph].checks.shape[0]
        for tt in range(prog._phases[ph].rounds):
            t_global = int(starts[ph]) + tt
            if measure_x_checks:
                outs_x = run_segment(ph, "x")
                for c in range(prog._conj_checks[ph].shape[0]):
                    outcomes_x[meas_pos_x[(ph, t_global, c)]] = outs_x[c]
            outs = run_segment(ph, "z")
            for c in range(rz):
                outcomes[meas_pos[(ph, t_global, c)]] = outs[c]
    apply_frame_ops(n_ph)   # frame ops trailing the last emitted phase
    fin_qubits = [int(qb) for qb in np.nonzero(active[-1])[0]]
    # final transversal readout basis PER QUBIT: H-then-Z-measure when
    # (rotated at the end) XOR (the evaluated recipe closes in X) — a
    # rotated patch's REAL Z word closes the X-sector recipe, while the
    # Z-sector recipe's (fictitious) closure for it needs the X basis,
    # exactly mirroring the unrotated convention.
    rot_end = rot_phase[n_ph_total]
    hq = [qb for qb in fin_qubits
          if bool(rot_end[qb]) != (final_basis == "x")]
    if hq:
        t = tb.apply_h_many(t, np.asarray(hq, np.int32))
    t, word = tb.measure_many(t, np.asarray(fin_qubits, np.int32), nk())
    word = np.asarray(word)[0]
    for qb, b in zip(fin_qubits, word):
        outcomes[n_meas + n_read + qb] = b
        if outcomes_x is not None and final_basis == "x":
            outcomes_x[recipe_x["n_meas"] + recipe_x["n_read"] + qb] = b
    if x_model is not None:
        return outcomes, outcomes_x, pre
    return outcomes
