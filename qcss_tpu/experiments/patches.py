"""Declarative multi-patch surgery schedules — the generic layer under
the bespoke lattice-surgery experiments.

`experiments.surgery` and `experiments.surgery_t` each hand-assemble one
fault model: phase check sets, qubit activation windows, partner-matched
transition detectors, seam-readout closures, GF(2)-solved joint-
measurement combinations. This module is that machinery ONCE, as a
declarative builder: a `PatchSchedule` lists the phases (check matrix +
rounds), per-phase qubit activity, scored-basis readout events, and the
observables (final logicals, joint measurements, readout bits, XOR
combos) — `build_schedule` mechanizes the rest by single-fault
propagation, exactly the construction the bespoke builders use
(validated by bit-identity: tests/test_patches.py re-derives the
merge-split cycle, the surgery CNOT and both T-gadget sectors through
this builder and asserts F/obs/graph equal the bespoke outputs
column-for-column).

What the declarative form buys is COMPOSITION: schedules that no
bespoke builder exists for — sequential joint measurements sharing a
patch, seam reuse, logical-level parity-check networks — assemble in a
few lines and inherit every build-time guard (weight ≤ 2 per fault,
signature-sharing observable consistency, no undetectable logical
fault). `parity_chain_model` below measures Z̄ᵢZ̄ᵢ₊₁ down a column of
patches — the logical-level repetition-code syndrome network, i.e.
surgery as the EC layer OF logical qubits — and is tableau-gold-tested
for every input in tests/test_patches.py.

Semantics notes (the physics the asserts enforce, learned building the
bespoke models — see surgery.build_surgery_cnot and surgery_t
docstrings):
  * a transition detector exists for every new-phase check whose
    restriction to the persistently-active qubits equals exactly one
    previous-phase check (partner matching); genuinely new checks get
    none (projection randomness);
  * when qubits are measured out in the SCORED basis at a split, their
    readout bits are fault locations of their own and close the
    extended partner transitions;
  * `mode='even'` joint combinations solve the UNMASKED check system,
    so they have even support on every seam qubit — deterministic for
    ANY seam initialization; `mode='masked'` solves off-seam and is
    valid only when the seam init basis matches the measured product.

The reference has no multi-patch machinery of any kind (its scope is a
single code block; reference: ftqc.py:42-120).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.codes import families
from qcss_tpu.decode.uf import MatchingGraph, UFDecoder
from qcss_tpu.experiments.surgery import (
    _graph_from_signatures,
    _sample,
    _solve_gf2,
)


@dataclass(frozen=True)
class Phase:
    """One schedule phase: `rounds` extraction rounds of `checks`.

    `checks` is the [r, n] GF(2) incidence of the SCORED sector's
    stabilizers active during the phase (Z checks for an X-error model
    and vice versa)."""

    checks: np.ndarray
    rounds: int


@dataclass(frozen=True)
class Readout:
    """Qubits measured out in the scored basis at the transition INTO
    `phase` (a split). Their readout bits are fault locations and close
    the extended-check transition detectors; order fixes bit order."""

    phase: int
    qubits: tuple[int, ...]


@dataclass(frozen=True)
class ScheduleModel:
    """Assembled fault model: F/obs linear maps + the matching graph."""

    n: int
    n_phases: int
    fault_probs_class: np.ndarray  # [nf] 0 = data (rate p), 1 = meas/read (q)
    F: np.ndarray                  # [n_dets, nf]
    obs: np.ndarray                # [n_obs, nf]
    graph: MatchingGraph
    meta: dict = field(default_factory=dict)


def logical(support: np.ndarray) -> tuple:
    """Observable term: the final transversal readout of `support`."""
    return ("logical", np.asarray(support, dtype=np.uint8))


def joint(phase: int, target: np.ndarray, mode: str = "even",
          ref: str = "last", mref: str | int = "first") -> tuple:
    """Observable term: the joint measurement a merge performs — the
    GF(2)-solved combination of the new phase's `mref`-round and the
    previous phase's `ref`-round outcomes whose product is `target`.

    mode='even' solves over the UNMASKED system (even seam support —
    deterministic for any seam init, immune to seam-init errors);
    mode='masked' solves the off-seam restriction (only valid when the
    seam initializes in the measured product's basis).

    ref picks WHICH previous-phase round the classical combination
    reads — a protocol choice that induces its own fault model (the
    consistency guards verify whichever is chosen). 'last' (default,
    the bespoke builders' convention) is right for long-lived Z-definite
    patches; 'first' anchors at the projection round and is the
    consistent choice when the previous phase freshly prepared a
    conjugate-basis patch whose m outcome is consumed STANDALONE (the
    compiled T gadget: with 'last', a data error mid-prep and a
    first-round measurement flip share one detector but differ on m —
    an irreducible degeneracy the guard catches); 'mid' reads the
    middle round — on a freshly prepared conjugate patch the round-0
    outcomes are projection-random SINGLE-detector events (no entry
    comparison), so 'first' leaves each read check one measurement
    flip away from an unprotected m flip (fault distance 3 at any d —
    the round-4 flattening); 'mid' keeps the standalone-consumption
    consistency of 'first' while reading outcomes protected by
    difference detectors on both sides.

    mref picks which MERGED-phase round the combination reads: 'first'
    (round 0 — the bespoke builders' convention), 'mid' (rounds // 2),
    or an explicit round index. Any round is noiselessly identical
    (stabilizer outcomes persist after the projection), but the FAULT
    models differ: at round 0 the new seam checks have no entry
    comparison (projection randomness), so a seam-check measurement
    flip directly flips m while firing a single detector — a per-seam-
    check weight-3 undetectable-logical configuration that pins the m
    channel's fault distance at 3 regardless of d (the round-4 op-set
    ladder's d=5→7 flattening; measured by
    `decode.fault_distance.observable_fault_distance`). 'mid' anchors
    the read deep in the decoded window where every outcome is
    protected by difference detectors on both sides, restoring
    distance scaling. Kept 'first' by default so the bespoke models'
    bit-identity is untouched; the logical compiler passes 'mid'."""
    if mode not in ("even", "masked"):
        raise ValueError("joint mode must be 'even' or 'masked'")
    if ref not in ("last", "first", "mid"):
        raise ValueError("joint ref must be 'last', 'first' or 'mid'")
    if not (mref in ("first", "mid") or isinstance(mref, int)):
        raise ValueError("joint mref must be 'first', 'mid' or an int")
    return ("joint", phase, np.asarray(target, dtype=np.uint8), mode, ref,
            mref)


def readout_bit(phase: int, qubit: int) -> tuple:
    """Observable term: one scored-basis readout bit of a split."""
    return ("readout", phase, qubit)


def readout_logical(phase: int, support: np.ndarray) -> tuple:
    """Observable term: a logical operator evaluated from the scored-
    basis readout bits of the transition into `phase` (e.g. M_A = Z̄_A
    of an ancilla patch measured out transversally mid-program). Every
    support qubit must be read out at that transition."""
    return ("readout_logical", phase, np.asarray(support, dtype=np.uint8))


def logical_at(phase: int, support: np.ndarray) -> tuple:
    """Observable term: the scored-sector logical `support` ANCHORED at
    the transition into `phase` — flipped by data faults that occur
    STRICTLY before the anchor (slot < the phase's first round) and are
    still live on their qubit there. Needed for frame-consumption
    channels: when a mid-program readout fixes a software correction
    (the T gadget's M_X-conditioned Z̄ frame), faults after the anchor
    can no longer corrupt it, so the final-boundary `logical` term
    over-counts them. Support qubits must stay active from the anchor
    to the schedule end.

    The anchor must sit at a temporal boundary that is physically
    closed (deterministic raw detectors); bounding the window from
    BELOW mid-chain is NOT expressible: a window-start cut books a
    transient conjugate pair straddling it as odd although the pair is
    physically harmless (the per-fault rows are linear; the transient's
    cancellation is pairwise), which fakes weight-4 odd cycles — found
    deriving round 5's op-set fix, where the real cure was closing the
    birth boundary itself (LogicalProgram data_init='encoded' /
    `_prep(encoded=True)`), not windowing the anchor.

    In the outcome-space recipe (`with_recipe=True`) this term falls
    back to the FINAL transversal readout row — exact for noiseless
    golds (no fault ever separates the anchor from the final value) but
    NOT a valid fault-placement map for circuit-tier consumers; the
    builder marks the recipe accordingly (`recipe['has_anchored']`)."""
    return ("logical_at", phase, np.asarray(support, dtype=np.uint8))


def build_schedule(n: int, phases: list[Phase], active: np.ndarray,
                   observables: list[list[tuple]],
                   readouts: tuple[Readout, ...] = (),
                   conjugate_init: tuple[Readout, ...] = (),
                   p: float | None = None,
                   q: float | None = None,
                   with_recipe: bool = False) -> ScheduleModel:
    """Mechanize a patch schedule into its single-fault model.

    `active` is [n_phases, n]: which qubits participate in each phase.
    Every fault — one scored-sector error per active qubit per time slot
    (slot t errors precede round t's measurements; init and pre-readout
    boundary slots included), one flip per check measurement, one per
    readout bit — is propagated through the outcome linear model into
    detector/observable incidences, exactly the construction the bespoke
    surgery builders use. Build-time guards: every fault must flip ≤ 2
    detectors, signature-sharing faults must agree on observables, and
    no undetectable fault may touch an observable.

    Deactivation/initialization semantics (what makes mid-program patch
    measurement and patch MOVEMENT expressible):
      * qubits deactivated WITH a scored-basis `Readout`: their bits are
        fault locations, close extended partner transitions, and old
        checks FULLY supported on them get closure detectors
        (last-round outcome vs the readout-bit parity) — this is how an
        ancilla patch measured out transversally mid-program keeps its
        final EC round protected;
      * qubits deactivated SILENTLY (conjugate-basis measurement, which
        the scored sector cannot see): any matched transition detector
        whose OLD check touches them is dropped — the conjugate readout
        randomizes the comparison (projection), keeping it would be a
        wrong detector;
      * qubits listed in `conjugate_init` (activated in the conjugate
        basis): matched transition detectors whose NEW check touches
        them are dropped, and phase-0 first-round raw detectors touching
        them are dropped — scored-basis initialization (the default) is
        what makes those rows deterministic.
    """
    n_ph = len(phases)
    active = np.asarray(active, dtype=np.uint8)
    if active.shape != (n_ph, n):
        raise ValueError(f"active must be [{n_ph}, {n}]")
    for ph, P in enumerate(phases):
        if P.rounds < 1:
            raise ValueError("every phase needs >= 1 round")
        if P.checks.shape[1] != n:
            raise ValueError("check matrix width != n")
        if (P.checks & (1 - active[ph])[None, :]).any():
            raise AssertionError(
                f"phase {ph} has checks on inactive qubits")
    starts = np.concatenate([[0], np.cumsum([P.rounds for P in phases])])
    total = int(starts[-1])

    # readout index map ------------------------------------------------------
    read_idx: dict[tuple[int, int], int] = {}
    for ro in readouts:
        if not (1 <= ro.phase < n_ph):
            raise ValueError("readout phase out of range (the final "
                             "transversal readout is implicit)")
        for qb in ro.qubits:
            if active[ro.phase, qb]:
                raise AssertionError(
                    f"readout qubit {qb} still active in phase {ro.phase}")
            if not active[ro.phase - 1, qb]:
                raise AssertionError(
                    f"readout qubit {qb} not active before phase {ro.phase}")
            if (ro.phase, qb) in read_idx:
                raise ValueError("duplicate readout qubit")
            read_idx[(ro.phase, qb)] = len(read_idx)
    n_read = len(read_idx)

    # conjugate-basis initializations -----------------------------------------
    conj_init_at: dict[int, set[int]] = {}
    for ci in conjugate_init:
        if not (0 <= ci.phase < n_ph):
            raise ValueError("conjugate_init phase out of range")
        for qb in ci.qubits:
            if not active[ci.phase, qb]:
                raise AssertionError(
                    f"conjugate-init qubit {qb} inactive in phase {ci.phase}")
            if ci.phase > 0 and active[ci.phase - 1, qb]:
                raise AssertionError(
                    f"conjugate-init qubit {qb} was already active")
            conj_init_at.setdefault(ci.phase, set()).add(qb)

    # silent deactivations (no scored readout): the conjugate-basis
    # measurement randomizes any old check extending over them
    silent_at: dict[int, set[int]] = {}
    for ph in range(1, n_ph):
        gone = np.nonzero(active[ph - 1] & (1 - active[ph]))[0]
        sil = {int(qb) for qb in gone if (ph, int(qb)) not in read_idx}
        if sil:
            silent_at[ph] = sil

    # per-qubit activity intervals -------------------------------------------
    # each interval: (ph_a, ph_b, slot_end_exclusive, read_index | None,
    #                 reaches_final)
    intervals: list[list[tuple]] = [[] for _ in range(n)]
    for qb in range(n):
        ph = 0
        while ph < n_ph:
            if not active[ph, qb]:
                ph += 1
                continue
            ph_a = ph
            while ph + 1 < n_ph and active[ph + 1, qb]:
                ph += 1
            ph_b = ph
            reaches_final = ph_b == n_ph - 1
            ridx = read_idx.get((ph_b + 1, qb))
            end = int(starts[ph_b + 1])
            # boundary slot: before the perfect final readout, or before
            # a scored-basis readout (flips only the readout bit)
            if reaches_final or ridx is not None:
                end += 1
            intervals[qb].append((ph_a, ph_b, end, ridx, reaches_final))
            ph += 1

    # fault inventory (orderings match the bespoke builders) -----------------
    # A conjugate-init qubit has NO fault slot at its activation time:
    # a scored-sector error on the freshly prepared conjugate eigenstate
    # is the identity (X|+⟩ = |+⟩ for a Z-scored model) — the projection
    # coin has not been tossed yet, so booking it would over-count a
    # branch relabel as a logical deviation (it surfaced as a false
    # undetectable-m1 fault in the compiled T gadget).
    slot_int: dict[tuple[int, int], tuple] = {}
    for qb in range(n):
        for iv in intervals[qb]:
            t_first = int(starts[iv[0]])
            if qb in conj_init_at.get(iv[0], ()):
                t_first += 1
            for t in range(t_first, iv[2]):
                slot_int[(t, qb)] = iv
    data_faults = [(t, qb) for t in range(total + 1) for qb in range(n)
                   if (t, qb) in slot_int]
    meas_faults = [(ph, t, c) for ph in range(n_ph)
                   for t in range(int(starts[ph]), int(starts[ph + 1]))
                   for c in range(phases[ph].checks.shape[0])]
    n_data, n_meas = len(data_faults), len(meas_faults)
    nf = n_data + n_meas + n_read

    # outcome deviations ------------------------------------------------------
    o_ph = [np.zeros((P.rounds, P.checks.shape[0], nf), dtype=np.uint8)
            for P in phases]
    w_final = np.zeros((n, nf), dtype=np.uint8)
    sread = np.zeros((max(n_read, 1), nf), dtype=np.uint8)
    for f, (t0, qb) in enumerate(data_faults):
        ph_a, ph_b, _end, ridx, reaches_final = slot_int[(t0, qb)]
        if reaches_final:
            w_final[qb, f] = 1
        for ph in range(ph_a, ph_b + 1):
            col = phases[ph].checks[:, qb]
            for t in range(max(t0, int(starts[ph])), int(starts[ph + 1])):
                o_ph[ph][t - int(starts[ph]), :, f] ^= col
        if ridx is not None:
            sread[ridx, f] ^= 1
    for j, (ph, t, c) in enumerate(meas_faults):
        o_ph[ph][t - int(starts[ph]), c, n_data + j] ^= 1
    for (ph, qb), ridx in read_idx.items():
        sread[ridx, n_data + n_meas + ridx] ^= 1

    # partner matching per transition -----------------------------------------
    partners: list[np.ndarray] = [np.empty(0, np.int64)]
    for ph in range(1, n_ph):
        h_new, h_old = phases[ph].checks, phases[ph - 1].checks
        mask = (active[ph] & active[ph - 1]).astype(np.uint8)
        partner = np.full(h_new.shape[0], -1, dtype=np.int64)
        for i in range(h_new.shape[0]):
            restr = h_new[i] & mask
            if not restr.any():
                continue
            hits = np.nonzero(((h_old & mask[None, :]) ==
                               restr[None, :]).all(axis=1))[0]
            if hits.size > 1:
                raise AssertionError(
                    f"ambiguous check continuity at phase {ph}")
            if hits.size == 1:
                partner[i] = hits[0]
        partners.append(partner)

    # anchored-logical terms: validate and collect the anchor phases
    anchors: set[int] = set()
    for terms in observables:
        for term in terms:
            if term[0] != "logical_at":
                continue
            _, ph_a, sup = term
            if not (1 <= ph_a < n_ph):
                raise ValueError("logical_at anchor must be an interior "
                                 "phase boundary (use `logical` for the "
                                 "final readout)")
            for ph in range(ph_a - 1, n_ph):
                if (sup & (1 - active[ph])).any():
                    raise AssertionError(
                        "logical_at support must stay active from the "
                        f"anchor to the end (inactive in phase {ph})")
            anchors.add(ph_a)

    # pre-solve every joint-term combination (shared by both assemblies)
    solved_joints: dict[tuple[int, int], tuple] = {}
    for i_o, terms in enumerate(observables):
        for i_t, term in enumerate(terms):
            if term[0] != "joint":
                continue
            _, ph, target, mode, ref, mref = term
            if not (1 <= ph < n_ph):
                raise ValueError("joint phase out of range")
            h_m, h_s = phases[ph].checks, phases[ph - 1].checks
            if mode == "masked":
                mask = active[ph - 1].astype(np.uint8)
                system = np.concatenate([h_m * mask[None, :], h_s], axis=0)
                tgt = (target & mask).astype(np.uint8)
            else:
                system = np.concatenate([h_m, h_s], axis=0)
                tgt = target.astype(np.uint8)
            u = _solve_gf2(system, tgt)
            if u is None:
                raise AssertionError(
                    "joint target is not measured by this merge "
                    f"(phase {ph}, mode {mode})")
            if mref == "first":
                r_m = 0
            elif mref == "mid":
                r_m = phases[ph].rounds // 2
            else:
                r_m = int(mref)
            if not (0 <= r_m < phases[ph].rounds):
                raise ValueError("joint mref round out of range")
            if ref == "first":
                r_ref = 0
            elif ref == "mid":
                r_ref = phases[ph - 1].rounds // 2
            else:
                r_ref = -1
            solved_joints[(i_o, i_t)] = (ph, u[: h_m.shape[0]],
                                         u[h_m.shape[0]:], r_ref, r_m)

    def assemble(o_ph, sread, w_final, w_at=None):
        """Detector and observable rows as linear maps over whatever
        space the o/sread/w arrays live in (fault deviations for the
        model; raw-outcome indicators for the protocol recipe)."""
        det_rows = []
        ci0 = conj_init_at.get(0, set())
        if ci0:
            mask0 = np.ones(n, np.uint8)
            mask0[list(ci0)] = 0
            det0 = np.nonzero((phases[0].checks & (1 - mask0)[None, :]
                               ).sum(axis=1) == 0)[0]
            det_rows.append(o_ph[0][0][det0])
        else:
            det_rows.append(o_ph[0][0])
        for t in range(1, phases[0].rounds):
            det_rows.append(o_ph[0][t] ^ o_ph[0][t - 1])
        for ph in range(1, n_ph):
            partner = partners[ph]
            h_old, h_new = phases[ph - 1].checks, phases[ph].checks
            sil = silent_at.get(ph, set())
            cin = conj_init_at.get(ph, set())
            matched = np.array([
                i for i in np.nonzero(partner >= 0)[0]
                if not any(h_old[partner[i], qb] for qb in sil)
                and not any(h_new[i, qb] for qb in cin)], dtype=np.int64)
            tr = o_ph[ph][0].copy()
            if matched.size:
                tr[matched] ^= o_ph[ph - 1][-1, partner[matched]]
            # scored readouts of this transition close extended checks
            deact = [(qb, ridx) for (ph_r, qb), ridx in read_idx.items()
                     if ph_r == ph]
            if deact:
                for i in matched:
                    for qb, ridx in deact:
                        if h_old[partner[i], qb]:
                            tr[i] ^= sread[ridx]
            det_rows.append(tr[matched])
            # unmatched new checks FULLY inside a scored-basis growth
            # region (|0⟩-init for a Z-scored model): deterministic
            # first-round values — raw init detectors, the growth
            # analogue of the phase-0 rows (without them an error born
            # at growth-init is invisible: consecutive rounds cancel and
            # the region's partner trail is empty on both temporal
            # boundaries)
            newly = (active[ph] & (1 - active[ph - 1])).astype(bool)
            scored_new = newly.copy()
            if cin:
                scored_new[list(cin)] = False
            if scored_new.any():
                unmatched = np.nonzero(partner < 0)[0]
                init_raw = [i for i in unmatched
                            if h_new[i].any()
                            and not h_new[i][~scored_new].any()]
                if init_raw:
                    det_rows.append(o_ph[ph][0][np.asarray(init_raw)])
            # old checks FULLY on read-out qubits: closure detectors
            # against the readout-bit parity (an ancilla patch's last EC
            # round stays protected through its transversal measurement)
            if deact:
                ro_qubits = {qb for qb, _ in deact}
                for c in range(h_old.shape[0]):
                    sup = np.nonzero(h_old[c])[0]
                    if sup.size and all(int(qb) in ro_qubits for qb in sup):
                        row = o_ph[ph - 1][-1, c].copy()
                        for qb in sup:
                            row ^= sread[read_idx[(ph, int(qb))]]
                        det_rows.append(row[None, :])
            for t in range(1, phases[ph].rounds):
                det_rows.append(o_ph[ph][t] ^ o_ph[ph][t - 1])
        h_last = phases[-1].checks
        final = (h_last.astype(np.int64) @ w_final.astype(np.int64)) & 1
        det_rows.append((final ^ o_ph[-1][-1]).astype(np.uint8))
        F = np.concatenate(det_rows, axis=0) & 1

        obs_rows = []
        width = w_final.shape[1]
        for i_o, terms in enumerate(observables):
            row = np.zeros(width, dtype=np.uint8)
            for i_t, term in enumerate(terms):
                kind = term[0]
                if kind == "logical":
                    sup = term[1]
                    if (sup & (1 - active[-1])).any():
                        raise AssertionError(
                            "final logical touches a qubit inactive "
                            "at the end")
                    row ^= (sup.astype(np.int64)
                            @ w_final.astype(np.int64)
                            ).astype(np.uint8) & 1
                elif kind == "joint":
                    ph, u_m, u_s, r_ref, r_m = solved_joints[(i_o, i_t)]
                    row ^= ((u_m.astype(np.int64)
                             @ o_ph[ph][r_m].astype(np.int64))
                            ^ (u_s.astype(np.int64)
                               @ o_ph[ph - 1][r_ref].astype(np.int64))
                            ).astype(np.uint8) & 1
                elif kind == "readout":
                    _, ph, qb = term
                    if (ph, qb) not in read_idx:
                        raise ValueError(
                            f"no scored readout of {qb} at {ph}")
                    row ^= sread[read_idx[(ph, qb)]]
                elif kind == "readout_logical":
                    _, ph, sup = term
                    for qb in np.nonzero(sup)[0]:
                        if (ph, int(qb)) not in read_idx:
                            raise ValueError(
                                f"readout_logical qubit {qb} not read "
                                f"out at phase {ph}")
                        row ^= sread[read_idx[(ph, int(qb))]]
                elif kind == "logical_at":
                    _, ph, sup = term
                    row ^= (sup.astype(np.int64)
                            @ w_at[ph].astype(np.int64)
                            ).astype(np.uint8) & 1
                else:
                    raise ValueError(f"unknown observable term {kind!r}")
            obs_rows.append(row)
        obs = (np.stack(obs_rows) & 1).astype(np.uint8) if obs_rows else \
            np.zeros((0, width), dtype=np.uint8)
        return F, obs

    # fault-space rows of anchored logicals: fault (t0, qb) flips the
    # anchor iff it precedes the anchor phase's first round AND its
    # activity interval is still live at the anchor
    w_at_model: dict[int, np.ndarray] = {}
    for ph_a in anchors:
        w = np.zeros((n, nf), dtype=np.uint8)
        for f, (t0, qb) in enumerate(data_faults):
            if t0 < int(starts[ph_a]) and slot_int[(t0, qb)][1] >= ph_a - 1:
                w[qb, f] = 1
        w_at_model[ph_a] = w

    F, obs = assemble(o_ph, sread, w_final, w_at_model)

    meta = {"total_rounds": total, "n_detectors": int(F.shape[0]),
            # fault coordinates, diagnostics (fault_distance witnesses):
            # data (slot t, qubit), then meas (phase, slot t, check row),
            # then readout bits in read_idx order
            "data_faults": data_faults, "meas_faults": meas_faults,
            "phase_starts": starts.astype(np.int64)}
    if with_recipe:
        # the same rows over RAW-OUTCOME indicator space: check outcomes
        # in meas_faults order, then readout bits, then the final word —
        # golds evaluate D @ outcomes == 0 and obs_D @ outcomes for the
        # protocol's deterministic references
        n_out = n_meas + n_read + n
        o2 = [np.zeros((Ph.rounds, Ph.checks.shape[0], n_out),
                       dtype=np.uint8) for Ph in phases]
        for j, (ph, t, c) in enumerate(meas_faults):
            o2[ph][t - int(starts[ph]), c, j] = 1
        sr2 = np.zeros((max(n_read, 1), n_out), dtype=np.uint8)
        for ridx in range(n_read):
            sr2[ridx, n_meas + ridx] = 1
        w2 = np.zeros((n, n_out), dtype=np.uint8)
        for qb in range(n):
            w2[qb, n_meas + n_read + qb] = 1
        # anchored logicals fall back to the final readout row in
        # outcome space (noiselessly identical; see `logical_at`)
        D, obs_D = assemble(o2, sr2, w2, {ph: w2 for ph in anchors})
        # expose each anchored term so a circuit-tier consumer can XOR
        # the fallback back OUT of its obs row and place those faults
        # exactly (schedule_circuit handles them in fault space)
        anchored_terms = [
            (i_o, int(term[1]), term[2].astype(np.uint8).copy())
            for i_o, terms in enumerate(observables)
            for term in terms if term[0] == "logical_at"]
        meta["recipe"] = {
            "D": D, "obs": obs_D,
            "meas_order": list(meas_faults),
            "read_order": sorted(read_idx, key=read_idx.get),
            "n_meas": n_meas, "n_read": n_read,
            "has_anchored": bool(anchors),
            "anchored": anchored_terms,
        }

    graph = _graph_from_signatures(F, obs, n_data, p, q)
    probs_class = np.concatenate([
        np.zeros(n_data, dtype=np.uint8),
        np.ones(nf - n_data, dtype=np.uint8)])
    return ScheduleModel(n=n, n_phases=n_ph, fault_probs_class=probs_class,
                         F=F, obs=obs, graph=graph, meta=meta)


def schedule_decoded_obs(model: ScheduleModel, p: float,
                         q: float | None = None, *, batch: int = 1 << 13,
                         seed: int = 0,
                         use_native: bool | None = None) -> np.ndarray:
    """Per-shot DECODED observable deviations, [batch, n_obs] uint8:
    device-sample the fault model, union-find decode, XOR each
    observable's raw fault-linear value with the correction's obs
    flips. A 1 means that observable deviates from its noiseless value
    after decoding (= a logical failure for that channel); the matrix
    IS the logical-level measurement record a second decoding layer
    consumes (`experiments/concatenated.py`)."""
    q = p if q is None else q
    dec = UFDecoder(model.graph, use_native=use_native)
    dets, ob = jax.jit(_sample, static_argnames=("batch",))(
        jax.random.key(seed), jnp.float32(p), jnp.float32(q), batch,
        jnp.asarray(model.fault_probs_class),
        jnp.asarray(model.F.T.astype(np.int32)),
        jnp.asarray(model.obs.T.astype(np.int32)))
    dets, ob = np.asarray(dets), np.asarray(ob)
    _, corr = dec.decode_batch(dets, want_corrections=False)
    bits = (corr[:, None] >> np.arange(model.obs.shape[0])[None, :]) & 1
    return (ob ^ bits).astype(np.uint8)


def schedule_memory(model: ScheduleModel, p: float, q: float | None = None,
                    *, batch: int = 1 << 13, seed: int = 0,
                    use_native: bool | None = None) -> dict:
    """Monte-Carlo a built schedule: device-sample the fault model,
    union-find decode, score every declared observable. Returns per-
    observable failure rates plus `word_fail` (any observable wrong)."""
    q = p if q is None else q
    vals = schedule_decoded_obs(model, p, q, batch=batch, seed=seed,
                                use_native=use_native)
    out = {"p": float(p), "q": float(q), "samples": batch,
           "detectors": int(model.F.shape[0]),
           "edges": int(model.graph.num_edges)}
    for i in range(model.obs.shape[0]):
        out[f"obs{i}_fail"] = float(vals[:, i].mean())
    out["word_fail"] = float(vals.any(axis=1).mean())
    return out


def _device_runner(model: ScheduleModel, batch: int, p: float, q: float,
                   device_decoder: str):
    """Build (or fetch) the compiled sample+decode+count runner for a
    schedule model. Re-tracing this per `schedule_memory_device` call
    costs seconds even with the persistent compile cache warm — with the
    runner cached, repeat calls are pure execution. Runners live in the
    model's own `meta` dict: same lifetime as the model, and no id()
    keys that could alias a recycled address (CLAUDE.md cache rule)."""
    per_model = model.meta.setdefault("_device_runners", {})
    ck = (batch, p, q, device_decoder)
    if ck in per_model:
        return per_model[ck]

    n_obs = model.obs.shape[0]
    decode_fn = device_decode_fn(model, p, q, device_decoder)
    cls = jnp.asarray(model.fault_probs_class)
    f_t = jnp.asarray(model.F.T.astype(np.int32))
    obs_t = jnp.asarray(model.obs.T.astype(np.int32))
    bits = jnp.asarray(1 << np.arange(n_obs), jnp.int32)

    def step(key):
        dets, ob = _sample(key, jnp.float32(p), jnp.float32(q), batch,
                           cls, f_t, obs_t)
        flips, conv = decode_fn(dets)
        truth = (ob.astype(jnp.int32) * bits[None, :]).sum(axis=1)
        fail = flips.astype(jnp.int32) ^ truth
        per_obs = ((fail[:, None] & bits[None, :]) > 0).sum(axis=0)
        word = (fail != 0).sum()
        return per_obs, word, (1 - conv.astype(jnp.int32)).sum()

    @partial(jax.jit, static_argnames=("n",))
    def run_reps(key0, n):
        # the whole rep loop stays ON DEVICE — no per-rep host fences;
        # same keys (fold_in per rep), bit-identical counts
        def body(r, acc):
            po, w, b = step(jax.random.fold_in(key0, r))
            return acc[0] + po, acc[1] + w, acc[2] + b
        z = jnp.zeros((n_obs,), jnp.int32)
        return jax.lax.fori_loop(0, n, body,
                                 (z, jnp.int32(0), jnp.int32(0)))

    per_model[ck] = run_reps
    return run_reps


def device_decode_fn(model: ScheduleModel, p: float, q: float,
                     device_decoder: str):
    """The jittable ``decode(detectors) -> (flips, converged)`` of the
    fused schedule pipeline: the dense `device_uf` kernel
    (``device_decoder='dense'``) or the sparse kernel with its dense
    escape hatch (``'hybrid'``)."""
    from qcss_tpu.decode.device_uf import make_obs_decoder

    if device_decoder == "dense":
        decode_fn = make_obs_decoder(model.graph)
    elif device_decoder == "hybrid":
        # defect-granular sparse path with the dense kernel as the
        # overflow/refusal escape hatch — the operating-noise fast path
        # (compiled-program shots carry a handful of defects). The
        # sparse fetch costs O(D * V^2) matmul flops, so it only wins on
        # graphs that are BIG in detectors but LIGHT in defects: size
        # D to the expected load (mean + 6 sigma, Poisson) and fall
        # back to the dense kernel when the load or the table outgrow
        # it (d=5 compiled-CNOT: V=1872, mean 37 defects).
        from qcss_tpu.decode.device_sparse import make_hybrid_obs_decoder

        rates = np.where(model.fault_probs_class == 1, q, p)
        lam = model.F.astype(np.float64) @ rates
        p_det = 0.5 * (1.0 - np.exp(-2.0 * lam))
        mean_d = float(p_det.sum())
        d_max = int(np.clip(
            16 * np.ceil((mean_d + 6 * np.sqrt(mean_d + 1)) / 16), 32, 96))
        if model.F.shape[0] > 1280 and mean_d > 24:
            decode_fn = make_obs_decoder(model.graph)  # sparse can't win
        else:
            decode_fn = make_hybrid_obs_decoder(model.graph, d_max=d_max)
    else:
        raise ValueError("device_decoder must be 'dense' or 'hybrid'")
    return decode_fn


def schedule_memory_device(model: ScheduleModel, p: float,
                           q: float | None = None, *,
                           batch: int = 1 << 13, seed: int = 0,
                           reps: int = 1,
                           device_decoder: str = "dense") -> dict:
    """The fully inverted pipeline for an arbitrary patch schedule:
    sampling, detector assembly, union-find decoding and failure
    counting fuse into ONE compiled device program (`decode.device_uf`)
    — only per-observable failure counts cross the host boundary. The
    schedule analogue of `memory_experiment(decoder='device-uf')`;
    weight the graph by building the model with p/q.

    `reps` re-runs the compiled step with fresh keys and accumulates —
    the throughput-measurement form (one compile, many batches)."""
    from qcss_tpu.decode.device_uf import make_obs_decoder

    q = p if q is None else q
    n_obs = model.obs.shape[0]
    if n_obs > 24:
        raise ValueError("device path packs obs rows into one int32")
    if batch * reps >= (1 << 31):
        # the fori_loop accumulators are int32 on device (x64 is off);
        # past this the counts would silently wrap instead of failing
        raise ValueError(
            f"batch*reps = {batch * reps} would overflow the int32 "
            "device accumulators; split into multiple calls")
    run_reps = _device_runner(model, batch, float(p), float(q),
                              device_decoder)
    po, w, b = run_reps(jax.random.key(seed), reps)
    per_obs = np.asarray(po).astype(np.int64)
    word = int(w)
    bad = int(b)
    if bad:
        raise RuntimeError("device union-find hit its growth cap")
    total = batch * reps
    out = {"p": float(p), "q": float(q), "samples": total,
           "detectors": int(model.F.shape[0]),
           "edges": int(model.graph.num_edges),
           "decoder": "device-uf",
           "word_fail": word / total}
    for i in range(n_obs):
        out[f"obs{i}_fail"] = per_obs[i] / total
    return out


# -- composed demo: the logical-level parity-check chain ---------------------


def parity_chain_model(d: int, n_patches: int = 3,
                       rounds: int | None = None,
                       p: float | None = None,
                       q: float | None = None) -> ScheduleModel:
    """Sequential lattice-surgery Z̄ᵢZ̄ᵢ₊₁ measurements down a column of
    `n_patches` surface patches — the syndrome-extraction network of a
    repetition code OVER LOGICAL QUBITS, i.e. surgery as the logical-
    level EC layer. No bespoke builder exists for this; it is pure
    composition on `build_schedule`.

    Layout: patch i occupies rows i*(d+1)..i*(d+1)+d-1 of a
    ((n_patches)*(d+1)-1) x d strip; seam row i*(d+1)+d separates
    patches i and i+1. The schedule alternates separate rounds with one
    ZZ merge per adjacent pair, in order. Observables: m_i (each joint
    Z̄ᵢZ̄ᵢ₊₁, solved seam-even so any seam init works) followed by the
    final Z̄ᵢ readouts. Z-check sector (X-error faults).
    """
    if n_patches < 2:
        raise ValueError("need >= 2 patches")
    R = d if rounds is None else rounds
    if R < 3:
        raise ValueError("merged phases need >= 3 rounds "
                         "(see surgery.build_xx_merge_split)")
    rows, cols = n_patches * (d + 1) - 1, d
    n = rows * cols
    seams = [[(i * (d + 1) + d) * cols + c for c in range(cols)]
             for i in range(n_patches - 1)]
    patch_mask = np.zeros(n, dtype=np.uint8)
    for i in range(n_patches):
        for r in range(d):
            r0 = i * (d + 1) + r
            patch_mask[r0 * cols: r0 * cols + d] = 1

    def embed(small: np.ndarray, row_off: int) -> np.ndarray:
        big = np.zeros((small.shape[0], n), dtype=np.uint8)
        sm = small.reshape(-1, d, d)
        for r in range(d):
            big[:, (r + row_off) * cols: (r + row_off) * cols + d] = \
                sm[:, r, :]
        return big

    _, hz_p = families.surface_rect_checks(d, d)
    hz_patches = [embed(hz_p, i * (d + 1)) for i in range(n_patches)]
    hz_sep = np.concatenate(hz_patches, axis=0)
    _, hz_pair = families.surface_rect_checks(2 * d + 1, d)

    def merged_checks(i: int) -> np.ndarray:
        big = np.zeros((hz_pair.shape[0], n), dtype=np.uint8)
        sm = hz_pair.reshape(-1, 2 * d + 1, d)
        r0 = i * (d + 1)
        for r in range(2 * d + 1):
            big[:, (r + r0) * cols: (r + r0) * cols + d] = sm[:, r, :]
        others = [hz_patches[j] for j in range(n_patches)
                  if j not in (i, i + 1)]
        return np.concatenate([big] + others, axis=0)

    phases = [Phase(hz_sep, R)]
    act = [patch_mask.copy()]
    for i in range(n_patches - 1):
        m_act = patch_mask.copy()
        m_act[seams[i]] = 1
        phases.append(Phase(merged_checks(i), R))
        act.append(m_act)
        phases.append(Phase(hz_sep, R))
        act.append(patch_mask.copy())
    active = np.stack(act)

    def zbar(i: int) -> np.ndarray:
        v = np.zeros(n, dtype=np.uint8)
        r0 = i * (d + 1)
        v[r0 * cols: r0 * cols + d] = 1
        return v

    observables = [
        [joint(1 + 2 * i, (zbar(i) ^ zbar(i + 1)).astype(np.uint8),
               mode="even")]
        for i in range(n_patches - 1)
    ] + [[logical(zbar(i))] for i in range(n_patches)]
    return build_schedule(n, phases, active, observables, p=p, q=q)


def parity_chain_memory(d: int, p: float, q: float | None = None, *,
                        n_patches: int = 3, rounds: int | None = None,
                        batch: int = 1 << 13, seed: int = 0,
                        weighted: bool = False,
                        use_native: bool | None = None) -> dict:
    """Monte-Carlo the logical parity-check chain: failure rates of each
    joint measurement m_i = Z̄ᵢZ̄ᵢ₊₁ and each final Z̄ᵢ."""
    q = p if q is None else q
    kw = dict(p=p, q=q) if weighted else dict(p=None, q=None)
    model = parity_chain_model(d, n_patches, rounds, **kw)
    out = schedule_memory(model, p, q, batch=batch, seed=seed,
                          use_native=use_native)
    out.update({"d": d, "n_patches": n_patches,
                "rounds": d if rounds is None else rounds})
    for i in range(n_patches - 1):
        out[f"m{i}_fail"] = out.pop(f"obs{i}_fail")
    for i in range(n_patches):
        out[f"z{i}_fail"] = out.pop(f"obs{n_patches - 1 + i}_fail")
    return out
