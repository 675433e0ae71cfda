"""End-to-end tour of qcss_tpu (runs on the CPU or a GPU in ~a minute).

    python examples/demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from qcss_tpu.circuits import Circuit, Program
from qcss_tpu.codes import families
from qcss_tpu.decode import logical_error_rate
from qcss_tpu.experiments import z_memory_experiment
from qcss_tpu.ftqc import rewrite_program
from qcss_tpu.sim.noise import NoiseModel


def main():
    # 1. Construct a CSS code and inspect it.
    code = families.steane()
    print("code:", code)
    print("stabilisers:", code.stabilisers())
    print("logical Z:", code.z_operators(), " logical X:", code.x_operators())
    print("transversal gates:", sorted(code.transversal_gates))

    # 2. Monte-Carlo logical error rates (fused device pipeline).
    for p in (0.001, 0.01):
        out = logical_error_rate(code, p, samples=1 << 18, batch=1 << 18)
        print(f"p={p}: logical word error rate {out['word_fail']:.2e}")

    # 3. FT-encode and run a Clifford program with classical feedback.
    prog = Program()
    ro = prog.declare("ro", 2)
    prog.h(0)
    prog.measure(0, ro[0])
    prog.if_then(ro[0], Circuit().x(0))  # deterministically restore |0̄⟩
    prog.measure(0, ro[1])
    enc = rewrite_program(prog, code, noise=NoiseModel(p_gate1=1e-4))
    res = enc.run(batch=64, key=jax.random.key(0))
    print("feedback program: first measurement mean",
          float(res["ro"][:, 0].mean()),
          "| second (always 0):", int(res["ro"][:, 1].sum()))

    # 4. Circuit-level quantum memory experiment, spacetime-decoded.
    mem = z_memory_experiment(
        code, rounds=3, noise=NoiseModel(p_gate2=1e-3, p_meas=5e-3),
        batch=4096, decoder="stlut",
    )
    print("3-round Z-memory logical failure rate (spacetime LUT):",
          mem["logical_fail"])

    # 5. Union-find decoding past the LUT wall: surface code at d=9.
    from qcss_tpu.decode import uf_logical_error_rate

    surf = families.rotated_surface(9)
    out = uf_logical_error_rate(surf, 0.05, samples=1 << 13, batch=1 << 13)
    print("surface d=9, p=0.05, union-find word error rate:",
          f"{out['word_fail']:.2e}")

    # 6. Repeat-until-success with classical compute on bits.
    from qcss_tpu.circuits import Block

    rus = Program()
    bits = rus.declare("bits", 2)
    rus.repeat_until(bits[0], Block().reset(0).h(0).measure(0, bits[0]),
                     max_iters=4)
    rus.measure(0, bits[1])
    out = rewrite_program(rus, code).run(batch=16, key=jax.random.key(1))
    print("repeat-until-success: loop bit mean",
          float(out["bits"][:, 0].mean()),
          "| confirm == loop bit:",
          bool((out["bits"][:, 1] == out["bits"][:, 0]).all()))

    # 7. The frame engine: the same memory experiment sampled ~100x
    # faster on Pauli deviations, decoded with the circuit-level DEM.
    surf3 = families.rotated_surface(3, max_table_weight=0, t=1)
    mem = z_memory_experiment(
        surf3, rounds=3, noise=NoiseModel(p_gate2=2e-3, p_meas=1e-2),
        batch=1 << 14, decoder="dem", engine="frames",
    )
    print("surface-3 memory, frames + DEM decode:", mem["logical_fail"])

    # 8. Exact minimum-weight matching (blossom) and correlated decoding.
    import numpy as np

    from qcss_tpu.decode import MWPMDecoder, graph_from_checks

    g = graph_from_checks(surf.raw_parity_check_c2, surf.z_operator_matrix())
    rng = np.random.default_rng(0)
    errs = (rng.random((2048, surf.n)) < 0.05).astype(np.uint8)
    syn = ((errs @ surf.raw_parity_check_c2.T) & 1).astype(np.uint8)
    _, obs = MWPMDecoder(g).decode_batch(syn, want_corrections=False)
    par = (errs @ surf.z_operator_matrix()[0]) % 2
    print("surface d=9 exact-MWPM failure at p=0.05:",
          float(np.mean((obs & 1) != par)))

    # 9. Streaming: a 300-round memory decoded with O(window) state.
    from qcss_tpu.decode import (
        StreamingDecoder,
        sample_phenomenological_stream,
    )
    from qcss_tpu.decode.uf import _pack_parity

    h5 = families.rotated_surface(5)
    dets, par = sample_phenomenological_stream(
        jax.random.key(2), 0.005, 0.005, 256, 300,
        h5.raw_parity_check_c2, h5.z_operator_matrix())
    sd = StreamingDecoder(h5.raw_parity_check_c2, h5.z_operator_matrix(),
                          window=10, commit=5)
    obs = sd.decode_stream(np.asarray(dets))
    print("300-round d=5 streaming-memory failure:",
          float(np.mean(obs != _pack_parity(np.asarray(par)))))

    # 10. The quantum Golay code: transversal S at distance 7.
    gol = families.golay()
    print("golay:", gol, "transversal:", sorted(gol.transversal_gates))

    # 11. qLDPC: a bivariate-bicycle code ([[72,12,6]]) decoded with
    # device BP(+OSD) over its full redundant check set.
    from qcss_tpu.decode import BPDecoder

    bb = families.bb72()
    h = bb.redundant_parity_check_c2
    lz = bb.z_operator_matrix()
    dec = BPDecoder(h, 2 * 0.01 / 3, logicals=lz, iters=48)
    errs = (rng.random((4096, bb.n)) < 2 * 0.01 / 3).astype(np.uint8)
    flips, conv = dec.decode_obs((errs @ h.T) & 1)
    true = (errs.astype(np.int64) @ lz.T.astype(np.int64)) & 1
    print("bb72 @ p=0.01 code capacity: word fail over 12 logicals",
          float((flips ^ true).any(axis=1).mean()),
          "| BP converged:", float(np.asarray(conv).mean()))

    # 12. Soft output: post-select on the complementary-gap confidence.
    _, _, gap = dec.decode_obs_gap((errs[:1024] @ h.T) & 1)
    fail = (flips[:1024] ^ true[:1024]).any(axis=1)
    keep = gap >= 10.0
    print(f"gap post-selection: keep {keep.mean():.2f},",
          f"conditional fail {fail[keep].mean():.4f}",
          f"(unselected {fail.mean():.4f})")

    # 12b. The logical-program compiler at the surgery tier: the
    # reference's own test programs (X/Y/Z/HZH and measure-and-correct
    # feedback, test_ftqc.py:22-113) on surface patches — h is a
    # transversal patch rotation, the conditional X is observable
    # algebra (mx + h + x_if == H; MEASURE; if m: X).
    from qcss_tpu.experiments import LogicalProgram

    hzh = LogicalProgram(3, 1).h(0).idle().z(0).idle().h(0)
    print("compiled HZH (d=3):",
          {k: v for k, v in hzh.run(2e-3, batch=4096).items()
           if k in ("z0_fail", "word_fail")},
          "| expected:", hzh.build().meta["obs_expected"])
    fb = LogicalProgram(3, 1).mx(0).h(0).x_if(0, "mx0_0")
    print("compiled feedback program:",
          {k: round(v, 5) for k, v in fb.run_full(2e-3, batch=4096).items()
           if "fail" in k})

    # 13. Universality: transversal-T classification and the magic-state
    # factory (the reference's `_apply_universal` is a stub, reference:
    # css_code.py:433-434). Exact 15-to-1 map, then a measured injection
    # on the Steane code composed into an end-to-end resource estimate.
    from qcss_tpu.experiments import factory_report
    from qcss_tpu.ftqc import magic

    rm = families.reed_muller_15()
    print("[[15,1,3]] transversal T power:", rm.transversal_t_power,
          "| exact 15-to-1 at p_in=1e-2:", magic.distill_exact(1e-2))
    rep = factory_report(code, NoiseModel(p_gate1=1e-4, p_gate2=1e-4,
                                          p_meas=1e-4, p_reset=1e-4),
                         p_t=1e-3, levels=2, batch=1 << 16)
    print(f"factory: injection eps {rep['injection']['eps']:.2e}",
          f"-> 2-level p_out {rep['p_out']:.2e}",
          f"at {rep['injections_per_state']:.0f} injections/state")

    # 14. The logical-program compiler: a Z-basis logical circuit —
    # lattice-surgery CNOT with a routed ancilla — compiled onto a patch
    # grid as one declarative schedule and decoded end to end.
    from qcss_tpu.experiments import LogicalProgram

    out = LogicalProgram(3, 2).cnot(0, 1).run(2e-3, batch=1 << 12)
    print("compiled logical CNOT @ d=3, p=2e-3:",
          f"word fail {out['word_fail']:.4f}",
          f"({out['n_phases']} phases, {out['grid_qubits']} grid qubits)")

    # 14b. The same compiled program at CIRCUIT-LEVEL noise: real
    # two-sector extraction circuits (hook faults, meas/reset/init
    # errors), BP(+device OSD) on the circuit fault Tanner graph.
    circ = LogicalProgram(3, 2).cnot(0, 1).run_circuit(
        NoiseModel(p_gate2=1e-3, p_meas=1e-3, p_reset=1e-3),
        batch=1 << 12)
    print("circuit-level compiled CNOT @ d=3, p=1e-3:",
          f"word fail {circ['word_fail']:.4f}",
          f"({circ['fault_vars']} circuit fault variables,",
          f"BP conv {circ['bp_converged']:.2f})")

    # 15. Two-level concatenation: repeated mzz joints form a repetition
    # code OVER the logical patches; the same union-find kernel decodes
    # the logical-level spacetime syndrome on top of the patch decodes.
    from qcss_tpu.experiments import logical_repetition_memory

    two = logical_repetition_memory(3, 3, 3, 4e-3, batch=1 << 10, seed=1)
    print("two-level memory @ d=3, k=3, p=4e-3: word fail",
          f"{two['word_fail_l1']:.3f} (level 1) ->",
          f"{two['word_fail_l2']:.3f} (level 2)")

    # 16. Resource estimation: fit the failure-vs-distance law, solve
    # for the distance meeting a budget, price the program (and its T
    # count against a magic-state factory report).
    from qcss_tpu.experiments import logical_resource_report

    est = logical_resource_report(
        lambda d: LogicalProgram(d, 2).cnot(0, 1).t(1),
        2e-3, target=1e-6, fails={3: 2.3e-2, 5: 1.9e-3},  # measured pts
        factory={"p_out": rep["p_out"],
                 "injections_per_state": rep["injections_per_state"]})
    print(f"resource report: Lambda {est['fit']['Lambda']:.1f},",
          f"d* = {est['d_star']} ->",
          f"{est['at_d_star']['grid_qubits']} grid qubits,",
          f"{est['at_d_star']['total_rounds']} rounds,",
          f"factory ok: {est['magic']['factory_meets_budget']}")


if __name__ == "__main__":
    main()
