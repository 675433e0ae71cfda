"""Pauli-frame Monte-Carlo simulator — the sampling fast path.

The batched tableau engines (`sim.tableau`, `sim.tableau_packed`) carry a
full CHP tableau PER SAMPLE: every gate costs O(rows · words) per sample
and every measurement a full-tableau reduction. For the Monte-Carlo
workloads that dominate QEC benchmarking (memory experiments, error-rate
sweeps, break-even curves) that is massively redundant: all samples run
the SAME Clifford circuit and differ only in which Pauli faults struck.

This module propagates only the per-sample Pauli fault frame (the
deviation from the noiseless reference run) through the circuit — the
architecture Stim introduced for CPU sampling (Gidney, "Stim: a fast
stabilizer circuit simulator", arXiv:2103.02202 §4.2), rebuilt device-first:
frames are `[B, nq]` bit arrays, gates are XOR/permute column ops, noise
is fused batched injection, and the whole per-round loop jits into a few
elementwise kernels. Per-gate cost drops from O(rows·words) to O(1) bits
per sample.

Soundness domain (asserted by callers, see `experiments.memory`):

* the noiseless reference circuit must have DETERMINISTIC measurement
  outcomes (true for syndrome extraction on stabilizer eigenstates);
  outcomes are then reported as deviations (reference ⊕ deviation, with
  the reference outcome fixed to 0 — for a memory experiment this pins
  the reference codeword, which no syndrome/logical-parity statistic can
  distinguish);
* measured qubits must be reset before reuse (the frame simulator does
  not model the post-measurement phase scramble a tableau would track);
* conditional operations must be Pauli (frame-linear). Programs needing
  conditional Clifford bodies or non-deterministic references stay on the
  tableau engines.

Fault injection semantics are bit-compatible with `sim.noise`
(thresholds, 15-way 2q patterns, biased twirled-decoherence tuples), and
single-fault detector signatures are cross-validated against the
independent DEM enumeration (`decode.dem`) in tests/test_frame.py.

(The reference simulates every shot through the Forest QVM state-vector
process — SURVEY.md §3.3; no frame machinery of any kind.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from qcss_tpu.sim import noise as noise_mod


class Frames(NamedTuple):
    """Per-sample Pauli deviation from the reference run: `x[b, q]` /
    `z[b, q]` set iff sample b carries an X / Z error on qubit q."""

    x: jax.Array  # [B, nq] uint8
    z: jax.Array  # [B, nq] uint8

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def n(self) -> int:
        return self.x.shape[1]


def zero_frames(batch: int, n: int) -> Frames:
    z = jnp.zeros((batch, n), dtype=jnp.uint8)
    return Frames(z, z)


# -- gate propagation (conjugation of the frame, no signs) ---------------------


def _prop_h(f: Frames, q, _b) -> Frames:
    xq, zq = f.x[:, q], f.z[:, q]
    return Frames(f.x.at[:, q].set(zq), f.z.at[:, q].set(xq))


def _prop_s(f: Frames, q, _b) -> Frames:
    return Frames(f.x, f.z.at[:, q].set(f.z[:, q] ^ f.x[:, q]))


def _prop_cnot(f: Frames, c, t) -> Frames:
    return Frames(
        f.x.at[:, t].set(f.x[:, t] ^ f.x[:, c]),
        f.z.at[:, c].set(f.z[:, c] ^ f.z[:, t]),
    )


def _prop_cz(f: Frames, a, b) -> Frames:
    z = f.z.at[:, a].set(f.z[:, a] ^ f.x[:, b])
    z = z.at[:, b].set(z[:, b] ^ f.x[:, a])
    return Frames(f.x, z)


def _prop_id(f: Frames, _a, _b) -> Frames:
    return f


# Opcode order matches circuits.ir.OPCODES / tableau._SCAN_BRANCHES.
# Paulis are identity on frames (they change signs only, which frames
# don't track — deviations are defined modulo phase).
_FRAME_BRANCHES = (
    _prop_id,  # I
    _prop_id,  # X
    _prop_id,  # Y
    _prop_id,  # Z
    _prop_h,   # H
    _prop_s,   # S
    _prop_cnot,
    _prop_cz,
)


def propagate_arrays(f: Frames, ops, q0, q1) -> Frames:
    """Noiseless frame propagation through an array-lowered circuit."""

    def body(carry, xs):
        op, a, b = xs
        return jax.lax.switch(op, _FRAME_BRANCHES, carry, a, b), None

    xs = (jnp.asarray(ops, jnp.int32), jnp.asarray(q0, jnp.int32),
          jnp.asarray(q1, jnp.int32))
    f, _ = jax.lax.scan(body, f, xs)
    return f


# -- noise injection (bit-compatible with sim.noise) ----------------------------


def _inject1(f: Frames, q, p, key) -> Frames:
    u = jax.random.uniform(key, (f.batch,), dtype=jnp.float32)
    x_hi, z_lo, z_hi = (jnp.float32(v) for v in noise_mod._thresholds_1q(p))
    x_hit = (u < x_hi).astype(jnp.uint8)
    z_hit = ((u >= z_lo) & (u < z_hi)).astype(jnp.uint8)
    return Frames(
        f.x.at[:, q].set(f.x[:, q] ^ x_hit),
        f.z.at[:, q].set(f.z[:, q] ^ z_hit),
    )


def _inject2(f: Frames, a, b, p, key) -> Frames:
    if isinstance(p, tuple):
        # Match noise.depolarize2's tuple branch exactly: it delegates to
        # depolarize1_many([a, b]) which draws ONE (B, 2) uniform from the
        # UNSPLIT key — key consumption must coincide for the frames ↔
        # unpacked-tableau bit-identity contract under biased noise.
        u = jax.random.uniform(key, (f.batch, 2), dtype=jnp.float32)
        x_hi, z_lo, z_hi = (
            jnp.float32(v) for v in noise_mod._thresholds_1q(p)
        )
        x_hit = (u < x_hi).astype(jnp.uint8)
        z_hit = ((u >= z_lo) & (u < z_hi)).astype(jnp.uint8)
        x = f.x.at[:, a].set(f.x[:, a] ^ x_hit[:, 0])
        x = x.at[:, b].set(x[:, b] ^ x_hit[:, 1])
        z = f.z.at[:, a].set(f.z[:, a] ^ z_hit[:, 0])
        z = z.at[:, b].set(z[:, b] ^ z_hit[:, 1])
        return Frames(x, z)
    key_u, key_p = jax.random.split(key)
    hit = (
        jax.random.uniform(key_u, (f.batch,), dtype=jnp.float32) < jnp.float32(p)
    ).astype(jnp.uint8)
    pat = jax.random.randint(key_p, (f.batch,), 1, 16, dtype=jnp.int32)
    x = f.x.at[:, a].set(f.x[:, a] ^ (pat & 1).astype(jnp.uint8) * hit)
    x = x.at[:, b].set(x[:, b] ^ ((pat >> 2) & 1).astype(jnp.uint8) * hit)
    z = f.z.at[:, a].set(f.z[:, a] ^ ((pat >> 1) & 1).astype(jnp.uint8) * hit)
    z = z.at[:, b].set(z[:, b] ^ ((pat >> 3) & 1).astype(jnp.uint8) * hit)
    return Frames(x, z)


def inject1_many(f: Frames, qubits, p, key) -> Frames:
    """IID single-qubit Pauli channel on a set of qubits — the frame
    counterpart of `noise.depolarize1_many` (same thresholds)."""
    q = jnp.asarray(qubits, jnp.int32)
    u = jax.random.uniform(key, (f.batch, q.shape[0]), dtype=jnp.float32)
    x_hi, z_lo, z_hi = (jnp.float32(v) for v in noise_mod._thresholds_1q(p))
    x_hit = (u < x_hi).astype(jnp.uint8)
    z_hit = ((u >= z_lo) & (u < z_hi)).astype(jnp.uint8)
    return Frames(
        f.x.at[:, q].set(f.x[:, q] ^ x_hit),
        f.z.at[:, q].set(f.z[:, q] ^ z_hit),
    )


def inject2_many(f: Frames, controls, targets, p, key) -> Frames:
    """IID two-qubit noise on m disjoint pairs — the frame counterpart of
    `noise.depolarize2_many` (same 15-way patterns / biased split)."""
    if isinstance(p, tuple):
        q_all = jnp.concatenate([
            jnp.asarray(controls, jnp.int32), jnp.asarray(targets, jnp.int32)
        ])
        return inject1_many(f, q_all, p, key)
    c = jnp.asarray(controls, jnp.int32)
    q = jnp.asarray(targets, jnp.int32)
    m = c.shape[0]
    key_u, key_p = jax.random.split(key)
    hit = (
        jax.random.uniform(key_u, (f.batch, m), dtype=jnp.float32)
        < jnp.float32(p)
    ).astype(jnp.uint8)
    pat = jax.random.randint(key_p, (f.batch, m), 1, 16, dtype=jnp.int32)
    x = f.x.at[:, c].set(f.x[:, c] ^ (pat & 1).astype(jnp.uint8) * hit)
    x = x.at[:, q].set(x[:, q] ^ ((pat >> 2) & 1).astype(jnp.uint8) * hit)
    z = f.z.at[:, c].set(f.z[:, c] ^ ((pat >> 1) & 1).astype(jnp.uint8) * hit)
    z = z.at[:, q].set(z[:, q] ^ ((pat >> 3) & 1).astype(jnp.uint8) * hit)
    return Frames(x, z)


def run_arrays_noisy(f: Frames, ops, q0, q1,
                     model: noise_mod.NoiseModel, key) -> Frames:
    """Frame propagation with a depolarizing location after every gate —
    the frame counterpart of `noise.run_arrays_noisy` (same channel
    layout, so hook-error physics is identical)."""
    if model.is_trivial:
        return propagate_arrays(f, ops, q0, q1)

    from qcss_tpu.circuits.ir import OPCODES

    two_q_start = OPCODES["CNOT"]
    ops = jnp.asarray(ops, jnp.int32)
    q0 = jnp.asarray(q0, jnp.int32)
    q1 = jnp.asarray(q1, jnp.int32)
    keys = jax.random.split(key, max(int(ops.shape[0]), 1))

    def body(carry, xs):
        op, a, b, k = xs
        carry = jax.lax.switch(op, _FRAME_BRANCHES, carry, a, b)
        if model.p_gate1 or model.p_gate2:
            carry = jax.lax.cond(
                op >= two_q_start,
                lambda s: _inject2(s, a, b, model.rate2, k),
                lambda s: _inject1(s, a, model.rate1, k),
                carry,
            )
        return carry, None

    f, _ = jax.lax.scan(body, f, (ops, q0, q1, keys))
    return f


# -- compiled (matrix-form) circuits -------------------------------------------
#
# Frame propagation through a FIXED Clifford circuit is linear over GF(2),
# and noise injection is XOR, so an entire noisy circuit collapses to
#     out = in · M  ⊕  noise_bits · S
# where M is the circuit's 2n×2n transfer matrix and row r of S is the
# propagated image of elementary fault r through the circuit SUFFIX after
# its gate (noise strikes after each gate, exactly as the scan path
# injects it). Sampling consumes PRNG keys gate-for-gate like
# `run_arrays_noisy`, so compiled execution is BIT-IDENTICAL to the scan
# — it just replaces ~G sequential scatter steps with two matmuls.


class CompiledFrameCircuit(NamedTuple):
    """Matrix form of a circuit on n qubits (frame coords [x_0..x_{n-1},
    z_0..z_{n-1}]): transfer matrix ``m`` [2n, 2n]; fault-suffix matrix
    ``s`` [R, 2n] with ``s_meta`` describing each gate's sampling recipe
    (list of (kind, row_offset) with kind '1q'/'2q'/'2q_biased')."""

    m: jax.Array             # [2n, 2n] uint8
    s: jax.Array | None      # [R, 2n] uint8 (None if no noise rows)
    ops: tuple               # opcodes per gate (static python ints)
    n: int

    @property
    def num_gates(self) -> int:
        return len(self.ops)


def compile_circuit(ops, q0, q1, n: int) -> CompiledFrameCircuit:
    """Build the transfer/suffix matrices for an array-lowered circuit on
    n qubits (host-side, once per circuit). One backward pass: at gate g
    the running suffix map covers gates g+1..G (recorded as that gate's
    fault rows), then gate g is prepended via row operations."""
    import numpy as onp

    ops_np = onp.asarray(ops, onp.int32)
    q0_np = onp.asarray(q0, onp.int32)
    q1_np = onp.asarray(q1, onp.int32)
    from qcss_tpu.circuits.ir import OPCODES

    assert OPCODES["CNOT"] == 6  # gate-rule dispatch below keys off this
    G = ops_np.shape[0]
    m = onp.eye(2 * n, dtype=onp.uint8)
    # fault rows per gate, recorded back-to-front
    rows_rev: list[onp.ndarray] = []
    for g in range(G - 1, -1, -1):
        op, a, b = int(ops_np[g]), int(q0_np[g]), int(q1_np[g])
        # record fault coords (x_a, z_a, x_b, z_b) through the suffix;
        # 1q gates use only the first two rows
        rows_rev.append(m[[a, n + a, b % n, n + (b % n)], :].copy())
        # prepend gate g (see derivation in the module comment): updating
        # M <- A_g · M via row ops
        if op == 4:  # H
            m[[a, n + a], :] = m[[n + a, a], :]
        elif op == 5:  # S
            m[a, :] ^= m[n + a, :]
        elif op == 6:  # CNOT
            m[a, :] ^= m[b, :]          # row x_c ^= row x_t
            m[n + b, :] ^= m[n + a, :]  # row z_t ^= row z_c
        elif op == 7:  # CZ
            m[b, :] ^= m[n + a, :]      # row x_b ^= row z_a
            m[a, :] ^= m[n + b, :]      # row x_a ^= row z_b
        # I/X/Y/Z: identity on frames
    rows = list(reversed(rows_rev))
    s = onp.concatenate(rows, axis=0) if rows else None
    return CompiledFrameCircuit(
        m=jnp.asarray(m),
        s=None if s is None else jnp.asarray(s),
        ops=tuple(int(o) for o in ops_np),
        n=n,
    )


def maybe_compile(arrays, n: int,
                  min_gates: int = 100) -> CompiledFrameCircuit | None:
    """Compile an array-lowered circuit to matrix form when it is large
    enough to win (cutover from the first target machine: the
    two-matmul form beat the per-gate scan from ~100 gates up; not yet
    re-measured on the GPU). Returns None below the cutover."""
    ops = arrays[0]
    if int(jnp.asarray(ops).shape[0]) < min_gates:
        return None
    return compile_circuit(*arrays, n)


def _sampled_fault_bits(comp: CompiledFrameCircuit,
                        model: noise_mod.NoiseModel, key, batch: int):
    """[B, 4G] fault-coefficient bits with the scan path's exact key
    consumption: keys split per gate; 1q gates draw one uniform, 2q
    scalar gates split into (u, pattern), biased 2q gates draw one (B, 2)
    uniform from the unsplit key (the loop's per-gate draws are vmapped
    over the per-kind key groups — identical bits, one RNG op per group).
    Rows align with `compile_circuit`'s 4-per-gate layout (1q gates leave
    their last two rows zero)."""
    from qcss_tpu.circuits.ir import OPCODES

    two_q_start = OPCODES["CNOT"]
    G = comp.num_gates
    keys = jax.random.split(key, max(G, 1))
    ops_np = comp.ops
    idx_1q = [g for g, op in enumerate(ops_np) if op < two_q_start]
    idx_2q = [g for g, op in enumerate(ops_np) if op >= two_q_start]
    out = jnp.zeros((batch, 4 * G), jnp.uint8)

    def u_batch(ks):  # same bits as uniform(k, (batch,)) per key
        return jax.vmap(
            lambda k: jax.random.uniform(k, (batch,), dtype=jnp.float32)
        )(ks)

    if idx_1q:
        x_hi, z_lo, z_hi = (
            jnp.float32(v) for v in noise_mod._thresholds_1q(model.rate1)
        )
        u = u_batch(keys[jnp.asarray(idx_1q)])  # [G1, B]
        x_hit = (u < x_hi).astype(jnp.uint8).T
        z_hit = ((u >= z_lo) & (u < z_hi)).astype(jnp.uint8).T
        base = 4 * jnp.asarray(idx_1q)
        out = out.at[:, base].set(x_hit).at[:, base + 1].set(z_hit)
    if idx_2q:
        rate2 = model.rate2
        base = 4 * jnp.asarray(idx_2q)
        if isinstance(rate2, tuple):
            # one (B, 2) uniform per gate from the UNSPLIT key — the
            # _inject2 tuple branch's exact consumption
            x_hi, z_lo, z_hi = (
                jnp.float32(v) for v in noise_mod._thresholds_1q(rate2)
            )
            u = jax.vmap(
                lambda k: jax.random.uniform(k, (batch, 2),
                                             dtype=jnp.float32)
            )(keys[jnp.asarray(idx_2q)])  # [G2, B, 2]
            x_hit = (u < x_hi).astype(jnp.uint8)
            z_hit = ((u >= z_lo) & (u < z_hi)).astype(jnp.uint8)
            out = (
                out.at[:, base].set(x_hit[:, :, 0].T)
                .at[:, base + 1].set(z_hit[:, :, 0].T)
                .at[:, base + 2].set(x_hit[:, :, 1].T)
                .at[:, base + 3].set(z_hit[:, :, 1].T)
            )
        else:
            ks2 = jax.vmap(jax.random.split)(
                keys[jnp.asarray(idx_2q)])  # [G2, 2]
            hit = (u_batch(ks2[:, 0]) < jnp.float32(rate2)).astype(jnp.uint8)
            pat = jax.vmap(
                lambda k: jax.random.randint(k, (batch,), 1, 16,
                                             dtype=jnp.int32)
            )(ks2[:, 1])
            for bit in range(4):
                out = out.at[:, base + bit].set(
                    (((pat >> bit) & 1).astype(jnp.uint8) * hit).T)
    return out  # [B, 4G]


def _mod2_matmul(a, b):
    from qcss_tpu.ops.gf2_jax import mod2_matmul

    return mod2_matmul(a, b)


def run_compiled_noisy(f: Frames, comp: CompiledFrameCircuit,
                       model: noise_mod.NoiseModel, key,
                       qubits=None) -> Frames:
    """Execute a compiled circuit: out = in·M ⊕ faults·S. ``qubits``
    ([n] indices, traced OK) selects the circuit's qubit window inside
    wider frames (None = the circuit spans the whole frame). Bit-identical
    to `run_arrays_noisy` on the same (ops, q0, q1, key)."""
    if qubits is None:
        x, z = f.x, f.z
    else:
        qubits = jnp.asarray(qubits, jnp.int32)
        x, z = f.x[:, qubits], f.z[:, qubits]
    v = jnp.concatenate([x, z], axis=-1)  # [B, 2n]
    out = _mod2_matmul(v, comp.m)
    if (model.p_gate1 or model.p_gate2) and comp.s is not None:
        bits = _sampled_fault_bits(comp, model, key, f.batch)
        out = out ^ _mod2_matmul(bits, comp.s)
    n = comp.n
    x_out, z_out = out[:, :n], out[:, n:]
    if qubits is None:
        return Frames(x_out, z_out)
    return Frames(f.x.at[:, qubits].set(x_out), f.z.at[:, qubits].set(z_out))


def run_compiled_noisy_multi(f: Frames, comp: CompiledFrameCircuit,
                             model: noise_mod.NoiseModel, key,
                             windows) -> Frames:
    """Execute the SAME compiled block-local circuit on m qubit windows
    simultaneously — the parallel-EC primitive (all blocks' ancilla preps
    run in one pair of matmuls instead of m sequential executions).
    ``windows``: [m, n] static qubit indices. Noise is drawn independently
    per window (one flat [B*m] draw per gate group; frames-engine-only
    path, so no cross-engine key-consumption contract applies)."""
    windows = jnp.asarray(windows, jnp.int32)
    m = windows.shape[0]
    B = f.batch
    x, z = f.x[:, windows], f.z[:, windows]      # [B, m, n]
    v = jnp.concatenate([x, z], axis=-1)          # [B, m, 2n]
    out = _mod2_matmul(v.reshape(B * m, -1), comp.m)
    if (model.p_gate1 or model.p_gate2) and comp.s is not None:
        bits = _sampled_fault_bits(comp, model, key, B * m)
        out = out ^ _mod2_matmul(bits, comp.s)
    out = out.reshape(B, m, -1)
    n = comp.n
    return Frames(
        f.x.at[:, windows].set(out[..., :n]),
        f.z.at[:, windows].set(out[..., n:]),
    )


def inject_flips(f: Frames, qubits, x_flips, z_flips) -> Frames:
    """XOR explicit [B, m] flips into the frame at the given qubits."""
    q = jnp.asarray(qubits, jnp.int32)
    return Frames(
        f.x.at[:, q].set(f.x[:, q] ^ x_flips),
        f.z.at[:, q].set(f.z[:, q] ^ z_flips),
    )


# -- measurement / reset ---------------------------------------------------------


def measure_deviations(f: Frames, qubits, key=None, p_meas: float = 0.0):
    """Z-basis measurement of qubits whose reference outcome is
    deterministic: returns (frames, outcome deviations [B, m]) — the
    actual outcome is reference ⊕ deviation. Valid only if the measured
    qubits are reset before their next use (see module docstring)."""
    q = jnp.asarray(qubits, jnp.int32)
    outs = f.x[:, q]
    if p_meas:
        outs = noise_mod.flip_bits(outs, p_meas, key)
    return f, outs


def reset_qubits(f: Frames, qubits, key=None, p_reset: float = 0.0) -> Frames:
    """Reset to |0>: the deviation on a reset qubit is the reset-error X
    flip (probability p_reset), independent of its prior frame."""
    q = jnp.asarray(qubits, jnp.int32)
    m = q.shape[0]
    if p_reset:
        xf = jax.random.bernoulli(key, p_reset, (f.batch, m)).astype(jnp.uint8)
    else:
        xf = jnp.zeros((f.batch, m), dtype=jnp.uint8)
    zf = jnp.zeros((f.batch, m), dtype=jnp.uint8)
    return Frames(f.x.at[:, q].set(xf), f.z.at[:, q].set(zf))
