"""Block-level tableau engine backends for the macro-op FTQC executor.

The macro executor manipulates whole code blocks (prep networks, transversal
layers, block measurements, Pauli-frame injections). This module provides
that block-level interface over two state representations:

* `UnpackedEngine` — byte-per-bit tableaus (`sim.tableau`); blocks are
  contiguous qubit ranges of length n. Right choice for small codes
  (Steane-scale), where packing overhead outweighs its wins.
* `PackedEngine` — uint32-word tableaus (`sim.tableau_packed`) with
  word-aligned blocks: block b occupies words [b*Wb, (b+1)*Wb), so
  transversal layers between blocks are pure word-wide XOR/AND ops with no
  per-qubit indexing at all — the payoff of packing for FT protocols on
  surface-code-sized blocks.

Both expose the same method set; block indices may be traced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qcss_tpu.ops import gf2_jax
from qcss_tpu.sim import noise as noise_mod
from qcss_tpu.sim import tableau as tb
from qcss_tpu.sim import tableau_packed as tp

WORD = 32


class UnpackedEngine:
    """Blocks are contiguous [b*n, (b+1)*n) qubit ranges, byte-per-bit."""

    def __init__(self, n: int, n_blocks: int, noise: noise_mod.NoiseModel):
        self.n = n
        self.n_blocks = n_blocks
        self.noise = noise
        self.nv = noise  # value source; swapped for a traced NoiseView
        self.stride = n

    def block_qubits(self, b) -> jax.Array:
        return jnp.asarray(b, jnp.int32) * self.stride + jnp.arange(
            self.n, dtype=jnp.int32
        )

    def zero_state(self, batch: int):
        return tb.zero_state(batch, self.n_blocks * self.stride)

    def select(self, mask, new, old):
        return tb.select(mask, new, old)

    def reset_block(self, tab, b, key):
        tab = tb.reset_many(tab, self.block_qubits(b), key)
        return tab

    def run_block_circuit(self, tab, arrays, b, key):
        """Run a block-local circuit (qubit indices in [0, n)) on block b,
        with per-gate depolarizing noise."""
        ops, q0, q1 = arrays
        off = jnp.asarray(b, jnp.int32) * self.stride
        return noise_mod.run_arrays_noisy(
            tab, jnp.asarray(ops), jnp.asarray(q0) + off, jnp.asarray(q1) + off,
            self.nv, key,
        )

    def measure_block(self, tab, b, key):
        return tb.measure_many(tab, self.block_qubits(b), key)

    def transversal_cnot(self, tab, b_ctrl, b_tgt, key):
        tab = tb.apply_cnot_many(
            tab, self.block_qubits(b_ctrl), self.block_qubits(b_tgt)
        )
        if self.noise.p_gate2:
            tab = noise_mod.depolarize2_many(
                tab, self.block_qubits(b_ctrl), self.block_qubits(b_tgt),
                self.nv.rate2, key,
            )
        return tab

    def transversal_1q(self, tab, gate: str, b, key):
        fn = {"H": tb.apply_h_many, "S": tb.apply_s_many,
              "X": tb.apply_x_many, "Z": tb.apply_z_many}[gate]
        tab = fn(tab, self.block_qubits(b))
        if self.noise.p_gate1:
            tab = noise_mod.depolarize1_many(
                tab, self.block_qubits(b), self.nv.rate1, key
            )
        return tab

    def transversal_cz(self, tab, b0, b1, key):
        tab = tb.apply_cz_many(tab, self.block_qubits(b0), self.block_qubits(b1))
        if self.noise.p_gate2:
            tab = noise_mod.depolarize2_many(
                tab, self.block_qubits(b0), self.block_qubits(b1),
                self.nv.rate2, key,
            )
        return tab

    def pauli_inject(self, tab, b, x_row, z_row, mask):
        """Masked logical-Pauli application: flips along the operator's
        support at block b (signs only)."""
        zeros = jnp.zeros((tab.batch, tab.n), dtype=jnp.uint8)
        q = self.block_qubits(b)
        xf = zeros.at[:, q].set(mask[:, None] * x_row[None, :])
        zf = zeros.at[:, q].set(mask[:, None] * z_row[None, :])
        return tb.apply_pauli_frame(tab, xf, zf)

    def depolarize_block(self, tab, b, p, key):
        return noise_mod.depolarize1_many(tab, self.block_qubits(b), p, key)

    def inject_block_flips(self, tab, b, x_flips, z_flips):
        """Per-sample [B, n] Pauli flips on block b (noise injection)."""
        zeros = jnp.zeros((tab.batch, tab.n), dtype=jnp.uint8)
        q = self.block_qubits(b)
        return tb.apply_pauli_frame(
            tab, zeros.at[:, q].set(x_flips), zeros.at[:, q].set(z_flips)
        )

    def inject_data_flips(self, tab, x_flips, z_flips):
        """[B, m, n] Pauli flips on the first m blocks at once (the idle
        channel's injection point; data blocks are the block prefix)."""
        B, m, n = x_flips.shape
        pad = tab.n - m * self.stride
        xf = jnp.pad(x_flips.reshape(B, m * n), ((0, 0), (0, pad)))
        zf = jnp.pad(z_flips.reshape(B, m * n), ((0, 0), (0, pad)))
        return tb.apply_pauli_frame(tab, xf, zf)


class PackedEngine:
    """Word-aligned packed blocks: block b owns words [b*Wb, (b+1)*Wb)."""

    def __init__(self, n: int, n_blocks: int, noise: noise_mod.NoiseModel):
        self.n = n
        self.n_blocks = n_blocks
        self.noise = noise
        self.nv = noise  # value source; swapped for a traced NoiseView
        self.wb = (n + WORD - 1) // WORD  # words per block
        self.stride = self.wb * WORD      # qubits per block slot (padded)

    def block_qubits(self, b) -> jax.Array:
        return jnp.asarray(b, jnp.int32) * self.stride + jnp.arange(
            self.n, dtype=jnp.int32
        )

    def zero_state(self, batch: int):
        return tp.zero_state(batch, self.n_blocks * self.stride)

    def select(self, mask, new, old):
        return tp.select(mask, new, old)

    def reset_block(self, tab, b, key):
        return tp.reset_many(tab, self.block_qubits(b), key)

    # -- packed noise helpers ----------------------------------------------------

    def _word_off(self, b):
        return jnp.asarray(b, jnp.int32) * self.wb

    def _inject_packed(self, tab, b, xw, zw):
        """xw/zw: [B, Wb] packed flips for block b."""
        B = tab.batch
        W = tab.words
        zeros = jnp.zeros((B, W), jnp.uint32)
        off = self._word_off(b)
        xf = jax.lax.dynamic_update_slice(zeros, xw, (jnp.int32(0), off))
        zf = jax.lax.dynamic_update_slice(zeros, zw, (jnp.int32(0), off))
        return tp.apply_pauli_frame(tab, xf, zf)

    def inject_block_flips(self, tab, b, x_flips, z_flips):
        return self._inject_packed(
            tab, b, gf2_jax.pack_bits(x_flips), gf2_jax.pack_bits(z_flips)
        )

    def inject_data_flips(self, tab, x_flips, z_flips):
        """[B, m, n] flips on the first m blocks (idle injection): pack
        per block (blocks are word-aligned), place at word offset 0."""
        B, m, n = x_flips.shape
        xw = gf2_jax.pack_bits(x_flips).reshape(B, m * self.wb)
        zw = gf2_jax.pack_bits(z_flips).reshape(B, m * self.wb)
        pad = tab.words - m * self.wb
        return tp.apply_pauli_frame(
            tab,
            jnp.pad(xw, ((0, 0), (0, pad))),
            jnp.pad(zw, ((0, 0), (0, pad))),
        )

    def _depolarize_block(self, tab, b, p, key):
        B = tab.batch
        u = jax.random.bits(key, (B, self.n), dtype=jnp.uint32)
        cap = jnp.float32(2.0**32 - 1)
        x_hi, z_lo, z_hi = noise_mod._thresholds_1q(p)

        def thresh(frac):
            return jnp.minimum(
                jnp.float32(frac) * jnp.float32(2.0**32), cap
            ).astype(jnp.uint32)

        t1, t2, t3 = thresh(z_lo), thresh(x_hi), thresh(z_hi)
        x_hit = (u < t2).astype(jnp.uint8)
        z_hit = ((u >= t1) & (u < t3)).astype(jnp.uint8)
        return self.inject_block_flips(tab, b, x_hit, z_hit)

    def _depolarize_pair_blocks(self, tab, b0, b1, p, key):
        if isinstance(p, tuple):
            # Biased (twirled-decoherence) rates act independently per qubit.
            k0, k1 = jax.random.split(key)
            tab = self._depolarize_block(tab, b0, p, k0)
            return self._depolarize_block(tab, b1, p, k1)
        B = tab.batch
        k_u, k_p = jax.random.split(key)
        hit = (
            jax.random.uniform(k_u, (B, self.n), dtype=jnp.float32) < jnp.float32(p)
        ).astype(jnp.uint8)
        pat = jax.random.randint(k_p, (B, self.n), 1, 16, dtype=jnp.int32)
        x1 = (pat & 1).astype(jnp.uint8) * hit
        z1 = ((pat >> 1) & 1).astype(jnp.uint8) * hit
        x2 = ((pat >> 2) & 1).astype(jnp.uint8) * hit
        z2 = ((pat >> 3) & 1).astype(jnp.uint8) * hit
        tab = self.inject_block_flips(tab, b0, x1, z1)
        return self.inject_block_flips(tab, b1, x2, z2)

    # -- circuits and measurement -----------------------------------------------

    def run_block_circuit(self, tab, arrays, b, key):
        ops, q0, q1 = arrays
        off = jnp.asarray(b, jnp.int32) * self.stride
        ops = jnp.asarray(ops, jnp.int32)
        q0 = jnp.asarray(q0, jnp.int32) + off
        q1 = jnp.asarray(q1, jnp.int32) + off
        if self.noise.is_trivial:
            return tp.run_circuit_scanned(tab, ops, q0, q1)
        keys = jax.random.split(key, max(int(ops.shape[0]), 1))
        two_q_start = 6  # OPCODES["CNOT"]

        def dep1_at(t, q, k, rate):
            B = t.batch
            u = jax.random.uniform(k, (B,), dtype=jnp.float32)
            x_hi, z_lo, z_hi = (
                jnp.float32(v) for v in noise_mod._thresholds_1q(rate)
            )
            x_hit = (u < x_hi).astype(jnp.uint32)
            z_hit = ((u >= z_lo) & (u < z_hi)).astype(jnp.uint32)
            w, bit = q // WORD, (q % WORD).astype(jnp.uint32)
            zeros = jnp.zeros((B, t.words), jnp.uint32)
            return tp.apply_pauli_frame(
                t, zeros.at[:, w].set(x_hit << bit), zeros.at[:, w].set(z_hit << bit)
            )

        def dep1(t, q, k):
            return dep1_at(t, q, k, self.nv.rate1)

        def dep2(t, a, b_q, k):
            rate2 = self.nv.rate2
            if isinstance(rate2, tuple):
                ka, kb = jax.random.split(k)
                return dep1_at(dep1_at(t, a, ka, rate2), b_q, kb, rate2)
            B = t.batch
            k_u, k_p = jax.random.split(k)
            hit = (
                jax.random.uniform(k_u, (B,), dtype=jnp.float32)
                < jnp.float32(rate2)
            ).astype(jnp.uint32)
            pat = jax.random.randint(k_p, (B,), 1, 16, dtype=jnp.int32).astype(jnp.uint32)
            wa, ba = a // WORD, (a % WORD).astype(jnp.uint32)
            wb, bb = b_q // WORD, (b_q % WORD).astype(jnp.uint32)
            zeros = jnp.zeros((B, t.words), jnp.uint32)
            xf = zeros.at[:, wa].set((hit * (pat & 1)) << ba)
            xf = xf.at[:, wb].set(xf[:, wb] ^ ((hit * ((pat >> 2) & 1)) << bb))
            zf = zeros.at[:, wa].set((hit * ((pat >> 1) & 1)) << ba)
            zf = zf.at[:, wb].set(zf[:, wb] ^ ((hit * ((pat >> 3) & 1)) << bb))
            return tp.apply_pauli_frame(t, xf, zf)

        def body(carry, xs):
            op, a, b_q, k = xs
            carry = jax.lax.switch(op, tp._SCAN_BRANCHES, carry, a, b_q)
            if self.noise.p_gate1 or self.noise.p_gate2:
                carry = jax.lax.cond(
                    op >= two_q_start,
                    lambda t: dep2(t, a, b_q, k),
                    lambda t: dep1(t, a, k),
                    carry,
                )
            return carry, None

        tab, _ = jax.lax.scan(body, tab, (ops, q0, q1, keys))
        return tab

    def measure_block(self, tab, b, key):
        return tp.measure_many(tab, self.block_qubits(b), key)

    # -- transversal word-ops: the packing payoff ---------------------------------

    def _block_words(self, arr, b):
        off = self._word_off(b)
        return jax.lax.dynamic_slice_in_dim(arr, off, self.wb, axis=-1)

    def _set_block_words(self, arr, b, words):
        off = self._word_off(b)
        return jax.lax.dynamic_update_slice_in_dim(arr, words, off, axis=-1)

    @staticmethod
    def _parity_words(words) -> jax.Array:
        from qcss_tpu.ops.gf2_jax import popcount32

        return (jnp.sum(popcount32(words), axis=-1) & 1).astype(jnp.uint8)

    def transversal_cnot(self, tab, b_ctrl, b_tgt, key):
        xc = self._block_words(tab.x, b_ctrl)
        zc = self._block_words(tab.z, b_ctrl)
        xt = self._block_words(tab.x, b_tgt)
        zt = self._block_words(tab.z, b_tgt)
        # Per-position sign rule xc & zt & ~(xt ^ zc); block padding bits are
        # zero in xc/zt, so the complement's padding ones are masked away.
        r = tab.r ^ self._parity_words(xc & zt & ~(xt ^ zc))
        x = self._set_block_words(tab.x, b_tgt, xt ^ xc)
        z = self._set_block_words(tab.z, b_ctrl, zc ^ zt)
        tab = tab.replace(x=x, z=z, r=r)
        if self.noise.p_gate2:
            tab = self._depolarize_pair_blocks(tab, b_ctrl, b_tgt,
                                               self.nv.rate2, key)
        return tab

    def transversal_1q(self, tab, gate: str, b, key):
        xw = self._block_words(tab.x, b)
        zw = self._block_words(tab.z, b)
        if gate == "H":
            r = tab.r ^ self._parity_words(xw & zw)
            tab = tab.replace(
                x=self._set_block_words(tab.x, b, zw),
                z=self._set_block_words(tab.z, b, xw),
                r=r,
            )
        elif gate == "S":
            r = tab.r ^ self._parity_words(xw & zw)
            tab = tab.replace(z=self._set_block_words(tab.z, b, zw ^ xw), r=r)
        elif gate == "X":
            tab = tab.replace(r=tab.r ^ self._parity_words(zw))
        elif gate == "Z":
            tab = tab.replace(r=tab.r ^ self._parity_words(xw))
        else:  # pragma: no cover
            raise ValueError(gate)
        if self.noise.p_gate1:
            tab = self._depolarize_block(tab, b, self.nv.rate1, key)
        return tab

    def transversal_cz(self, tab, b0, b1, key):
        xa = self._block_words(tab.x, b0)
        za = self._block_words(tab.z, b0)
        xb = self._block_words(tab.x, b1)
        zb = self._block_words(tab.z, b1)
        r = tab.r ^ self._parity_words(xa & xb & (za ^ zb))
        z = self._set_block_words(tab.z, b0, za ^ xb)
        z = jax.lax.dynamic_update_slice_in_dim(
            z, jax.lax.dynamic_slice_in_dim(z, self._word_off(b1), self.wb, -1) ^ xa,
            self._word_off(b1), axis=-1,
        )
        tab = tab.replace(z=z, r=r)
        if self.noise.p_gate2:
            tab = self._depolarize_pair_blocks(tab, b0, b1, self.nv.rate2, key)
        return tab

    def pauli_inject(self, tab, b, x_row, z_row, mask):
        xw = gf2_jax.pack_bits(x_row)[None, :] * mask[:, None].astype(jnp.uint32)
        zw = gf2_jax.pack_bits(z_row)[None, :] * mask[:, None].astype(jnp.uint32)
        return self._inject_packed(tab, b, xw, zw)

    def depolarize_block(self, tab, b, p, key):
        return self._depolarize_block(tab, b, p, key)


class FrameEngine:
    """Pauli-frame state (`sim.frame.Frames`) behind the same block-level
    interface as the tableau engines — the Monte-Carlo fast path for the
    FTQC executor (Stim's frame-sampler architecture, arXiv:2103.02202
    §4.2, applied to the whole FT protocol stack).

    The state holds only each sample's Pauli DEVIATION from the noiseless
    reference run, so gates cost O(1) bits/sample instead of O(rows·words)
    tableau updates. Two semantic differences from the tableau engines,
    both handled by the executor (`schedule.MacroExecutor`):

    * `pauli_inject` XORs the logical operator into the frame (intentional
      Paulis RIDE the deviation; the reference is permanently the
      Pauli-free program), which is what makes per-sample conditional
      Paulis exact;
    * `measure_block` returns outcome DEVIATIONS; the executor XORs in the
      reference outcomes it records once from a 32-sample noiseless
      tableau run (`schedule.reference_outcomes`), which also verifies
      every reference measurement is deterministic — the frame engine's
      soundness condition.
    """

    def __init__(self, n: int, n_blocks: int, noise: noise_mod.NoiseModel):
        from qcss_tpu.sim import frame as fr

        self._fr = fr
        self.n = n
        self.n_blocks = n_blocks
        self.noise = noise
        self.nv = noise  # value source; swapped for a traced NoiseView
        self.stride = n

    def block_qubits(self, b) -> jax.Array:
        return jnp.asarray(b, jnp.int32) * self.stride + jnp.arange(
            self.n, dtype=jnp.int32
        )

    def zero_state(self, batch: int):
        return self._fr.zero_frames(batch, self.n_blocks * self.stride)

    def select(self, mask, new, old):
        m = mask.astype(bool)[:, None]
        return self._fr.Frames(
            jnp.where(m, new.x, old.x), jnp.where(m, new.z, old.z)
        )

    def reset_block(self, tab, b, key):
        # Reset discards the block's deviation (the executor injects
        # p_reset flips itself, as for the tableau engines).
        return self._fr.reset_qubits(tab, self.block_qubits(b))

    def run_block_circuit(self, tab, arrays, b, key):
        ops, q0, q1 = arrays
        off = jnp.asarray(b, jnp.int32) * self.stride
        return self._fr.run_arrays_noisy(
            tab, jnp.asarray(ops), jnp.asarray(q0) + off,
            jnp.asarray(q1) + off, self.nv, key,
        )

    def compile_block_circuit(self, arrays):
        """Matrix form of a block-local circuit (host-side, once)."""
        ops, q0, q1 = arrays
        return self._fr.compile_circuit(ops, q0, q1, self.n)

    def run_compiled(self, tab, comp, b, key):
        """Compiled-circuit execution at block b — bit-identical to
        `run_block_circuit` on the same key (two matmuls instead of a
        per-gate scan; the FT-prep hot path)."""
        return self._fr.run_compiled_noisy(
            tab, comp, self.nv, key, qubits=self.block_qubits(b))

    def measure_block(self, tab, b, key):
        # Outcome deviations (reference ⊕ deviation = actual); measured
        # blocks are always reset before reuse in the FT protocols, so the
        # post-measurement phase scramble needs no modeling.
        return tab, tab.x[:, self.block_qubits(b)]

    def transversal_cnot(self, tab, b_ctrl, b_tgt, key):
        qc = self.block_qubits(b_ctrl)
        qt = self.block_qubits(b_tgt)
        tab = self._fr.Frames(
            tab.x.at[:, qt].set(tab.x[:, qt] ^ tab.x[:, qc]),
            tab.z.at[:, qc].set(tab.z[:, qc] ^ tab.z[:, qt]),
        )
        if self.noise.p_gate2:
            tab = self._fr.inject2_many(tab, qc, qt, self.nv.rate2, key)
        return tab

    def transversal_1q(self, tab, gate: str, b, key):
        q = self.block_qubits(b)
        if gate == "H":
            xq, zq = tab.x[:, q], tab.z[:, q]
            tab = self._fr.Frames(tab.x.at[:, q].set(zq), tab.z.at[:, q].set(xq))
        elif gate == "S":
            tab = self._fr.Frames(
                tab.x, tab.z.at[:, q].set(tab.z[:, q] ^ tab.x[:, q])
            )
        elif gate in ("X", "Z"):
            pass  # phase-only on deviations
        else:  # pragma: no cover
            raise ValueError(gate)
        if self.noise.p_gate1:
            tab = self._fr.inject1_many(tab, q, self.nv.rate1, key)
        return tab

    def transversal_cz(self, tab, b0, b1, key):
        qa = self.block_qubits(b0)
        qb = self.block_qubits(b1)
        z = tab.z.at[:, qa].set(tab.z[:, qa] ^ tab.x[:, qb])
        z = z.at[:, qb].set(z[:, qb] ^ tab.x[:, qa])
        tab = self._fr.Frames(tab.x, z)
        if self.noise.p_gate2:
            tab = self._fr.inject2_many(tab, qa, qb, self.nv.rate2, key)
        return tab

    def pauli_inject(self, tab, b, x_row, z_row, mask):
        # Intentional logical Paulis ride the deviation (the reference run
        # excludes them — see class docstring).
        q = self.block_qubits(b)
        m = mask.astype(jnp.uint8)[:, None]
        return self._fr.Frames(
            tab.x.at[:, q].set(tab.x[:, q] ^ m * x_row[None, :]),
            tab.z.at[:, q].set(tab.z[:, q] ^ m * z_row[None, :]),
        )

    def depolarize_block(self, tab, b, p, key):
        return self._fr.inject1_many(tab, self.block_qubits(b), p, key)

    def inject_block_flips(self, tab, b, x_flips, z_flips):
        return self._fr.inject_flips(tab, self.block_qubits(b), x_flips, z_flips)

    def inject_data_flips(self, tab, x_flips, z_flips):
        B, m, n = x_flips.shape
        q = jnp.arange(m * n, dtype=jnp.int32)
        return self._fr.inject_flips(
            tab, q, x_flips.reshape(B, m * n), z_flips.reshape(B, m * n))

    # -- multi-block primitives (the parallel-EC path; frames-only) -----------

    def blocks_qubits(self, blocks) -> "np.ndarray":
        """Static [m, n] qubit windows for a static block list."""
        import numpy as np

        blocks = np.asarray(blocks, np.int32)
        return blocks[:, None] * self.stride + np.arange(self.n, dtype=np.int32)

    def reset_blocks(self, tab, qubits):
        return self._fr.reset_qubits(tab, jnp.asarray(qubits).reshape(-1))

    def run_compiled_multi(self, tab, comp, windows, key):
        return self._fr.run_compiled_noisy_multi(
            tab, comp, self.nv, key, windows)

    def cnot_qubits(self, tab, qc, qt, key):
        """Pairwise CNOT on explicit disjoint qubit arrays (+ 2q noise)."""
        qc = jnp.asarray(qc).reshape(-1)
        qt = jnp.asarray(qt).reshape(-1)
        tab = self._fr.Frames(
            tab.x.at[:, qt].set(tab.x[:, qt] ^ tab.x[:, qc]),
            tab.z.at[:, qc].set(tab.z[:, qc] ^ tab.z[:, qt]),
        )
        if self.noise.p_gate2:
            tab = self._fr.inject2_many(tab, qc, qt, self.nv.rate2, key)
        return tab

    def h_qubits(self, tab, q, key):
        q = jnp.asarray(q).reshape(-1)
        xq, zq = tab.x[:, q], tab.z[:, q]
        tab = self._fr.Frames(tab.x.at[:, q].set(zq), tab.z.at[:, q].set(xq))
        if self.noise.p_gate1:
            tab = self._fr.inject1_many(tab, q, self.nv.rate1, key)
        return tab

    def measure_qubits(self, tab, q):
        """Outcome deviations at explicit qubits (multi-block form of
        `measure_block`; same deterministic-reference contract)."""
        return tab, tab.x[:, jnp.asarray(q).reshape(-1)]

    def select_qubits(self, tab, cols, mask, new, old):
        """Per-(sample, column) commit: for the static column set `cols`
        with per-column mask `mask` [B, len(cols)], take `new` where set."""
        cols = jnp.asarray(cols).reshape(-1)
        m = mask.astype(bool)
        return self._fr.Frames(
            old.x.at[:, cols].set(
                jnp.where(m, new.x[:, cols], old.x[:, cols])),
            old.z.at[:, cols].set(
                jnp.where(m, new.z[:, cols], old.z[:, cols])),
        )


def make_engine(
    kind: str, n: int, n_blocks: int, noise
) -> UnpackedEngine | PackedEngine | FrameEngine:
    if kind == "unpacked":
        return UnpackedEngine(n, n_blocks, noise)
    if kind == "packed":
        return PackedEngine(n, n_blocks, noise)
    if kind == "frames":
        return FrameEngine(n, n_blocks, noise)
    raise ValueError(f"unknown tableau engine {kind!r}")
