"""Bit-packed stabilizer tableaus: 32 qubits per uint32 word.

The unpacked engine (`sim.tableau`) stores one byte per tableau bit —
simple, fully general, fine for the 21-45 physical qubits of Steane-code
FTQC. For surface-code-scale simulation (hundreds of physical qubits) the
packed engine stores rows as uint32 words, so row operations (the heart of
CHP measurement) touch 32 qubits per vector lane, and the
Aaronson-Gottesman phase function is evaluated bit-sliced:

    g-sum = popcount(plus-mask) - popcount(minus-mask)   (mod 4)

with the plus/minus masks built from the same case analysis as the
unpacked `_g_exponent`, word-parallel. This is the device analogue of the
bit-packed tableau layout used by CPU stabilizer simulators (the reference
has no simulator of its own at all — it ships states to an external QVM,
reference: test/test_ftqc.py:153-156).

Layout: x, z are [B, 2n, W] uint32 (W = ceil(n/32), bit q%32 of word q//32),
r is [B, 2n] uint8. All gate/measure entry points accept traced qubit
indices, mirroring `sim.tableau`.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from qcss_tpu.ops.gf2_jax import popcount32

WORD = 32


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["x", "z", "r"],
    meta_fields=["n"],
)
@dataclasses.dataclass(frozen=True)
class PackedTableau:
    x: jax.Array  # [B, 2n, W] uint32
    z: jax.Array  # [B, 2n, W] uint32
    r: jax.Array  # [B, 2n] uint8
    n: int        # logical qubit count (static; W may include padding)

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def words(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw) -> "PackedTableau":
        return dataclasses.replace(self, **kw)


def zero_state(batch: int, n: int) -> PackedTableau:
    """|0>^n: destabilizer i = X_i, stabilizer i = Z_i."""
    w = (n + WORD - 1) // WORD
    rows = jnp.arange(n)
    words = (rows // WORD)[:, None] == jnp.arange(w)[None, :]
    bits = (jnp.uint32(1) << (rows % WORD).astype(jnp.uint32))[:, None]
    eye = jnp.where(words, bits, jnp.uint32(0))  # [n, W]
    zeros = jnp.zeros((n, w), jnp.uint32)
    x = jnp.broadcast_to(jnp.concatenate([eye, zeros], 0), (batch, 2 * n, w))
    z = jnp.broadcast_to(jnp.concatenate([zeros, eye], 0), (batch, 2 * n, w))
    return PackedTableau(x, z, jnp.zeros((batch, 2 * n), jnp.uint8), n)


def from_unpacked(t) -> PackedTableau:
    from qcss_tpu.ops import gf2_jax

    return PackedTableau(
        gf2_jax.pack_bits(t.x), gf2_jax.pack_bits(t.z), t.r, t.n
    )


def to_unpacked(t: PackedTableau):
    from qcss_tpu.ops import gf2_jax
    from qcss_tpu.sim.tableau import Tableau

    return Tableau(
        gf2_jax.unpack_bits(t.x, t.n), gf2_jax.unpack_bits(t.z, t.n), t.r
    )


# ---------------------------------------------------------------------------
# Bit addressing helpers (q may be traced)
# ---------------------------------------------------------------------------

def _addr(q):
    q = jnp.asarray(q, jnp.int32)
    return q // WORD, (q % WORD).astype(jnp.uint32)


def _get_word(arr, w):
    """arr [B, 2n, W], w traced scalar -> [B, 2n]."""
    return jnp.take(arr, w, axis=-1)


def _col_bit(arr, q):
    w, b = _addr(q)
    return ((_get_word(arr, w) >> b) & jnp.uint32(1)).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def apply_h(t: PackedTableau, q) -> PackedTableau:
    w, b = _addr(q)
    m = jnp.uint32(1) << b
    xw, zw = _get_word(t.x, w), _get_word(t.z, w)
    r = t.r ^ (((xw & zw) >> b) & 1).astype(jnp.uint8)
    diff = (xw ^ zw) & m
    return t.replace(
        x=t.x.at[:, :, w].set(xw ^ diff),
        z=t.z.at[:, :, w].set(zw ^ diff),
        r=r,
    )


def apply_s(t: PackedTableau, q) -> PackedTableau:
    w, b = _addr(q)
    xw, zw = _get_word(t.x, w), _get_word(t.z, w)
    m = jnp.uint32(1) << b
    r = t.r ^ (((xw & zw) >> b) & 1).astype(jnp.uint8)
    return t.replace(z=t.z.at[:, :, w].set(zw ^ (xw & m)), r=r)


def apply_x(t: PackedTableau, q) -> PackedTableau:
    return t.replace(r=t.r ^ _col_bit(t.z, q))


def apply_z(t: PackedTableau, q) -> PackedTableau:
    return t.replace(r=t.r ^ _col_bit(t.x, q))


def apply_y(t: PackedTableau, q) -> PackedTableau:
    return t.replace(r=t.r ^ _col_bit(t.x, q) ^ _col_bit(t.z, q))


def apply_cnot(t: PackedTableau, c, q) -> PackedTableau:
    wc, bc = _addr(c)
    wt, bt = _addr(q)
    xc = (_get_word(t.x, wc) >> bc) & 1
    zc = (_get_word(t.z, wc) >> bc) & 1
    xt = (_get_word(t.x, wt) >> bt) & 1
    zt = (_get_word(t.z, wt) >> bt) & 1
    r = t.r ^ (xc & zt & (xt ^ zc ^ 1)).astype(jnp.uint8)
    x = t.x.at[:, :, wt].set(_get_word(t.x, wt) ^ (xc << bt))
    # NOTE: read z's word AFTER x update is irrelevant (different arrays).
    z = t.z.at[:, :, wc].set(_get_word(t.z, wc) ^ (zt << bc))
    return t.replace(x=x, z=z, r=r)


def apply_cz(t: PackedTableau, a, b_q) -> PackedTableau:
    wa, ba = _addr(a)
    wb, bb = _addr(b_q)
    xa = (_get_word(t.x, wa) >> ba) & 1
    za = (_get_word(t.z, wa) >> ba) & 1
    xb = (_get_word(t.x, wb) >> bb) & 1
    zb = (_get_word(t.z, wb) >> bb) & 1
    r = t.r ^ (xa & xb & (za ^ zb)).astype(jnp.uint8)
    z = t.z.at[:, :, wa].set(_get_word(t.z, wa) ^ (xb << ba))
    z = z.at[:, :, wb].set(jnp.take(z, wb, axis=-1) ^ (xa << bb))
    return t.replace(z=z, r=r)


_SCAN_BRANCHES = (
    lambda t, a, b: t,
    lambda t, a, b: apply_x(t, a),
    lambda t, a, b: apply_y(t, a),
    lambda t, a, b: apply_z(t, a),
    lambda t, a, b: apply_h(t, a),
    lambda t, a, b: apply_s(t, a),
    lambda t, a, b: apply_cnot(t, a, b),
    lambda t, a, b: apply_cz(t, a, b),
)


def run_circuit_scanned(t: PackedTableau, ops, q0, q1) -> PackedTableau:
    def body(carry, xs):
        op, a, b = xs
        return jax.lax.switch(op, _SCAN_BRANCHES, carry, a, b), None

    xs = (jnp.asarray(ops, jnp.int32), jnp.asarray(q0, jnp.int32),
          jnp.asarray(q1, jnp.int32))
    t, _ = jax.lax.scan(body, t, xs)
    return t


def run_circuit(t: PackedTableau, circuit) -> PackedTableau:
    ops, q0, q1 = circuit.to_arrays()
    return run_circuit_scanned(t, ops, q0, q1)


def apply_pauli_frame(t: PackedTableau, x_flips_packed, z_flips_packed) -> PackedTableau:
    """Inject packed Pauli flips ([B, W] uint32 each): each row's sign flips
    by the parity of its anticommuting positions — per-word popcounts summed
    over words, reduced mod 2."""
    anti = (
        jnp.sum(popcount32(t.z & x_flips_packed[:, None, :]), axis=-1)
        + jnp.sum(popcount32(t.x & z_flips_packed[:, None, :]), axis=-1)
    ) & 1
    return t.replace(r=t.r ^ anti.astype(jnp.uint8))


def select(mask, new: PackedTableau, old: PackedTableau) -> PackedTableau:
    m2 = mask[:, None].astype(bool)
    m3 = mask[:, None, None].astype(bool)
    return PackedTableau(
        jnp.where(m3, new.x, old.x),
        jnp.where(m3, new.z, old.z),
        jnp.where(m2, new.r, old.r),
        old.n,
    )


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _g_sum_words(x1, z1, x2, z2):
    """Bit-sliced Aaronson-Gottesman phase sum: sum over qubit positions of
    g(x1, z1, x2, z2), where inputs are packed words. Returns int32 with
    the same leading shape (P - M, each position contributing -1/0/+1).

    Case analysis identical to `tableau._g_exponent`:
      source Y (x1 z1): +1 where target is Z-only, -1 where X-only
      source X        : +1 where target is Y,     -1 where Z-only
      source Z        : +1 where target is X-only, -1 where Y
    """
    nx1, nz1 = ~x1, ~z1
    nx2, nz2 = ~x2, ~z2
    plus = (x1 & z1 & z2 & nx2) | (x1 & nz1 & x2 & z2) | (nx1 & z1 & x2 & nz2)
    minus = (x1 & z1 & x2 & nz2) | (x1 & nz1 & nx2 & z2) | (nx1 & z1 & x2 & z2)
    return (
        jnp.sum(popcount32(plus), axis=-1) - jnp.sum(popcount32(minus), axis=-1)
    )


def measure_z(t: PackedTableau, q, key: jax.Array):
    """Batched Z measurement, packed rows — same branch-masked algorithm as
    `tableau.measure_z`, with rowsums over words."""
    B, two_n, W = t.x.shape
    n = t.n
    row_ids = jnp.arange(two_n, dtype=jnp.int32)

    xq = _col_bit(t.x, q)  # [B, 2n]
    stab_anti = xq[:, n:] == 1
    is_random = jnp.any(stab_anti, axis=1)

    # ---- random branch ----
    p_row = n + jnp.argmax(stab_anti, axis=1).astype(jnp.int32)
    idx = p_row[:, None, None]
    px = jnp.take_along_axis(t.x, idx, axis=1)  # [B, 1, W]
    pz = jnp.take_along_axis(t.z, idx, axis=1)
    pr = jnp.take_along_axis(t.r, p_row[:, None], axis=1)[:, 0]

    targets = (xq == 1) & (row_ids[None, :] != p_row[:, None])
    g = _g_sum_words(px, pz, t.x, t.z)  # [B, 2n]
    r4 = (2 * t.r.astype(jnp.int32) + 2 * pr.astype(jnp.int32)[:, None] + g) % 4
    new_r = jnp.where(targets, (r4 // 2).astype(jnp.uint8), t.r)
    new_x = jnp.where(targets[:, :, None], t.x ^ px, t.x)
    new_z = jnp.where(targets[:, :, None], t.z ^ pz, t.z)

    dest = row_ids[None, :] == (p_row - n)[:, None]
    new_x = jnp.where(dest[:, :, None], px, new_x)
    new_z = jnp.where(dest[:, :, None], pz, new_z)
    new_r = jnp.where(dest, pr[:, None], new_r)

    rand_bit = jax.random.bernoulli(key, 0.5, (B,)).astype(jnp.uint8)
    at_p = row_ids[None, :] == p_row[:, None]
    w, b = _addr(q)
    zq_word = jnp.where(
        jnp.arange(W)[None, None, :] == w, jnp.uint32(1) << b, jnp.uint32(0)
    )
    new_x = jnp.where(at_p[:, :, None], jnp.zeros_like(new_x), new_x)
    new_z = jnp.where(at_p[:, :, None], zq_word, new_z)
    new_r = jnp.where(at_p, rand_bit[:, None], new_r)
    random_state = PackedTableau(new_x, new_z, new_r, n)

    # ---- deterministic branch ----
    # Closed-form commuting-product phase (see sim.tableau.measure_z): the
    # ordered pair term needs only its parity, so the exclusive prefix of
    # masked z rows is a cumulative XOR — a log-depth associative scan over
    # packed words instead of a sequential row accumulation.
    m = (xq[:, :n] == 1)  # [B, n] selected stabilizer rows
    m_words = m[:, :, None].astype(jnp.uint32)
    sx = t.x[:, n:, :] * m_words
    sz = t.z[:, n:, :] * m_words
    prefix_incl = jax.lax.associative_scan(jnp.bitwise_xor, sz, axis=1)
    prefix_excl = prefix_incl ^ sz
    pair_parity = (
        jnp.sum(popcount32(sx & prefix_excl), axis=(1, 2)) & 1
    ).astype(jnp.int32)
    y = jnp.sum(popcount32(t.x[:, n:, :] & t.z[:, n:, :]), axis=-1)
    base = jnp.sum(
        m.astype(jnp.int32) * (2 * t.r[:, n:].astype(jnp.int32) + y), axis=1
    )
    det_outcome = (((base + 2 * pair_parity) % 4) // 2).astype(jnp.uint8)

    outcome = jnp.where(is_random, rand_bit, det_outcome)
    state = select(is_random, random_state, t)
    return state, outcome


def reset_z(t: PackedTableau, q, key: jax.Array) -> PackedTableau:
    t, outcome = measure_z(t, q, key)
    return select(outcome, apply_x(t, q), t)


def measure_many(t: PackedTableau, qubits, key: jax.Array):
    q = jnp.asarray(qubits, dtype=jnp.int32)
    keys = jax.random.split(key, q.shape[0])

    def body(carry, xs):
        qq, kk = xs
        carry, out = measure_z(carry, qq, kk)
        return carry, out

    t, outs = jax.lax.scan(body, t, (q, keys))
    return t, outs.T


def reset_many(t: PackedTableau, qubits, key: jax.Array) -> PackedTableau:
    q = jnp.asarray(qubits, dtype=jnp.int32)
    keys = jax.random.split(key, q.shape[0])

    def body(carry, xs):
        qq, kk = xs
        return reset_z(carry, qq, kk), None

    t, _ = jax.lax.scan(body, t, (q, keys))
    return t
