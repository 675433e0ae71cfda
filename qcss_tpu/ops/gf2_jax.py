"""Batched device-side GF(2) kernels (JAX/XLA).

The hot path of the framework: syndrome extraction and decoding across
millions of Monte-Carlo samples. Two complementary representations:

* **Dense matmul** — a mod-2 matmul is a 0/1 matmul followed by ``& 1``,
  in float32 at ``Precision.HIGHEST`` (exact for contraction lengths
  below 2^24; no TF32 rounding). Not int8: XLA's GPU int8 GEMM returned
  wrong sums at tiny shapes (e.g. [1024, 7] x [7, 3], the Steane
  syndrome) on an H100 with jax 0.9.0; and XLA's CPU backend has no
  bfloat16 x bfloat16 -> float32 dot in every context.
* **Bit-packed uint32** — rows packed 32 qubits/word;
  ``syndrome = parity(popcount(H & e))`` becomes AND + XOR-fold, the
  array form of the reference's per-bit emitted classical code
  (reference: quil_classical.py:60-79).

Everything here is shape-static and jit/vmap/shard_map friendly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32


# ---------------------------------------------------------------------------
# Dense (unpacked) kernels
# ---------------------------------------------------------------------------

def mod2_matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """``(a @ b) mod 2`` for 0/1 integer arrays, exact.

    Works for any leading batch dims on ``a``. Inputs may be any integer
    dtype holding 0/1; the product runs in float32 at HIGHEST precision
    (exact for a contraction length below 2^24).
    """
    if a.shape[-1] >= 1 << 24:
        raise ValueError("contraction too long for exact f32 accumulation")
    out = jax.lax.dot_general(
        a.astype(jnp.float32),
        b.astype(jnp.float32),
        dimension_numbers=(((a.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return (out.astype(jnp.int32) & 1).astype(jnp.uint8)


def syndromes_dense(errors: jax.Array, parity_check: jax.Array) -> jax.Array:
    """Syndromes ``H e^T mod 2`` for a batch of error vectors.

    errors: [..., n] 0/1; parity_check: [r, n]. Returns [..., r] uint8.
    """
    return mod2_matmul(errors, parity_check.T)


def bits_to_index(bits: jax.Array) -> jax.Array:
    """Big-endian bit vector(s) -> integer index (device analogue of
    reference: bin_matrix.py:36-43). bits: [..., r] -> [...] int32."""
    r = bits.shape[-1]
    weights = jnp.asarray(2 ** np.arange(r - 1, -1, -1), dtype=jnp.int32)
    return jnp.sum(bits.astype(jnp.int32) * weights, axis=-1)


# ---------------------------------------------------------------------------
# Bit-packed kernels
# ---------------------------------------------------------------------------

def packed_width(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def pack_bits(bits: np.ndarray | jax.Array) -> jax.Array:
    """Pack 0/1 array along the last axis into uint32 words (little-endian
    bit order within each word: bit i of word w is column ``32*w + i``)."""
    bits = jnp.asarray(bits, dtype=jnp.uint32)
    *lead, n = bits.shape
    w = packed_width(n)
    pad = w * WORD_BITS - n
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * len(lead) + [(0, pad)])
    bits = bits.reshape(*lead, w, WORD_BITS)
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(words: jax.Array, n: int) -> jax.Array:
    """Inverse of `pack_bits`: uint32 words -> [..., n] uint8 bits."""
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    bits = (words[..., :, None] >> shifts) & jnp.uint32(1)
    *lead, w, _ = bits.shape
    return bits.reshape(*lead, w * WORD_BITS)[..., :n].astype(jnp.uint8)


def parity32(x: jax.Array) -> jax.Array:
    """Bitwise parity (popcount mod 2) of each uint32 element, XOR-fold."""
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return (x & jnp.uint32(1)).astype(jnp.uint8)


def popcount32(x: jax.Array) -> jax.Array:
    """Population count of each uint32 element (SWAR)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def syndromes_packed(errors_packed: jax.Array, check_packed: jax.Array) -> jax.Array:
    """Packed syndrome extraction.

    errors_packed: [..., W] uint32 (one error per leading index);
    check_packed: [r, W] uint32. Returns [..., r] uint8 syndrome bits:
    ``parity(popcount(H_row & e))``.

    W is static and small, so the word loop unrolls into a chain of
    AND/XOR vector ops — no [batch, r, W] intermediate materializes.
    """
    w = check_packed.shape[-1]
    acc = errors_packed[..., None, 0] & check_packed[:, 0]
    for i in range(1, w):
        acc = acc ^ (errors_packed[..., None, i] & check_packed[:, i])
    return parity32(acc)


# ---------------------------------------------------------------------------
# Batched RREF (device)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def rref_batched(mats: jax.Array) -> jax.Array:
    """Reduced row echelon form over GF(2) for a batch of dense 0/1 matrices.

    mats: [B, m, n] uint8. Branch-free column sweep: at each column, the
    first row >= r with a 1 is selected by argmax over a masked column,
    conditionally swapped into position r, and XOR-broadcast to clear the
    column. Same canonical form as `ops.gf2.rref` / the reference
    (reference: bin_matrix.py:8-34).
    """
    mats = mats.astype(jnp.uint8)
    B, m, n = mats.shape
    row_ids = jnp.arange(m, dtype=jnp.int32)

    def col_step(c, state):
        mat, r = state  # mat: [B, m, n], r: [B] int32
        col = mat[:, :, c].astype(jnp.int32)  # [B, m]
        avail = row_ids[None, :] >= r[:, None]  # rows >= r
        masked = jnp.where(avail, col, 0)
        has_pivot = jnp.any(masked == 1, axis=1)  # [B]
        pivot_row = jnp.argmax(masked, axis=1)  # first 1 among avail

        # Add pivot row into row r where mat[b, r, c] == 0 (conditional on
        # having a pivot at all).
        prow = jnp.take_along_axis(mat, pivot_row[:, None, None].astype(jnp.int32), axis=1)  # [B,1,n]
        r_val = jnp.take_along_axis(col, r[:, None], axis=1)[:, 0]  # mat[b, r, c]
        need_add = has_pivot & (r_val == 0)
        add_mask = (row_ids[None, :] == r[:, None]) & need_add[:, None]
        mat = mat ^ (add_mask[:, :, None] * prow)

        # Eliminate: every row != r with a 1 in column c gets row r added.
        rrow = jnp.take_along_axis(mat, r[:, None, None].astype(jnp.int32), axis=1)  # [B,1,n]
        colv = mat[:, :, c]
        elim = (colv == 1) & (row_ids[None, :] != r[:, None]) & has_pivot[:, None]
        mat = mat ^ (elim[:, :, None] * rrow)

        r = r + has_pivot.astype(jnp.int32)
        return mat, r

    mats, _ = jax.lax.fori_loop(0, n, col_step, (mats, jnp.zeros(B, jnp.int32)))
    return mats
