"""Vectorized syndrome-table decoding.

The reference decodes by emitting, for every (syndrome, correction) table
entry, a bit-serial ``string_match`` + ``conditional_xor`` straight-line
block into the Quil program — O(2^r * n) instructions per decode
(reference: css_code.py:676-682, quil_classical.py:81-111). The device
form is one mod-2 matmul (syndrome extraction), one weighted sum
(syndrome bits -> table index) and one gather (correction lookup), batched
over millions of samples.
"""

import jax
import jax.numpy as jnp

from qcss_tpu.ops import gf2_jax


def decode_corrections(syndromes: jax.Array, lut: jax.Array) -> jax.Array:
    """Look up corrections for a batch of syndromes.

    syndromes: [..., r] 0/1; lut: [2^r, n] uint8 (zero row for unknown
    syndromes — the reference's leave-unchanged semantics). Returns
    [..., n] uint8 corrections.
    """
    idx = gf2_jax.bits_to_index(syndromes)
    return jnp.take(lut, idx, axis=0)


def correct_errors(
    measured: jax.Array,
    known_errors: jax.Array,
    parity_check: jax.Array,
    lut: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Device analogue of the reference's ``quil_classical_correct``
    (reference: css_code.py:649-685).

    Given measured codeword bits [..., n] and the known-error frame
    [..., n], computes the syndrome of (measured XOR known), looks up the
    additional correction, and returns ``(corrected_measured, new_errors)``
    where ``new_errors = known ^ correction`` and ``corrected_measured =
    measured ^ new_errors`` — exactly the reference's XOR-in / decode /
    XOR-out dance collapsed into array ops.
    """
    effective = measured ^ known_errors
    syn = gf2_jax.syndromes_dense(effective, parity_check)
    corr = decode_corrections(syn, lut)
    new_errors = known_errors ^ corr
    return measured ^ new_errors, new_errors


def detect_errors(
    measured: jax.Array,
    known_errors: jax.Array,
    check_matrix: jax.Array,
) -> jax.Array:
    """Device analogue of ``quil_classical_detect`` (reference:
    css_code.py:687-713): 1 where any syndrome bit of
    (measured XOR known_errors) is set, else 0. Returns [...] uint8."""
    syn = gf2_jax.syndromes_dense(measured ^ known_errors, check_matrix)
    return jnp.any(syn == 1, axis=-1).astype(jnp.uint8)
