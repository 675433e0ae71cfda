"""GF(2) linear-algebra kernels.

Two tiers:

* `qcss_tpu.ops.gf2` — exact host-side (numpy) kernels used at
  code-construction time. Results are bit-exact against the reference
  (reference: bin_matrix.py, css_code.py:809-850).
* `qcss_tpu.ops.gf2_jax` — batched device kernels (XLA) for the hot path:
  mod-2 matmul, bit-packed popcount-parity matmul,
  batched RREF.
"""

from qcss_tpu.ops import gf2, gf2_jax

__all__ = ["gf2", "gf2_jax"]
