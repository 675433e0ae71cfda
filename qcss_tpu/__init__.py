"""qcss_tpu — an accelerator-native framework for fault-tolerant quantum
computation with CSS quantum error-correcting codes.

Built from scratch in JAX/XLA with the capabilities of the reference
library ``jimpo/quantum-css-codes`` (pure-Python pyQuil + Forest QVM), but
re-designed device-first:

* GF(2) linear algebra runs both as exact host kernels (code construction)
  and as batched / bit-packed XLA device kernels (the hot path).
* The external Forest QVM process is replaced by an in-process, batched
  CHP stabilizer-tableau simulator (`qcss_tpu.sim`).
* The reference's emitted Quil classical-decode instruction streams
  (reference: quil_classical.py, css_code.py:649-713) are replaced by
  vectorized syndrome extraction + lookup-table decoding across millions
  of Monte-Carlo noise samples per chip (`qcss_tpu.decode`).
* FT protocols (repeat-until-success preparation, Steane error correction,
  2t+1 majority-vote logical measurement — reference: css_code.py:314-646)
  execute as masked, batched array programs under `jax.jit`.
* Multi-chip scaling is sample-axis data parallelism over a
  `jax.sharding.Mesh` (`qcss_tpu.parallel`).
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache: heavy compiles (FT executors 20-60 s,
# streaming pipelines 2-8 min, the device-OSD kernel ~36 s) are paid once
# per (program, topology) across ALL processes instead of per process.
# A cache miss or deserialization failure falls back to a normal compile.
# The cache lives where JAX_COMPILATION_CACHE_DIR says, else at the fixed
# path <repo>/.xla_cache (the path is part of the cache key, so it must
# not move between runs). Opt out with QCSS_NO_COMPILE_CACHE=1.
if not _os.environ.get("QCSS_NO_COMPILE_CACHE"):
    _jax.config.update("jax_compilation_cache_dir", _os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".xla_cache")))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

from qcss_tpu.errors import (
    InvalidCodeError,
    UnsupportedGateError,
    UnsupportedProgramError,
    UnsupportedQECCError,
)
from qcss_tpu.codes.css import CSSCode
from qcss_tpu.codes import families
from qcss_tpu.circuits.ir import Circuit, Program
from qcss_tpu import (
    circuits,
    codes,
    decode,
    experiments,
    ftqc,
    ops,
    parallel,
    sim,
    utils,
)

__version__ = "0.1.0"

__all__ = [
    "CSSCode",
    "Circuit",
    "Program",
    "families",
    "InvalidCodeError",
    "UnsupportedGateError",
    "UnsupportedProgramError",
    "UnsupportedQECCError",
    "circuits",
    "codes",
    "decode",
    "experiments",
    "ftqc",
    "ops",
    "parallel",
    "sim",
    "utils",
]
