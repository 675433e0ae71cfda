"""Multi-chip scaling: sample-axis data parallelism over a device mesh.

The reference's only batching mechanism is the QVM numshots loop inside a
single external simulator process (reference: test/test_fidelity.py:67);
its only IPC is pyquil->QVM RPC. The device-native replacement is
`jax.sharding` + `shard_map` over a 1-D device mesh with XLA collectives — each
chip samples, extracts and decodes its own shard of the Monte-Carlo batch
and failure counts are combined with a single `psum`.
"""

from qcss_tpu.parallel.mesh import (
    ShardedFrameMemory,
    make_mesh,
    sharded_bp_memory,
    sharded_ftqc_run,
    sharded_logical_error_rate,
    sharded_logical_program,
    sharded_magic_factory,
    sharded_mc_step,
    sharded_qldpc_circuit_memory,
    sharded_mld_memory,
    sharded_parallel_window_memory,
    sharded_soft_memory,
    sharded_two_level_memory,
)

__all__ = [
    "ShardedFrameMemory",
    "make_mesh",
    "sharded_bp_memory",
    "sharded_ftqc_run",
    "sharded_logical_error_rate",
    "sharded_logical_program",
    "sharded_magic_factory",
    "sharded_mc_step",
    "sharded_qldpc_circuit_memory",
    "sharded_mld_memory",
    "sharded_parallel_window_memory",
    "sharded_soft_memory",
    "sharded_two_level_memory",
]
