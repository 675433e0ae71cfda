"""Fault-tolerant quantum computation: the FT transpiler and its batched
execution engine.

The reference's flagship entry point `rewrite_program` metaprograms a huge
Quil program (FT preparation loops, per-gate Steane error correction,
unrolled classical decode tables, 2t+1 majority-vote measurement) which an
external QVM then interprets (reference: ftqc.py:42-120). The device-native
inversion: `rewrite_program` here produces an `EncodedProgram` whose
execution *is* a traced, batched JAX computation — quantum state evolution
on the in-process tableau simulator, classical decoding as array ops, FT
repeat-until-success loops as `lax.while_loop` with per-sample masking —
so thousands of shots run as one compiled program on device.
"""

from qcss_tpu.ftqc.executor import CodeBlock, ExecState, FTProtocols
from qcss_tpu.ftqc.rewrite import EncodedProgram, rewrite_program, run_program

__all__ = [
    "CodeBlock",
    "ExecState",
    "FTProtocols",
    "EncodedProgram",
    "rewrite_program",
    "run_program",
]
