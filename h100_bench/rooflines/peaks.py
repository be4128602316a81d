"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), and the bound of a launch against them.

F32_INSTR_PER_S: 67 TFLOP/s of f32 outside the tensor cores counts an FMA
as two operations; the kernels are built with --fmad=false, so each
multiply and add is its own instruction: 33.5 T f32 instructions/s.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 33.5e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time a launch could take: bytes at the memory rate or f32
    instructions at the instruction rate, whichever is longer."""
    return max(nbytes / BYTES_PER_S, ops / F32_INSTR_PER_S)
