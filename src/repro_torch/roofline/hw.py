"""Target-hardware constants: one NVIDIA H100 SXM (NVIDIA data sheet, dense
rates without sparsity, at the full 700 W power limit).

Used only to compute kernel bounds (the least time the card could take for a
given number of bytes and operations). A card set below 700 W runs slower,
so every measured time is reported beside ``nvidia-smi``'s power limit.
"""
from __future__ import annotations

PEAK_FLOPS = {                # FLOP/s by operand type
    "bfloat16": 989e12,       # tensor cores, dense
    "float32": 67e12,         # CUDA cores (full fp32, TF32 off)
}
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80 * 10**9        # device memory


def bound_seconds(flops: float, nbytes: float, dtype: str) -> tuple:
    """(seconds, "operations" | "bytes"): the larger of the two roofline
    times for ``flops`` operations on ``dtype`` operands and ``nbytes`` of
    device-memory traffic."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BW
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
