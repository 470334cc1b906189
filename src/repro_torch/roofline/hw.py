"""Target-hardware constants: one NVIDIA H100 SXM (NVIDIA data sheet, dense
rates without sparsity, at the full 700 W power limit), and the links of an
H100 cluster.

The card's rates are used only to compute bounds (the least time the card
could take for a given number of bytes and operations). A card set below
700 W runs slower, so every measured time is reported beside
``nvidia-smi``'s power limit.
"""
from __future__ import annotations

PEAK_FLOPS = {                # FLOP/s by operand type
    "bfloat16": 989e12,       # tensor cores, dense
    "float32": 67e12,         # CUDA cores (full fp32, TF32 off)
}
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80 * 10**9        # device memory

# The host link of an H100 SXM: PCIe Gen5 x16, 64 GB/s each way (NVIDIA H100
# data sheet). The bound of the instant checkpoint's copy of the optimizer
# state off the card.
HOST_LINK_BW = 64e9           # bytes/s, one direction

# Defaults of the simulated fabric (``runtime.cluster.FabricConfig``), taken
# from an H100 cluster: an edge between two cards of one node is NVLink 4,
# 900 GB/s per card in all, 450 GB/s each way (NVIDIA H100 data sheet); an
# edge between nodes (a "pod" of the simulation) is one NDR InfiniBand port,
# 400 Gb/s = 50 GB/s each way (NVIDIA ConnectX-7 / Quantum-2 NDR). The
# simulation moves its bytes on these modeled links: a time it reports is a
# simulated time, never a measurement of the card or of a network.
FABRIC_LINK_BW = 450e9        # bytes/s, one direction of one NVLink 4 edge
FABRIC_DCN_BW = 50e9          # bytes/s, one NDR InfiniBand port


def bound_seconds(flops: float, nbytes: float, dtype: str) -> tuple:
    """(seconds, "operations" | "bytes"): the larger of the two roofline
    times for ``flops`` operations on ``dtype`` operands and ``nbytes`` of
    device-memory traffic."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BW
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
