"""Checkpoint razor (paper §4.2): the unique training state that each worker
must back up every iteration.

Only the paper's Adam arithmetic is ported so far (``razor_bytes_formula``,
the port's copy of ``repro.core.razor.razor_bytes_formula``). The
reference's ``razor_plan`` classifies each leaf of the train state by its
``PartitionSpec`` on a device mesh; the port has no mesh yet, and
``razor_plan`` waits for multi-device training (ROADMAP §1 item 9).
"""
from __future__ import annotations


def razor_bytes_formula(phi: int, dp: int) -> int:
    """Paper's Adam arithmetic: unique bytes per DP group = 12*phi/d per device
    (fp32 master + m + v, each 4 bytes, ZeRO-sharded d ways)."""
    return 12 * phi // max(dp, 1)
