"""Roofline analysis of one dry-run cell (port of ``repro.roofline.analyze``).

Three terms per (arch, shape, mesh), on one H100's rates
(``roofline.hw``):

    compute    = FLOPs_per_device / PEAK_FLOPS[cfg.dtype]
    memory     = HBM_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / FABRIC_LINK_BW

The reference reads its costs from XLA: ``cost_analysis()`` and the
collectives parsed from the compiled HLO text. Eager PyTorch has neither,
so the port counts what one step of one rank runs (``roofline.probes``
runs the steps; ``launch.dryrun`` builds them) on tensors that hold no data
(``no_data``: fake CPU tensors, which take the kernels' plain forms):

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matmuls,
    convolutions and attention products; elementwise work is not counted);
  * bytes: ``CostCount``'s dispatch mode, which sums each op's operand and
    result bytes (views move none): what eager execution reads and writes,
    op by op, where a fused compiler's count would be smaller;
  * collective bytes and calls: the port's own ``launch.mesh.Mesh.counts``
    over the step (the bytes a rank hands each collective), which the
    port's tests hold equal to ``train.step.model_collectives`` and
    ``train.serve.serve_collectives``; ``collective_costs`` applies the
    reference's ring factors per kind for the bytes on the wire.

The collective term is a link of one node's NVLink 4 (``FABRIC_LINK_BW``);
an axis spanning nodes of 8 cards would run at ``FABRIC_DCN_BW`` instead,
which this term does not model.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import asdict, dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline import hw

# the port's collectives (``Mesh.counts``) by the reference's HLO names
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "ring_exchange": "collective-permute",
          "broadcast": "broadcast", "reduce": "reduce"}

# ops that allocate or relabel a tensor without reading or writing its bytes
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
               torch.ops.aten.detach, torch.ops.aten.alias, torch.ops.aten.lift_fresh,
               torch.ops.aten._local_scalar_dense}


@contextlib.contextmanager
def no_data():
    """A context in which new tensors hold no data: fake CPU tensors
    (``FakeTensorMode``) whose ops compute shapes and dtypes only, and on
    which the kernel wrappers take their plain CPU forms. Real tensors made
    outside (a constant from numpy) are taken as they are. The RoPE
    frequencies that ``models.layers`` keeps a copy of are dropped on entry
    and on exit, so no fake tensor outlives its mode in that cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import _rope_frequencies_on
    _rope_frequencies_on.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield
    finally:
        _rope_frequencies_on.cache_clear()


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Bytes(TorchDispatchMode):
    """Sums the operand and result bytes of every op that moves data."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out)))
        return out


class CostCount:
    """A context that counts the FLOPs (``flops``) and the operand and
    result bytes (``bytes``) of every op run within it."""

    def __enter__(self) -> "CostCount":
        self._flops = FlopCounterMode(display=False)
        self._bytes = _Bytes()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._flops)
        self._stack.enter_context(self._bytes)
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self.flops = float(self._flops.get_total_flops())
        self.bytes = float(self._bytes.bytes)


def collective_costs(counts: Dict, mesh) -> Dict:
    """The reference's ``parse_collectives`` dict from a mesh's ``counts``
    ({(collective, axes): [calls, bytes this rank handed it]}), by kind:

      * ``total_bytes``: the operand bytes (the reference's definition);
      * ``wire_bytes``: the bytes a ring moves across this device's links,
        with g the ranks of the axes: 2(g-1)/g of an all-reduce's, (g-1)
        blocks of an all-gather's (its operand is the rank's block),
        (g-1)/g of a reduce-scatter's, the whole of a ring exchange's
        (collective-permute), and (g-1)/g of a broadcast's or a reduce's
        (a pipelined chain; the reference's HLO has no such op)."""
    bytes_by_kind: Counter = Counter()
    wire_by_kind: Counter = Counter()
    count_by_kind: Counter = Counter()
    for (op, axes), (calls, nbytes) in counts.items():
        kind = _KINDS[op]
        g = max(mesh.axes_size(axes), 1)
        if kind == "all-gather":
            wire = nbytes * (g - 1)
        elif kind == "all-reduce":
            wire = 2 * nbytes * (g - 1) // g
        elif kind == "collective-permute":
            wire = nbytes
        else:
            wire = nbytes * (g - 1) // g
        bytes_by_kind[kind] += nbytes
        wire_by_kind[kind] += wire
        count_by_kind[kind] += calls
    return {
        "bytes_by_kind": dict(bytes_by_kind),
        "wire_by_kind": dict(wire_by_kind),
        "count_by_kind": dict(count_by_kind),
        "total_bytes": int(sum(bytes_by_kind.values())),
        "wire_bytes": int(sum(wire_by_kind.values())),
        "total_count": int(sum(count_by_kind.values())),
    }


@dataclass
class RooflineReport:
    """The reference's report, with ``dtype`` (the config's, which picks
    the compute term's peak rate) after its fields."""
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    hbm_bytes_per_device: float          # counted op by op (eager; reference)
    hbm_bytes_flash_adj: float           # counted minus score-tensor traffic
    hbm_bytes_model: float               # first-principles model (memory term)
    collective_bytes_per_device: float
    collective_wire_bytes: float
    peak_memory_per_device: float        # from the production step
    compute_s: float = 0.0
    memory_s: float = 0.0                # from the model's bytes
    memory_s_raw: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0             # 6*N*D train / 2*N*D inference
    useful_ratio: float = 0.0            # model_flops / (flops_per_device*n)
    roofline_fraction: float = 0.0
    collectives: Dict = field(default_factory=dict)
    fits_hbm: bool = True
    notes: str = ""
    dtype: str = "bfloat16"

    def finalize(self) -> "RooflineReport":
        peak = hw.PEAK_FLOPS[self.dtype]
        self.compute_s = self.flops_per_device / peak
        self.memory_s = self.hbm_bytes_model / hw.HBM_BW
        self.memory_s_raw = self.hbm_bytes_per_device / hw.HBM_BW
        self.collective_s = self.collective_bytes_per_device / hw.FABRIC_LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_per_device * self.n_devices
        self.useful_ratio = (self.model_flops / total_flops) if total_flops else 0.0
        # achievable fraction: time of the ideal (pure model-FLOPs) step vs.
        # the dominant roofline term of this cell
        ideal = self.model_flops / (self.n_devices * peak)
        dom = max(terms.values())
        self.roofline_fraction = (ideal / dom) if dom > 0 else 0.0
        self.fits_hbm = self.peak_memory_per_device <= hw.HBM_BYTES
        return self

    def to_dict(self) -> Dict:
        return asdict(self)


def attention_score_bytes(cfg, shape, n_devices: int) -> float:
    """Analytic per-device HBM traffic of the dense-form (Sq x Skv) score
    tensors that the production blockwise/flash form never materializes.
    Convention: 4 accesses/elt fp32 forward; x3 for train (remat re-fwd +
    dscore traffic). Decode has no score materialization worth adjusting."""
    if shape.kind == "decode":
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    acc = 4 * (3 if shape.kind == "train" else 1) * 4  # accesses x bytes
    elems = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        elems = cfg.num_layers * b * cfg.num_heads * float(s) * s
    elif cfg.family == "encdec":
        se = cfg.encoder_seq
        elems = (cfg.encoder_layers * b * cfg.num_heads * float(se) * se
                 + cfg.num_layers * b * cfg.num_heads * (float(s) * s +
                                                         float(s) * se))
    elif cfg.family in ("ssm", "hybrid"):
        lc = cfg.ssm_chunk
        nc = (s + lc - 1) // lc
        elems = cfg.num_layers * b * cfg.ssm_heads * nc * float(lc) * lc
        if cfg.family == "hybrid":
            n_attn = sum(1 for k in cfg.layer_kinds() if k == "mamba_attn")
            elems += n_attn * b * cfg.num_heads * float(s) * s
    return acc * elems / n_devices


def analyze_from_costs(costs: Dict, peak_memory: float, *, arch: str, shape,
                       mesh_name: str, n_devices: int, model_flops: float,
                       cfg=None, hbm_model_bytes: float = 0.0,
                       notes: str = "") -> RooflineReport:
    """The report from probe-extrapolated costs (``roofline.probes``).
    ``peak_memory`` is the largest live bytes of one rank over the dry-run's
    production step (``launch.dryrun``), where the reference reads XLA's
    ``memory_analysis()`` of its production compile."""
    raw_bytes = float(costs["bytes"])
    adj = attention_score_bytes(cfg, shape, n_devices) if cfg is not None else 0.0
    rep = RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=float(costs["flops"]),
        hbm_bytes_per_device=raw_bytes,
        hbm_bytes_flash_adj=max(raw_bytes - adj, 0.0),
        hbm_bytes_model=float(hbm_model_bytes) or max(raw_bytes - adj, 0.0),
        collective_bytes_per_device=float(costs["coll_bytes"]),
        collective_wire_bytes=float(costs["wire_bytes"]),
        peak_memory_per_device=float(peak_memory),
        model_flops=float(model_flops),
        collectives={"extrapolated_count": costs["coll_count"]},
        notes=notes,
        dtype=cfg.dtype if cfg is not None else "bfloat16",
    )
    return rep.finalize()
