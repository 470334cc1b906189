"""First-principles per-device HBM traffic model for the memory roofline term
(port of ``repro.roofline.memory_model``).

Why a model: a compiler's post-compile "bytes accessed" reflects its fusion
decisions, not the card's traffic, so the memory term is derived from the
workload itself:

  * parameter / optimizer / cache bytes are EXACT per-device values computed
    from the meta tensors of the state and their PartitionSpecs;
  * activation streams are counted as tensor passes over the residual stream
    and block-local intermediates (weight-stationary execution, flash-style
    attention with no score materialization), with remat re-reads included.

The recompute it charges is the config's ``remat_policy``, which the port's
layers honour (``models.modes.run_layer``) as the reference's do, but for
one deliberate departure: under FSDP a layer body is recomputed whatever
the policy (its gathered weights must not stay saved for every layer), so
a train cell with FSDP and "none" recomputes where this model counts no
re-read.

Everything here is arithmetic on shapes: ``mesh`` is any object with
``.shape`` (axis name -> size), ``.axis_names`` and ``.size``, as the port's
process-less ``launch.mesh.Mesh(axes, sizes)`` is, and the models are built
on the meta device. The arithmetic keeps the reference's order, so the
floats equal its.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.parallel import sharding as shd
from repro_torch.tree import tree_flatten

PyTree = Any


def _spec_div(pspec, mesh) -> int:
    div = 1
    for part in pspec:
        if part is None:
            continue
        parts = part if isinstance(part, (tuple, list)) else (part,)
        for a in parts:
            div *= mesh.shape[a]
    return div


def sharded_bytes(specs: PyTree, pspecs: PyTree, mesh) -> int:
    """Exact per-device bytes of a sharded tree of meta tensors: each leaf's
    bytes over the product of the mesh axes its PartitionSpec names (a
    ``None`` spec: the whole leaf)."""
    leaves, _ = tree_flatten(specs)
    ps_leaves, _ = tree_flatten(pspecs, lambda x: x is None or shd.is_spec(x))
    if len(leaves) != len(ps_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(ps_leaves)} PartitionSpecs")
    total = 0
    for leaf, ps in zip(leaves, ps_leaves):
        n = math.prod(leaf.shape) * leaf.element_size()
        total += n // max(_spec_div(ps, mesh), 1) if ps is not None else n
    return total


def _activation_traffic(cfg: ArchConfig, shape: ShapeConfig, mesh,
                        *, train: bool) -> float:
    """Per-device activation HBM bytes for one full forward (+backward)."""
    dp = math.prod([mesh.shape[a] for a in ("pod", "data") if a in mesh.axis_names])
    tp = mesh.shape.get("model", 1)
    b, s = shape.global_batch, shape.seq_len
    t_loc = b * s / dp                      # tokens per device
    d = cfg.d_model
    bt = 2.0                                # bf16

    def shard(n, k):                        # shard dim n over tp if divisible
        return n / tp if (n % tp == 0 and n >= tp) else n

    passes = 0.0
    l = cfg.num_layers  # noqa: E741 (the reference's name)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        hd = cfg.resolved_head_dim
        qkv = shard(cfg.num_heads, tp) * hd + 2 * shard(cfg.num_kv_heads, tp) * hd
        # residual x: read by ln1/ln2 + written by attn/mlp adds (4 passes)
        per_layer = 4 * d
        # attention: q/k/v write+read, flash kv re-read per q block, out
        n_kv_blocks = max(s // 1024, 1)
        per_layer += 2 * qkv + 2 * shard(cfg.num_kv_heads, tp) * hd * n_kv_blocks \
            + 2 * shard(cfg.num_heads, tp) * hd
        if cfg.is_moe:
            fe = cfg.moe_d_ff
            # dispatch buffer (E,C,D) write+read + expert h (E,C,Fe) w+r + out
            cap_ratio = cfg.top_k * cfg.capacity_factor
            per_layer += cap_ratio * (4 * d + 4 * fe)
            if cfg.num_shared_experts:
                per_layer += 4 * shard(cfg.shared_expert_d_ff, tp) + 2 * d
        else:
            per_layer += 4 * shard(cfg.d_ff, tp) + 2 * d
        passes = l * per_layer
        if cfg.family == "encdec":
            # encoder (same block shape, seq = encoder_seq) + cross-attention
            enc_t_loc = b * cfg.encoder_seq / dp
            passes += cfg.encoder_layers * (4 * d + 2 * qkv + 4 *
                                            shard(cfg.d_ff, tp) + 2 * d) \
                * (enc_t_loc / t_loc)
            passes += l * (2 * qkv + 2 * d)          # cross attn streams
    elif cfg.family in ("ssm", "hybrid"):
        inner = shard(cfg.ssm_heads, tp) * cfg.ssm_head_dim
        n_state = cfg.ssm_state
        # x/z/B/C/dt streams + conv + gated norm + out
        per_layer = 4 * d + 4 * inner + 4 * n_state + 2 * inner + 2 * d
        # chunked SSD: states (H,N,P) per chunk per device
        per_layer += 2 * inner * (n_state / cfg.ssm_chunk)
        passes = l * per_layer
        if cfg.family == "hybrid":
            n_attn = sum(1 for k in cfg.layer_kinds() if k == "mamba_attn")
            hd = cfg.resolved_head_dim
            qkv = shard(cfg.num_heads, tp) * hd + 2 * shard(cfg.num_kv_heads,
                                                            tp) * hd
            n_kv_blocks = max(s // 1024, 1)
            passes += n_attn * (4 * d + 2 * qkv +
                                2 * shard(cfg.num_kv_heads, tp) * hd * n_kv_blocks
                                + 4 * shard(cfg.d_ff, tp) + 2 * d)

    # logits: write + read fp32 over sharded vocab
    v_loc = shard(cfg.padded_vocab, tp)
    logits = 2 * v_loc * 4 / bt             # in units of bf16-elements
    fwd = (passes + logits) * t_loc * bt
    if not train:
        return fwd
    # backward: dgrad streams ~= forward streams; remat re-runs forward
    remat_mult = {"none": 2.0, "dots": 2.6, "full": 3.0}[cfg.remat_policy]
    return fwd * remat_mult


def _cache_local(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Per-device bytes of the decode cache of ``shape``: a meta-device
    model's ``cache_specs`` over ``parallel.sharding.cache_pspecs``. The
    cache's ``index`` counts as the reference holds it, an int32 scalar on
    the device."""
    from repro_torch.models import build_model
    model = build_model(cfg, device="meta")
    cache_specs = dict(model.cache_specs(shape.global_batch, shape.seq_len),
                       index=torch.empty((), dtype=torch.int32, device="meta"))
    cache_ps = shd.cache_pspecs(cfg, cache_specs, mesh)
    return sharded_bytes(cache_specs, cache_ps, mesh)


def analytic_hbm_traffic(cfg: ArchConfig, shape: ShapeConfig, mesh,
                         plan, razor=None) -> Dict[str, float]:
    """Per-device HBM bytes for one step. ``plan`` is a
    ``train.state.StatePlan``, ``razor`` a ``core.razor.RazorPlan``."""
    p_loc = sharded_bytes(plan.state_specs["params"], plan.param_pspecs, mesh)
    o_loc = sharded_bytes(plan.state_specs["opt"],
                          {"master": plan.opt_pspecs["master"],
                           "m": plan.opt_pspecs["m"],
                           "v": plan.opt_pspecs["v"]}, mesh)
    out: Dict[str, float] = {"params_local": float(p_loc),
                             "opt_local": float(o_loc)}
    if shape.kind == "train":
        # weights: fwd + bwd + remat re-read; grads write+read (bf16);
        # opt read+write; params re-write; backup shard read+write
        w_reads = 3 if cfg.remat_policy != "none" else 2
        traffic = (w_reads + 1 + 2) * p_loc + 2 * o_loc
        if razor is not None:
            traffic += 2 * razor.unique_bytes / max(mesh.size, 1)
        traffic += _activation_traffic(cfg, shape, mesh, train=True)
        out["traffic"] = float(traffic)
    elif shape.kind == "prefill":
        c_loc = _cache_local(cfg, shape, mesh)
        out["cache_local"] = float(c_loc)
        traffic = p_loc + c_loc \
            + _activation_traffic(cfg, shape, mesh, train=False)
        out["traffic"] = float(traffic)
    else:  # decode: params + full cache read per token
        c_loc = _cache_local(cfg, shape, mesh)
        # MoE: only routed experts are touched per decode step
        p_eff = p_loc
        if cfg.is_moe:
            e = cfg.padded_experts
            touched = min(e, shape.global_batch * cfg.top_k)
            expert_frac = touched / e
            # expert params dominate; scale total conservatively
            p_eff = p_loc * (0.3 + 0.7 * expert_frac)
        out["cache_local"] = float(c_loc)
        out["traffic"] = float(p_eff + c_loc)
    return out
