"""Probe-based cost measurement (port of ``repro.roofline.probes``).

Analysis mode (``models.modes.analysis_mode``: dense attention, the
unchunked cross-entropy, the parallel SSD) makes every FLOP, byte and
collective of a step countable (``roofline.analyze``). Costs are affine in
the layer counts, so small-depth probes are run and extrapolated:

    cost(features) = features . theta,   features = (1, n_layers[, n_attn])

Probes per family: dense/moe/ssm/vlm L in {2,4}; enc-dec k in {2,4} scaling
both stacks; hybrid (L, n_attn) in {(6,1),(7,1),(12,2)} to separate the
shared-attention block's cost from the Mamba2 blocks'.

``measure_costs`` runs the probes through a cell builder it is given (the
dry-run's ``launch.dryrun.build_cell``), where the reference imports it from
its dry-run module.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.models.modes import analysis_mode
from repro_torch.roofline.analyze import CostCount, collective_costs, no_data


def probe_plan(cfg: ArchConfig) -> Tuple[List[ArchConfig], np.ndarray,
                                         np.ndarray]:
    """Returns (probe_cfgs, probe_features, target_features)."""
    if cfg.family == "hybrid":
        k = cfg.attn_every
        probes = [k, k + 1, 2 * k]
        cfgs = [dataclasses.replace(cfg, num_layers=l) for l in probes]
        feats = np.array([[1.0, l, l // k] for l in probes])
        n_attn = sum(1 for kind in cfg.layer_kinds() if kind == "mamba_attn")
        target = np.array([1.0, cfg.num_layers, n_attn])
    elif cfg.family == "encdec":
        ratio = cfg.encoder_layers / cfg.num_layers
        probes = [2, 4]
        cfgs = [dataclasses.replace(cfg, num_layers=l,
                                    encoder_layers=max(int(l * ratio), 1))
                for l in probes]
        feats = np.array([[1.0, l] for l in probes])
        target = np.array([1.0, cfg.num_layers])
    else:
        probes = [2, 4]
        cfgs = [dataclasses.replace(cfg, num_layers=l) for l in probes]
        feats = np.array([[1.0, l] for l in probes])
        target = np.array([1.0, cfg.num_layers])
    return cfgs, feats, target


def fit(rows: List[Dict[str, float]], feats: np.ndarray, target: np.ndarray
        ) -> Dict[str, float]:
    """Each key of ``rows`` (one dict of costs a probe) fitted affinely in
    the probes' features by least squares and evaluated at ``target``
    (floored at 0)."""
    out: Dict[str, float] = {}
    for key in rows[0]:
        y = np.array([r[key] for r in rows])
        theta, *_ = np.linalg.lstsq(feats, y, rcond=None)
        out[key] = float(max(target @ theta, 0.0))
    return out


def measure_costs(cfg: ArchConfig, shape: ShapeConfig, mesh, build_cell: Callable,
                  *, instant_ckpt: bool = True) -> Dict[str, float]:
    """Run one step of each analysis probe on tensors that hold no data and
    extrapolate its counts to the production depth. ``build_cell(cfg,
    shape, mesh, instant_ckpt=...)`` returns ``(step, args)``, one step of
    this rank of ``mesh``, which ``step(*args)`` runs."""
    cfgs, feats, target = probe_plan(cfg)
    rows = []
    for pc in cfgs:
        with no_data(), analysis_mode():
            step, args = build_cell(pc, shape, mesh, instant_ckpt=instant_ckpt)
            mesh.reset_counts()
            with CostCount() as cost:
                step(*args)
            coll = collective_costs(mesh.counts, mesh)
        rows.append({
            "flops": cost.flops,
            "bytes": cost.bytes,
            "coll_bytes": float(coll["total_bytes"]),
            "wire_bytes": float(coll["wire_bytes"]),
            "coll_count": float(coll["total_count"]),
        })
        del step, args
        gc.collect()
    out = fit(rows, feats, target)
    out["probe_rows"] = rows  # type: ignore[assignment]
    return out
