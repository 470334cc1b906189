"""Elastic rescale: lose a worker with NO spare capacity — the controller
shrinks the DP degree, re-partitions the TID data indexing (exact cover
preserved), and training continues at reduced throughput.

    PYTHONPATH=src python -m repro_torch.examples.elastic_rescale              # CUDA
    PYTHONPATH=src python -m repro_torch.examples.elastic_rescale --device cpu

The port of the reference's ``examples/elastic_rescale.py``: gemma-2b at
smoke scale (head_dim 16, MQA kept), through ``SimCluster.shrink``.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.runtime.cluster import ClusterConfig, SimCluster

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("gemma-2b")),
                              dtype="float32")
    cluster = SimCluster(cfg, cluster=ClusterConfig(
        dp=4, global_batch=8, seq_len=16,
        ckpt_dir=Path(tempfile.gettempdir()) / "repro_torch_elastic_ckpt"),
        device=args.device)

    print("dp=4:", [f"{l:.3f}" for l in cluster.run(3)])

    print("\nworker 3 lost, no spare -> shrink to dp=3")
    cluster.inject_failure([3], hardware=True)
    cluster.workers[3].alive = True  # mark handled; we rescale instead of replace
    new_dp = cluster.shrink([3])
    print(f"new dp={new_dp}, global batch -> {cluster.global_batch}")

    losses = cluster.run(3)
    print("dp=3:", [f"{l:.3f}" for l in losses])
    assert all(np.isfinite(l) for l in losses)

    # exact-cover data indexing still holds after the rescale
    parts = [w.loader.indexer.indices(cluster.iteration, i, cluster.dp)
             for i, w in enumerate(cluster.workers)]
    total = np.concatenate(parts)
    assert len(total) == cluster.global_batch == len(np.unique(total))
    print("exact-cover data partition preserved after rescale — OK")


if __name__ == "__main__":
    main()
