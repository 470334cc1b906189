"""Quickstart: train a smoke-scale model for a few steps with FFTrainer's
instant checkpointing, then kill a worker and recover with zero rollback.

    PYTHONPATH=src python -m repro_torch.examples.quickstart              # CUDA
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port of the reference's ``examples/quickstart.py``; the modeled wall
time it prints is simulated fabric time.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.cluster import ClusterConfig, SimCluster

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")),
                              dtype="float32")
    cluster = SimCluster(cfg, cluster=ClusterConfig(
        dp=4, global_batch=8, seq_len=16,
        ckpt_dir=Path(tempfile.gettempdir()) / "repro_torch_quickstart_ckpt",
        hp=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)),
        device=args.device)

    print("training 5 steps...")
    for loss in cluster.run(5):
        print(f"  loss {loss:.4f}")

    print("\nkilling worker 2 (its ZeRO shard lives on in worker 3's RAM)...")
    cluster.inject_failure([2])
    report = cluster.recover()
    print(f"recovered from {report.recovered_from}; "
          f"rollback = {report.rolled_back_iterations} iterations; "
          f"modeled wall time = {report.total_time:.1f}s "
          f"(vs ~900s for a serial baseline)")

    print("\ncontinuing training...")
    for loss in cluster.run(5):
        print(f"  loss {loss:.4f}")
    print("\ndone — instant checkpoints taken:",
          cluster.workers[0].engine.instant_count)


if __name__ == "__main__":
    main()
