"""End-to-end example: train a ~64M-param model for a few hundred steps with
per-iteration instant checkpointing, a mid-run hardware failure, recovery,
and a check that the loss still improved — then a MULTI-FAILURE scenario:
two concurrent DP-rank failures where the second strikes mid-transfer and
recovery resumes from partial chunks.

    PYTHONPATH=src python -m repro_torch.examples.train_with_failover --steps 40   # CUDA
    PYTHONPATH=src python -m repro_torch.examples.train_with_failover --device cpu --steps 8

The port of the reference's ``examples/train_with_failover.py``, with the
same ``demo-100m`` config (the port's ``ArchConfig`` has no
``remat_policy``). The MTTR it prints is simulated fabric time; the s/it is
the host's wall clock. Below about 20 steps (the learning rate's warm-up)
the closing "did not learn" check compares two noisy losses: it fails at
``--steps 4``.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import ArchConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.cluster import (ClusterConfig, FabricConfig,
                                             FaultScript, SimCluster)
    from repro_torch.tree import tree_leaves

    # 8 layers x d512 (llama-style), 32k vocab
    cfg = ArchConfig(
        name="demo-100m", family="dense", num_layers=8, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        mlp_type="swiglu", dtype="float32")
    fail_at = args.fail_at if args.fail_at is not None else args.steps // 2

    cluster = SimCluster(
        cfg,
        cluster=ClusterConfig(
            dp=4, global_batch=4, seq_len=128, dataset_size=8192,
            ckpt_dir=Path(tempfile.gettempdir()) / "repro_torch_failover_demo_ckpt",
            full_every=100,
            hp=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)),
        fabric=FabricConfig(quantum=1 << 18), device=args.device)
    n_params = sum(int(np.prod(x.shape))
                   for x in tree_leaves(cluster.state["params"]))
    print(f"model: {n_params/1e6:.1f}M params, dp=4, seq 128")

    t0 = time.time()  # simlint: disable=SIM001 -- the example's s/it, host-side
    for step in range(args.steps):
        if step == fail_at:
            print(f"\n[{step}] HARDWARE FAILURE on worker 0 "
                  f"(host RAM lost; neighbor holds its shard)")
            cluster.inject_failure([0], hardware=True)
            rep = cluster.recover(FaultScript(hardware=True))
            print(f"[{step}] recovered via {rep.recovered_from}, rollback="
                  f"{rep.rolled_back_iterations}, {rep.chunks_sent} state "
                  f"chunks streamed, modeled MTTR={rep.total_time:.1f}s\n")
        loss = cluster.step()
        if step % 20 == 0 or step == args.steps - 1:
            # simlint: disable=SIM001 -- the example's s/it, host-side
            dt = (time.time() - t0) / (step + 1)
            print(f"step {cluster.iteration:4d}  loss {loss:.4f}  ({dt:.2f}s/it)")

    print(f"\nfinal loss: {cluster.loss_history[-1]:.4f} "
          f"(started at {cluster.loss_history[0]:.4f})")
    assert cluster.loss_history[-1] < cluster.loss_history[0], "did not learn"
    print("training improved the loss through a failure — OK")

    # -----------------------------------------------------------------------
    # Multi-failure: worker 1 dies; while its shard is streaming back, worker
    # 3 (non-adjacent — its backup holder is alive) dies too. The second
    # recover() resumes worker 1's transfer from the chunks that already
    # landed instead of restarting it, then recovers both with zero rollback.
    # -----------------------------------------------------------------------
    print("\n--- multi-failure: second failure mid-transfer ---")
    cluster.inject_failure([1], hardware=True)
    partial = cluster.recover(FaultScript(hardware=True,
                                          interrupt_after_chunks=4))
    print(f"transfer interrupted after {partial.chunks_sent}/"
          f"{partial.chunks_total} chunks (second failure strikes)")
    assert partial.kind == "interrupted"

    cluster.inject_failure([3], hardware=True)
    rep2 = cluster.recover(FaultScript(hardware=True))
    print(f"resumed: reused {rep2.chunks_reused} partial chunks, streamed "
          f"{rep2.chunks_sent} more ({rep2.chunks_total} total), rollback="
          f"{rep2.rolled_back_iterations}")
    assert rep2.chunks_reused == partial.chunks_sent
    assert rep2.rolled_back_iterations == 0

    post = cluster.run(5)
    assert all(np.isfinite(l) for l in post)
    print(f"trained 5 more steps after double failure, loss {post[-1]:.4f} — OK")


if __name__ == "__main__":
    main()
