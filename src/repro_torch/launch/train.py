"""Training CLI of the port: the JAX package's ``repro.launch.train``, with
its flags, on the port's ``SimCluster``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 8 --inject-failure 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --dp 4 --seq-len 1024 --inject-failure 4    # full, on CUDA
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --arch mamba2-2.7b --steps 6 --inject-failure 3      # or zamba2-7b

Runs the full stack: controller-indexed data loading, the training step on
the device with the instant checkpoint, the ckpt engine (instant + periodic
full), failure injection and recovery. Unlike the reference CLI, whose
``--smoke`` is always on, this one runs the full config unless ``--smoke``
is given, and runs on CUDA unless ``--device cpu`` is given. As the
reference's, it runs the config with ``remat_policy="none"``: the layers
keep their activations. Fabric times it prints are simulated.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.roofline import hw

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the config with reduce_for_smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="step at which to kill a worker (tests failover)")
    ap.add_argument("--hardware-failure", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_torch_train_ckpt"))
    ap.add_argument("--full-every", type=int, default=500)
    ap.add_argument("--topology", choices=("ring", "full"), default="ring",
                    help="per-link fabric shape (one scheduler per edge)")
    ap.add_argument("--link-bw", type=float, default=hw.FABRIC_LINK_BW,
                    help="default per-edge bandwidth inside a pod, bytes/s "
                         "(simulated)")
    ap.add_argument("--hotspot-edge", type=int, nargs=2, default=None,
                    metavar=("U", "V"),
                    help="ring edge to throttle (asymmetric-bandwidth run)")
    ap.add_argument("--hotspot-bw", type=float, default=5e9,
                    help="bandwidth of the hotspot edge, bytes/s")
    ap.add_argument("--pods", type=int, default=1,
                    help="group the dp workers into this many pods: per-pod "
                         "ICI rings joined by a DCN gateway ring")
    ap.add_argument("--dcn-bw", type=float, default=hw.FABRIC_DCN_BW,
                    help="inter-pod edge bandwidth, bytes/s (simulated)")
    ap.add_argument("--edge-latency", type=float, default=1e-3,
                    help="per-DCN-hop delivery latency, seconds")
    ap.add_argument("--storm", type=int, default=None, metavar="SEED",
                    help="at --inject-failure, unleash a seeded correlated "
                         "failure storm (darkens a whole pod + nearby "
                         "edges) instead of a single-worker failure")
    ap.add_argument("--storm-edge-failures", type=int, default=1,
                    help="extra correlated edge failures in the storm")
    ap.add_argument("--recovery-policy", choices=("stream", "compute",
                                                  "hybrid"),
                    default="stream",
                    help="how failed workers get their state back: stream "
                         "it from neighbor backups (FFTrainer), replay "
                         "compute to rebuild it checkpoint-free, or race "
                         "both per worker")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.core.lccl import edge_key
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.cluster import (ClusterConfig, FabricConfig,
                                             FaultScript, SimCluster)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, remat_policy="none")

    edge_bw = None
    if args.hotspot_edge is not None:
        edge_bw = {edge_key(*args.hotspot_edge): args.hotspot_bw}

    clu = SimCluster(
        cfg,
        cluster=ClusterConfig(
            dp=args.dp, global_batch=args.global_batch,
            seq_len=args.seq_len, ckpt_dir=Path(args.ckpt_dir),
            full_every=args.full_every,
            hp=AdamWConfig(warmup_steps=5, total_steps=max(args.steps, 10))),
        fabric=FabricConfig(
            link_bw=args.link_bw, topology=args.topology, edge_bw=edge_bw,
            pods=args.pods, dcn_bw=args.dcn_bw,
            dcn_latency=args.edge_latency),
        recovery=args.recovery_policy, device=args.device)

    t0 = time.time()
    for step in range(args.steps):
        if args.inject_failure is not None and step == args.inject_failure:
            if args.storm is not None:
                storm = clu.inject_storm(
                    args.storm, pods=1,
                    edge_failures=args.storm_edge_failures)
                print(f"[failover] storm seed={storm.seed}: darkened pods "
                      f"{list(storm.pods)}, extra dark edges "
                      f"{list(storm.edges)}")
            else:
                print(f"[failover] injecting failure at step {step}")
                clu.inject_failure([1], hardware=args.hardware_failure)
            if any(not w.alive for w in clu.workers):
                rep = clu.recover(
                    FaultScript(hardware=args.hardware_failure))
                print(f"[failover] recovered from {rep.recovered_from} "
                      f"({rep.policy} policy) in {rep.total_time:.1f}s "
                      f"(modeled), rollback="
                      f"{rep.rolled_back_iterations} iterations, "
                      f"state streamed {rep.state_bytes_streamed / 1e6:.1f} "
                      f"MB, replay compute {rep.compute_seconds:.2f}s")
            else:
                # a flat-fabric storm only darkens edges (no pods to kill):
                # training continues, streams route around the damage
                print("[failover] storm killed no workers; training on "
                      "through the degraded fabric")
        loss = clu.step()
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {clu.iteration:4d} loss {loss:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/it)")
    print(f"done: {clu.iteration} iterations, "
          f"instant ckpts per worker ~= {clu.workers[0].engine.instant_count}")
    # per-edge view of the fabric the training traffic actually loaded:
    # instant-ckpt hiding (the FCR condition) is now observable edge by edge
    print(f"instant ckpt hidden/exposed iterations: "
          f"{clu.instant_hidden}/{clu.instant_exposed}")
    for e, sch in sorted(clu.topology.links.items()):
        hid = clu.edge_instant_hidden.get(e, 0)
        exp = clu.edge_instant_exposed.get(e, 0)
        print(f"  edge {e[0]}-{e[1]} [{clu.topology.tier(*e)}]: "
              f"bw {sch.bw / 1e9:.1f} GB/s, "
              f"lat {sch.latency * 1e3:.2f} ms, "
              f"state hidden {hid} exposed {exp}, "
              f"TRAIN+STATE transfers {sch.n_finished} pending "
              f"{sch.pending_bytes() / 1e6:.1f} MB")
    # per-tier rollup: where the fabric's surplus capacity actually went
    from repro_torch.core.lccl import PodFabric
    if isinstance(clu.topology, PodFabric):
        for tier in clu.topology.tiers():
            edges = clu.topology.tier_edges(tier)
            moved = sum(clu.topology.edge(*e).n_finished for e in edges)
            print(f"  tier {tier}: {len(edges)} edges, "
                  f"{moved} transfers completed")


if __name__ == "__main__":
    main()
