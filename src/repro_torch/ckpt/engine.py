"""FFTrainer checkpoint engine (paper §4.2): instant neighbor checkpoints +
periodic full async fallback (multi-level insurance).

Host-side view of the in-step collective-permute: after each step the runtime
hands the engine the `backup` pytree (this worker's RAM now holds its DP
*predecessor's* unique shard). The engine keeps the last two versions for
consistency (§4.2) and owns the every-N full async disk checkpoint.

Transport: every artifact the engine produces — instant neighbor shards, full
async fallbacks, lazy backups — is additionally cut into CRC'd quanta and
routed through the `StateStream` transport as STATE traffic (§5.3) when one
is attached, so checkpoint movement competes with (and is preempted by) the
train loop's TRAIN traffic edge by edge on the modeled fabric: instant
shards ride the adjacent ICI ring edge, lazy backups fan out onto whichever
tier has slack, full fallbacks take the least-loaded live edge."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.ckpt.storage import (AsyncWriter, load_meta, load_pytree,
                                save_manifest, save_pytree)
from repro_torch.ckpt.stream import (DEFAULT_QUANTUM, ChunkedStream, StreamAssembler,
                               StreamTicket, StreamTransport)
from repro_torch.core.consistency import SnapshotKeeper

PyTree = Any


@dataclass
class CkptEngineConfig:
    out_dir: Path = Path("checkpoints")
    full_every: int = 500          # multi-level insurance period
    snapshot_depth: int = 2
    quantum: int = DEFAULT_QUANTUM  # StateStream chunk size
    # routing budget for split-policy streams this engine submits: max
    # edge-disjoint paths to stripe across (None = the transport's route_k)
    route_k: Optional[int] = None


class CkptEngine:
    def __init__(self, cfg: CkptEngineConfig, worker_id: int = 0,
                 transport: Optional[StreamTransport] = None):
        self.cfg = cfg
        self.worker_id = worker_id
        # neighbor redundancy: predecessor's unique shard, two versions
        self.neighbor = SnapshotKeeper(cfg.snapshot_depth)
        # own unique shard (for lazy backup and version rollback)
        self.own = SnapshotKeeper(cfg.snapshot_depth)
        self.writer = AsyncWriter()
        self.transport = transport
        self.instant_count = 0
        self.full_count = 0
        self.streamed_chunks = 0
        self.streamed_bytes = 0
        self.last_instant_ticket: Optional[StreamTicket] = None

    # ---------------- chunk-stream plumbing ---------------- #
    def _stream(self, stream_id: str, tree: PyTree, t: float,
                stream: Optional[ChunkedStream] = None,
                route: str = "any") -> Optional[StreamTicket]:
        """Cut `tree` into CRC'd quanta (or take a prebuilt stream) and put
        it on the transport as STATE traffic at simulation time `t`
        (seconds). No-op (returns None) when no transport is attached.

        `route` picks the edge placement on a fabric transport: "instant"
        rides the adjacent DP-ring edge (predecessor -> this worker, single
        shortest path — one hop, nothing to split); "lazy" fans out over
        this worker's incident live edges by residual bandwidth (the slack
        tier absorbs it); "any" (full artifacts) takes the least-loaded live
        edge. A single-link transport ignores routing."""
        if self.transport is None:
            return None
        if stream is None:
            stream = ChunkedStream.from_pytree(stream_id, tree,
                                               quantum=self.cfg.quantum)
        asm = StreamAssembler.for_stream(stream)
        src = dst = None
        policy = "split"
        if route == "instant":
            src, dst = self.transport.instant_route(self.worker_id)
            policy = "shortest"
        elif route == "lazy":
            src = self.worker_id
        ticket = self.transport.send(stream, t, assembler=asm, src=src,
                                     dst=dst, policy=policy,
                                     k=self.cfg.route_k)
        self.streamed_chunks += stream.n_chunks
        self.streamed_bytes += stream.total_bytes
        return ticket

    def export_stream(self, iteration: int, which: str = "own"
                      ) -> ChunkedStream:
        """Produce the chunk stream for a held snapshot — the recovery-time
        producer side (a healthy holder re-chunks its neighbor copy so a
        newcomer can fetch it, resumably, through the scheduler)."""
        keeper = self.own if which == "own" else self.neighbor
        snap = keeper.get(iteration)
        assert snap is not None, \
            f"worker {self.worker_id}: no {which} snapshot at it {iteration}"
        sid = f"{which}/it{iteration:08d}/w{self.worker_id:05d}"
        return ChunkedStream.from_pytree(sid, snap.state,
                                         quantum=self.cfg.quantum)

    @staticmethod
    def import_stream(assembler: StreamAssembler, like: PyTree) -> PyTree:
        """Consumer side: rebuild a pytree from a (CRC-verified) assembler."""
        return assembler.to_pytree(like)

    # ---------------- instant (per-iteration) path ---------------- #
    def on_step(self, iteration: int, own_unique: PyTree,
                neighbor_backup: Optional[PyTree], *, t: float = 0.0) -> None:
        """Called each iteration with this worker's unique shard and the
        permuted shard received from the DP-ring predecessor."""
        self.own.push(iteration, own_unique)
        if neighbor_backup is None:
            # no instant stream this step: a stale ticket must not be
            # re-counted into the hidden/exposed books
            self.last_instant_ticket = None
        else:
            self.neighbor.push(iteration, neighbor_backup)
            self.instant_count += 1
            self.last_instant_ticket = self._stream(
                f"instant/it{iteration:08d}/w{self.worker_id:05d}",
                neighbor_backup, t, route="instant")

    def newest_version(self) -> int:
        return self.own.latest().iteration if self.own.latest() else -1

    # ---------------- full async fallback ---------------- #
    def maybe_full_checkpoint(self, iteration: int, full_state: PyTree,
                              *, force: bool = False, t: float = 0.0) -> bool:
        if not force and (iteration == 0 or
                          iteration % self.cfg.full_every != 0):
            return False
        path = self._full_path(iteration)
        ok = self.writer.submit(path, full_state,
                                {"iteration": iteration,
                                 "worker": self.worker_id})
        if ok:
            self.full_count += 1
            # the full fallback rides the same link as everything else; its
            # manifest lets a partial restore verify + resume per chunk
            sid = f"full/it{iteration:08d}/w{self.worker_id:05d}"
            stream = ChunkedStream.from_pytree(sid, full_state,
                                               quantum=self.cfg.quantum)
            save_manifest(path, stream.manifest())
            self._stream(sid, full_state, t, stream=stream)
        return ok

    def _full_path(self, iteration: int) -> Path:
        return (Path(self.cfg.out_dir) /
                f"full_it{iteration:08d}_w{self.worker_id:05d}.npz")

    def latest_full(self) -> Optional[int]:
        root = Path(self.cfg.out_dir)
        if not root.exists():
            return None
        its = sorted({int(p.name.split("_")[1][2:])
                      for p in root.glob(f"full_it*_w{self.worker_id:05d}.npz")})
        return its[-1] if its else None

    def restore_full(self, iteration: int, like: PyTree) -> PyTree:
        return load_pytree(self._full_path(iteration), like)

    # ---------------- lazy backup (paper §4.2) ---------------- #
    def lazy_backup(self, iteration: int, redundant_state: PyTree,
                    *, is_dp_rank0: bool, t: float = 0.0) -> Optional[Path]:
        """At recovery time only, DP rank 0 persists the razor-redundant
        state (params) so newcomers can fetch it; others skip (dedupe)."""
        if not is_dp_rank0:
            return None
        path = (Path(self.cfg.out_dir) /
                f"lazy_it{iteration:08d}_w{self.worker_id:05d}.npz")
        save_pytree(path, redundant_state, {"iteration": iteration})
        # the multi-GB redundant state fans out over this worker's incident
        # edges (both ring directions, plus a gateway's DCN uplink) by
        # residual bandwidth — it lands on whichever tier has slack
        self._stream(f"lazy/it{iteration:08d}/w{self.worker_id:05d}",
                     redundant_state, t, route="lazy")
        return path

    def close(self) -> None:
        self.writer.close()
