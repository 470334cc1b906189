"""Dry-run (port of ``repro.launch.dryrun``): every (architecture x input
shape) cell on the production meshes, one step of one rank on tensors that
hold no data: the memory fit, the collective schedule and the roofline's
inputs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nemotron-4-15b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

The reference lowers and compiles each cell for 256 (512) TPU devices. The
port runs the cell's own step (``train.step.build_train_step``,
``train.serve.build_prefill_step`` / ``build_decode_step``, as a user's run
calls them) on rank 0 of a process group of 256 (512) ranks of torch's
``"fake"`` backend (``FakeStore``), which completes every collective at
once and moves nothing. Every tensor is a fake CPU tensor
(``roofline.analyze.no_data``): each op computes shapes and dtypes only,
and the kernel wrappers take their plain forms (blockwise attention, the
plain decode attention, the chunked SSD), the reference's own production
form. No card, no data, one process: ``launch.mesh.Mesh``'s factories build
the per-axis groups over the fake group, and ``Mesh.counts`` records the
schedule.

Per single-pod cell, as the reference:

  * the PRODUCTION form, the step at full depth: its peak memory and its
    collective schedule. The peak is the largest sum of live storage bytes
    of the rank over the step, from this module's own tally (``LiveBytes``,
    a dispatch mode): the state, the batch and the cache at entry, and
    every op's outputs until they are freed. It is written under
    ``memory_analysis``'s keys (arguments, outputs, temporaries, outputs
    aliasing arguments), whose sum is the peak. It is the peak of the plain
    forms: the flash kernel holds no (Sq x kv_block) block of scores and
    the card's unembedding no fp32 copy of the head, so the card's eager
    run needs at most this, but for the caching allocator's rounding.
  * the ANALYSIS form (``roofline.probes.measure_costs``): the FLOPs, bytes
    and collective bytes of probe depths under analysis mode, extrapolated.

Multi-pod cells run the production form only. ``lower_s`` is the seconds to
build a cell's step and state, ``compile_s`` the seconds of its production
step on fake tensors.

Recompute: the layer bodies follow the config's ``remat_policy``
(``models.modes.run_layer``; "full" unless ``--remat`` says otherwise), and
the train step stores its params sharded (FSDP), under which the bodies are
recomputed whatever the policy; the serve steps run without autograd and
recompute nothing. Each cell's JSON says which (``recompute``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import dryrun_cells, get_arch, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import active_param_count, build_model
from repro_torch.parallel import sharding as shd
from repro_torch.roofline.analyze import analyze_from_costs, collective_costs, no_data
from repro_torch.tree import tree_flatten, tree_unflatten


# --------------------------------------------------------------------------- #
# The peak: a tally of the live storages
# --------------------------------------------------------------------------- #
class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive on this rank: those ``track``ed (the
    step's arguments) and every op's outputs, each until it is freed
    (``peak``: the largest sum). A storage shared by views counts once."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0

    def track(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors; returns their bytes."""
        return sum(self._add(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))

    def _add(self, t: torch.Tensor) -> int:
        if t.device.type == "meta":
            return 0
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.live:
            return 0
        n = storage.nbytes()
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(storage, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def keys(self, tree: Any) -> Dict[int, int]:
        """{storage key: bytes} of ``tree``'s tensors."""
        out = {}
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                out[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def peak_step(step, args) -> Tuple[Any, Dict[str, int], float]:
    """Run ``step(*args)`` (made under ``no_data()``, which must still be
    active) under ``LiveBytes``: (its outputs, the reference's
    ``memory_analysis`` keys, seconds)."""
    live = LiveBytes()
    with live:
        argument = live.track(args)
        entry = live.keys(args)
        t0 = time.perf_counter()
        out = step(*args)
        seconds = time.perf_counter() - t0
    outs = live.keys(out)
    output = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in entry)
    mem = {"argument_size_in_bytes": argument, "output_size_in_bytes": output,
           "temp_size_in_bytes": live.peak - argument - output + alias,
           "alias_size_in_bytes": alias}
    return out, mem, seconds


def peak_bytes(mem: Dict[str, int]) -> int:
    """The peak of a ``memory_analysis`` dict, as the reference sums it."""
    return (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])


# --------------------------------------------------------------------------- #
# One cell
# --------------------------------------------------------------------------- #
def _blocks(specs: Any, pspecs: Any, mesh) -> Any:
    """Empty tensors of this rank's blocks of ``specs`` (meta tensors of
    the global shapes) as ``pspecs`` lays them out (a None spec: whole);
    a leaf that is not a tensor (a cache's host ``index``) as it is."""
    leaves, treedef = tree_flatten(specs)
    specs_flat, _ = tree_flatten(pspecs, lambda x: x is None or shd.is_spec(x))
    if len(leaves) != len(specs_flat):
        raise ValueError(f"{len(leaves)} leaves against {len(specs_flat)} PartitionSpecs")
    out = [t if not isinstance(t, torch.Tensor) else
           torch.empty(tuple(t.shape) if ps is None else
                       shd.block_shape(ps, tuple(t.shape), mesh), dtype=t.dtype)
           for t, ps in zip(leaves, specs_flat)]
    return tree_unflatten(treedef, out)


def build_cell(cfg, shape, mesh, *, instant_ckpt: bool = True,
               max_len: Optional[int] = None):
    """The step of one cell on this rank of ``mesh`` and its arguments,
    ``(step, args)``: ``step(*args)`` runs it. Call it under ``no_data()``,
    which must still be active when the step runs. Train: the sharded train
    step (FSDP, the instant backup where ``instant_ckpt``) on this rank's
    blocks of the state and the batch. Prefill: the prompts' rows of this
    rank, into a cache of ``max_len`` positions (the prompt's by default, as
    the reference). Decode: one step at the cache's last position (the
    whole cache attended to), on this rank's cache blocks and tokens."""
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    from repro_torch.train.step import build_train_step
    model = build_model(cfg, device="meta")
    specs = model.input_specs(shape)
    if shape.kind == "train":
        art = build_train_step(model, mesh, instant_ckpt=instant_ckpt, shape=shape)
        state = _blocks(art.plan.state_specs, art.plan.state_pspecs, mesh)
        return art.step_fn, (state, _blocks(specs, art.input_pspecs, mesh))
    if shape.kind == "prefill":
        fn, plan, in_ps = build_prefill_step(model, mesh, shape)
        batch = _blocks(specs, in_ps, mesh)
        if max_len is not None:
            batch["max_len"] = max_len
        return fn, (_blocks(plan.state_specs["params"], plan.param_pspecs, mesh), batch)
    fn, plan, in_ps = build_decode_step(model, mesh, shape)
    cache = _blocks(specs["cache"], shd.cache_pspecs(cfg, specs["cache"], mesh), mesh)
    cache["index"] = shape.seq_len - 1
    token = _blocks(specs["token"], in_ps["token"], mesh)
    return fn, (_blocks(plan.state_specs["params"], plan.param_pspecs, mesh), cache, token)


def recompute(cfg, shape) -> str:
    """What the cell's step recomputes in its backward (``run_layer``)."""
    if shape.kind != "train":
        return "none: the serve steps run without autograd"
    return (f"every layer body (FSDP stores the params sharded: the bodies are recomputed "
            f"whatever the policy; remat_policy {cfg.remat_policy!r})")


def production_mesh(multi_pod: bool):
    """The production mesh over a ``"fake"`` default process group of its
    size, this process its rank 0: the group is made (or remade at another
    size) here; a real group already made is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs its own process: a process group of the "
                               f"{dist.get_backend()!r} backend is already made")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return make_production_mesh(multi_pod=multi_pod)


def run_cell(cfg, shape, mesh, mesh_name: str, *, out_dir: Optional[Path] = None,
             max_len: Optional[int] = None, instant_ckpt: bool = True,
             production_only: bool = False, verbose: bool = True) -> dict:
    """One cell of ``cfg`` (an ``ArchConfig``) at ``shape`` (a
    ``ShapeConfig``) on ``mesh``: the production step and, unless
    ``production_only``, the analysis probes; written to ``out_dir`` (where
    given) as the reference's JSON. ``max_len`` is a prefill's cache length
    (the shape's own by default). A (1, 1) mesh needs no process group."""
    from repro_torch.core.razor import razor_plan
    from repro_torch.roofline.memory_model import analytic_hbm_traffic
    from repro_torch.roofline.probes import measure_costs
    from repro_torch.train.state import make_state_plan

    arch_name, n_dev = cfg.name, mesh.size

    # --- production step: proof + peak memory + schedule ---
    with no_data():
        t0 = time.perf_counter()
        step, args = build_cell(cfg, shape, mesh, instant_ckpt=instant_ckpt, max_len=max_len)
        t_lower = time.perf_counter() - t0
        mesh.reset_counts()
        out, mem, t_compile = peak_step(step, args)
        prod_colls = collective_costs(mesh.counts, mesh)
        del step, args, out
    gc.collect()
    result = {
        "arch": arch_name, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "n_devices": n_dev,
        "instant_ckpt": instant_ckpt,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory_analysis": mem,
        "production_collectives": prod_colls,
        "remat_policy": cfg.remat_policy, "recompute": recompute(cfg, shape),
    }
    if verbose:
        print(f"[{mesh_name}] {arch_name} x {shape.name}: production step ok "
              f"({t_lower:.1f}s build, {t_compile:.1f}s step)")
        print(f"   peak {peak_bytes(mem) / 2**30:.2f} GiB a rank: {mem}")
        print("   production collective schedule:", prod_colls["count_by_kind"])

    # --- analysis probes: exact cost accounting ---
    if not production_only:
        n = active_param_count(cfg)
        d_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        model_flops = (6 if shape.kind == "train" else 2) * n * d_tok
        t0 = time.perf_counter()
        costs = measure_costs(cfg, shape, mesh, build_cell, instant_ckpt=instant_ckpt)
        t_ana = time.perf_counter() - t0
        # first-principles HBM model (memory term)
        plan = make_state_plan(build_model(cfg, device="meta"), mesh)
        razor = razor_plan(plan.state_specs["opt"], plan.opt_pspecs,
                           plan.state_specs["params"], mesh) \
            if shape.kind == "train" else None
        hbm = analytic_hbm_traffic(cfg, shape, mesh, plan, razor)
        rep = analyze_from_costs(costs, peak_bytes(mem), arch=arch_name, shape=shape,
                                 mesh_name=mesh_name, n_devices=n_dev,
                                 model_flops=model_flops, cfg=cfg,
                                 hbm_model_bytes=hbm["traffic"])
        result.update(rep.to_dict())
        result["probe_costs"] = {k: v for k, v in costs.items() if k != "probe_rows"}
        result["hbm_model"] = hbm
        result["analysis_compile_s"] = round(t_ana, 2)
        result["active_params"] = n
        if verbose:
            print(f"   roofline: compute={rep.compute_s*1e3:.2f}ms "
                  f"memory={rep.memory_s*1e3:.2f}ms (raw {rep.memory_s_raw*1e3:.2f}) "
                  f"collective={rep.collective_s*1e3:.2f}ms -> {rep.bottleneck}-bound; "
                  f"useful={rep.useful_ratio:.2f} roofline={rep.roofline_fraction:.3f} "
                  f"fits_hbm={rep.fits_hbm} (analysis {t_ana:.0f}s)")

    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{mesh_name}__{arch_name}__{shape.name}.json"
        path.write_text(json.dumps(result, indent=2))
    gc.collect()
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-instant-ckpt", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--production-only", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()
    out_dir = Path(args.out)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(cfg.name, shape.name) for cfg, shape, _ in dryrun_cells()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = []
    t0 = time.perf_counter()
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        for arch_name, shape_name in cells:
            path = out_dir / f"{mesh_name}__{arch_name}__{shape_name}.json"
            if args.skip_existing and path.exists():
                print(f"skip {path.name} (exists)")
                continue
            cfg = get_arch(arch_name)
            if args.remat:
                cfg = dataclasses.replace(cfg, remat_policy=args.remat)
            try:
                run_cell(cfg, get_shape(shape_name), production_mesh(multi_pod), mesh_name,
                         out_dir=out_dir, instant_ckpt=not args.no_instant_ckpt,
                         production_only=args.production_only or multi_pod)
            except Exception as e:  # record, keep sweeping
                traceback.print_exc()
                failures.append((mesh_name, arch_name, shape_name, repr(e)))
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} dry-run cells passed "
          f"in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
