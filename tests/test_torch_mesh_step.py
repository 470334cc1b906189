"""The port's sharded multi-rank train step against the JAX package's, on
the CPU: 4 gloo ranks of ``repro_torch.train.step.build_train_step`` on a
(4, 1) mesh against ``repro.train.step.build_train_step`` on a (4, 1) host
mesh of 4 forced host devices, from the same weights (the reference's
``init_state``, moved through ``bridge.params_from_numpy``) and the same two
batches: qwen3-0.6b smoke fp32 with FSDP on and off and with 2 microbatches,
mamba2 and zamba2 smoke with FSDP, and int8 cross-pod compression on a
(pod 2, data 2, model 1) mesh. Each run is two steps; the losses, the new
state (params, master, m, v) and the second step's backup are compared, the
backup also against the predecessor's shard within the port, and the
neighbor drill (a rank's optimizer shard dropped and rebuilt from its
neighbor's backup) must give the uninterrupted step bit for bit.

The reference runs in two subprocesses and the port's ranks in spawned
processes (``file://`` rendezvous under the test's temporary directory),
all at once, each joined with a deadline."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time
import traceback
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.train.state import init_state as j_init_state

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)          # the training slice's fp32 tolerance
COMPRESSED_TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's own bound of the compressed step against the exact one
# (tests/test_multidevice.py::test_cross_pod_compression_close_to_exact)
EXACT_LOSS_TOL = 1e-4
EXACT_PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
HP = dict(lr=1e-3, warmup_steps=0, total_steps=50)    # a non-zero rate at step 0
DEADLINE_S = 240
# name -> (arch, build_train_step keywords, mesh (pod, data))
RUNS = {
    "qwen3_fsdp": ("qwen3-0.6b", dict(fsdp_params=True), (1, 4)),
    "qwen3_nofsdp": ("qwen3-0.6b", dict(fsdp_params=False), (1, 4)),
    "qwen3_mb2": ("qwen3-0.6b", dict(fsdp_params=True, microbatches=2), (1, 4)),
    "mamba2_fsdp": ("mamba2-2.7b", dict(fsdp_params=True), (1, 4)),
    "zamba2_fsdp": ("zamba2-7b", dict(fsdp_params=True), (1, 4)),
    "qwen3_pod_int8": ("qwen3-0.6b", dict(compress_pod_grads=True), (2, 2)),
}
PARITY = [k for k in RUNS if k != "qwen3_pod_int8"]

JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.step import build_train_step

runs, data_dir, hp = eval(sys.argv[1]), sys.argv[2], eval(sys.argv[3])
BLOCK_SHAPE, BLOCK_SPECS = eval(sys.argv[4])

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

for name, (arch, kw, (pod, data)) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    state = inp["state"].item()
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
    model = build_model(cfg)
    shape = (pod, data, 1) if pod > 1 else (data, 1)
    axes = ("pod", "data", "model") if pod > 1 else ("data", "model")
    mesh = make_mesh_compat(shape, axes)
    art = build_train_step(model, mesh, AdamWConfig(**hp), donate=False,
                           shape=ShapeConfig("t", 16, 8, "train"), **kw)
    out = {}
    with mesh:
        for i, tokens in enumerate(inp["batches"]):
            state, metrics, backup = art.step_fn(state, {"tokens": jnp.asarray(tokens)})
            out[f"loss{i}"] = np.asarray(metrics["loss"], np.float32)
            if i == 0:
                out.update(flat(state, "state0|"))
    out.update(flat(state, "state|"))
    out.update(flat(backup, "backup|"))
    np.savez(f"{data_dir}/{name}_jax.npz", **out)

# where a NamedSharding puts each device's block (device i of the mesh = rank i)
from jax.sharding import NamedSharding, PartitionSpec as P
blocks = {}
for shape, axes in (((4, 1), ("data", "model")), ((2, 2, 1), ("pod", "data", "model"))):
    mesh = make_mesh_compat(shape, axes)
    for spec in BLOCK_SPECS:
        if any(a not in axes for part in spec if part for a in
               (part if isinstance(part, tuple) else (part,))):
            continue
        where = NamedSharding(mesh, P(*spec)).devices_indices_map(BLOCK_SHAPE)
        blocks[repr((shape, spec))] = [
            [[sl.start or 0, BLOCK_SHAPE[d] if sl.stop is None else sl.stop]
             for d, sl in enumerate(where[dev])] for dev in mesh.devices.flat]
np.save(f"{data_dir}/blocks_{'_'.join(sorted(runs))}.npy", np.asarray(repr(blocks)))
"""
BLOCK_SHAPE = (8, 12, 4)
BLOCK_SPECS = [("data", None), (None, "data"), (("pod", "data"),), ("pod", "data"),
               (None, ("data", "model"), "pod"), (None, None, "model")]


def _cfg(arch):
    return dataclasses.replace(j_reduce(j_get_arch(arch)), dtype="float32")


def _flat(tree, prefix):
    from repro_torch.tree import keystr, tree_flatten_with_path
    return {prefix + keystr(p): t.detach().float().numpy()
            for p, t in tree_flatten_with_path(tree, lambda x: x is None) if t is not None}


# ------------------------------- the ranks -------------------------------- #
def _rank_main(rank: int, world: int, data_dir: str):
    """One gloo rank: every run of RUNS from the reference's initial state,
    two steps; rank 0 writes the joined state, backup and losses."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
    from repro_torch.core.instant import neighbor_backup
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step
    try:
        torch.set_num_threads(1)      # four ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous",
                                rank=rank, world_size=world)
        for name, (arch, kw, (pod, data)) in RUNS.items():
            inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
            model = params_from_numpy(inp["state"].item()["params"], cfg, device="cpu")
            mesh = make_host_mesh(data=data, model=1, pod=pod)
            art = build_train_step(model, mesh, AdamWConfig(**HP),
                                   shape=ShapeConfig("t", 16, 8, "train"), **kw)
            state = shard_init_state(param_tree(model), art.plan, mesh)
            out = {}
            batches = [torch.from_numpy(b) for b in inp["batches"]]
            for i, tokens in enumerate(batches):
                local = shd.local_block(tokens, art.input_pspecs["tokens"], mesh).contiguous()
                if i == len(batches) - 1 and name == "qwen3_fsdp":
                    out["drill_bitwise"] = np.asarray(
                        _drill(art, mesh, state, backup, local, neighbor_backup))
                state, metrics, backup = art.step_fn(state, {"tokens": local})
                out[f"loss{i}"] = metrics["loss"].numpy()
                if i == 0:
                    out.update(_flat(shd.join_tree(state, art.plan.state_pspecs, mesh),
                                     "state0|"))
            if kw.get("compress_pod_grads"):
                out.update(_reference_check(model, mesh, batches[0]))
            full = shd.join_tree(state, art.plan.state_pspecs, mesh)
            joined_backup = shd.join_tree(backup, art.backup_pspecs, mesh)
            if rank == 0:
                out.update(_flat(full, "state|"))
                out.update(_flat(joined_backup, "backup|"))
                np.savez(f"{data_dir}/{name}_port.npz", **out)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _reference_check(model, mesh, tokens):
    """The reference's own check of compression, as its test makes it: one
    step with AdamWConfig()'s defaults, compressed and exact, from the same
    state: the losses and the new params (joined), keyed by the flag."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step
    out = {}
    for compress in (False, True):
        art = build_train_step(model, mesh, shape=ShapeConfig("t", 16, 8, "train"),
                               compress_pod_grads=compress)
        state = shard_init_state(param_tree(model), art.plan, mesh)
        local = shd.local_block(tokens, art.input_pspecs["tokens"], mesh).contiguous()
        state, metrics, _ = art.step_fn(state, {"tokens": local})
        out[f"refcheck{int(compress)}|loss"] = metrics["loss"].numpy()
        out.update(_flat(shd.join_tree(state["params"], art.plan.param_pspecs, mesh),
                         f"refcheck{int(compress)}|params|"))
    return out


def _drill(art, mesh, state, backup, local, neighbor_backup):
    """Rank 1 drops its optimizer shard and rebuilds it from rank 2's
    backup (sent back one hop), its FSDP param shard cast from the rebuilt
    master; the step from there must equal the uninterrupted one on every
    rank, bit for bit."""
    from repro_torch.tree import tree_flatten, tree_map
    clone = lambda t: tree_map(lambda x: x.clone(), t)
    ref_state, _, ref_backup = art.step_fn(clone(state), {"tokens": local})
    restored = clone(state)
    returned = neighbor_backup(backup, art.backup_pspecs, mesh, shift=-1)
    if mesh.index("data") == 1:
        for dst, src in zip(tree_flatten(restored["opt"])[0],
                            tree_flatten(returned, lambda x: x is None)[0]):
            if src is not None:              # a razor-unique leaf: only the backup has it
                dst.zero_()
                dst.copy_(src)
        # a param stored as the same block as its master is cast from it; a
        # replicated one (the embedding) would come from any data peer
        for p, m in zip(tree_flatten(restored["params"])[0],
                        tree_flatten(restored["opt"]["master"])[0]):
            if p.shape == m.shape:
                p.zero_()
                p.copy_(m)
    new_state, _, new_backup = art.step_fn(restored, {"tokens": local})
    pairs = list(zip(tree_flatten(ref_state)[0], tree_flatten(new_state)[0]))
    pairs += [(a, b) for a, b in zip(tree_flatten(ref_backup, lambda x: x is None)[0],
                                     tree_flatten(new_backup, lambda x: x is None)[0])
              if a is not None]
    return all(torch.equal(a, b) for a, b in pairs)


def _spawn_ranks(world: int, data_dir: Path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(data_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, deadline: float):
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    return [p.exitcode for p in procs], bool(alive)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's results of every run in RUNS."""
    data_dir = tmp_path_factory.mktemp("mesh_step")
    rng = np.random.default_rng(0)
    for name, (arch, _, _) in RUNS.items():
        cfg = _cfg(arch)
        state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
        batches = rng.integers(0, cfg.vocab_size, (2, 8, 17)).astype(np.int32)
        np.savez(data_dir / f"{name}_in.npz", state=np.asarray(state, dtype=object),
                 batches=batches)
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    # two reference processes (the SSM family's compiles take as long as
    # all the dense ones'), each with its runs
    groups = [{k: v for k, v in RUNS.items() if (v[0] == "qwen3-0.6b") == dense}
              for dense in (True, False)]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), repr(g), str(data_dir),
         repr(HP), repr((BLOCK_SHAPE, BLOCK_SPECS))], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for g in groups]
    procs = _spawn_ranks(4, data_dir)
    try:
        outputs = [r.communicate(timeout=max(1.0, deadline - time.monotonic())) for r in refs]
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.wait()
        codes, hung = _join(procs, deadline)
    for r, (out, err) in zip(refs, outputs):
        assert r.returncode == 0, f"reference step failed:\n{out}\n{err[-4000:]}"
    assert not hung and codes == [0] * 4, f"port ranks exit codes {codes}, hung={hung}"
    out = {name: (dict(np.load(data_dir / f"{name}_jax.npz")),
                  dict(np.load(data_dir / f"{name}_port.npz"))) for name in RUNS}
    out["blocks"] = {}
    for g in groups:
        out["blocks"].update(eval(str(np.load(data_dir / f"blocks_{'_'.join(sorted(g))}.npy"))))
    return out


# --------------------------------- tests ---------------------------------- #
@pytest.mark.parametrize("name", PARITY)
def test_losses_match_jax(runs, name):
    ref, port = runs[name]
    for i in range(2):
        np.testing.assert_allclose(port[f"loss{i}"], ref[f"loss{i}"], **TOL)


def _assert_leaves_close(port, ref, prefix):
    """Every leaf under ``prefix`` within TOL, the absolute part taken
    relative to the leaf's largest magnitude (m and v are far below 1)."""
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix))
    for k in keys:
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(port[k], ref[k], rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=k)


@pytest.mark.parametrize("part", ["params", "opt|master", "opt|m", "opt|v"])
@pytest.mark.parametrize("name", PARITY)
def test_state_matches_jax(runs, name, part):
    ref, port = runs[name]
    _assert_leaves_close(port, ref, f"state|{part}|")


@pytest.mark.parametrize("name", PARITY)
def test_backup_matches_jax(runs, name):
    ref, port = runs[name]
    _assert_leaves_close(port, ref, "backup|")


@pytest.mark.parametrize("name", list(RUNS))
def test_backup_is_the_predecessors_new_shard(runs, name):
    """Rank r's backup is rank (r - 1)'s post-update ZeRO block, bit for
    bit: the global backup is the new optimizer state with its blocks along
    the "data"-sharded dim rolled by one (pod 0's, where pods differ)."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_spec, sharded_dim
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import keystr, tree_flatten_with_path

    arch, kw, (pod, data) = RUNS[name]
    mesh = Mesh(("pod", "data", "model"), (pod, data, 1))
    model = build_model(reduce_for_smoke(get_arch(arch)), device="meta")
    plan = make_state_plan(model, mesh, fsdp_params=kw.get("fsdp_params", True))
    port = runs[name][1]
    checked = 0
    for path, spec in tree_flatten_with_path(plan.opt_pspecs, is_spec):
        dim = sharded_dim(spec)
        if dim is None:
            assert "backup|" + keystr(path) not in port
            continue
        blocks = np.split(port["state|opt|" + keystr(path)], data, axis=dim)
        np.testing.assert_array_equal(port["backup|" + keystr(path)],
                                      np.concatenate(blocks[-1:] + blocks[:-1], axis=dim))
        checked += 1
    assert checked >= 3


def test_neighbor_drill_rebuilds_the_step_bitwise(runs):
    assert runs["qwen3_fsdp"][1]["drill_bitwise"]


def test_compressed_step_matches_jax_compressed(runs):
    """Both losses, and the params and master after the first step, within
    1e-5 of the reference's compressed step. Later m, v and master are held
    to the rounding of q: a q that the two packages' fp32 sums (in other
    orders) round to neighbouring integers moves that element's gradient by
    s / 2, which AdamW's first step normalises away and its second does not."""
    ref, port = runs["qwen3_pod_int8"]
    for i in range(2):
        np.testing.assert_allclose(port[f"loss{i}"], ref[f"loss{i}"], **COMPRESSED_TOL)
    keys = [k for k in ref if k.startswith(("state0|params|", "state0|opt|master|"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], **COMPRESSED_TOL, err_msg=k)


def test_compressed_step_is_close_to_the_exact_one(runs):
    """The reference's own check (its first step with AdamWConfig()'s
    defaults): the compressed step's loss within 1e-4 and its params within
    rtol 5e-3, atol 5e-4 of the exact step's."""
    port = runs["qwen3_pod_int8"][1]
    assert abs(float(port["refcheck1|loss"]) - float(port["refcheck0|loss"])) < EXACT_LOSS_TOL
    keys = [k[len("refcheck0|"):] for k in port if k.startswith("refcheck0|params|")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port["refcheck1|" + k], port["refcheck0|" + k],
                                   **EXACT_PARAM_TOL, err_msg=k)


def test_blocks_are_where_a_named_sharding_puts_them(runs):
    """Every rank's block (``block_slices``) is the slice that JAX's
    ``NamedSharding.devices_indices_map`` gives the mesh's device at that
    rank, on the (4, 1) and (2, 2, 1) host meshes."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import sharding as shd
    assert len(runs["blocks"]) >= 8
    for key, per_device in runs["blocks"].items():
        shape, spec = eval(key)
        axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        for rank, where in enumerate(per_device):
            mesh = Mesh(axes, shape, rank=rank)
            mine = [[0, n] for n in BLOCK_SHAPE]
            for dim, start, size in shd.block_slices(shd.P(*spec), BLOCK_SHAPE, mesh):
                mine[dim] = [start, start + size]
            assert mine == where, (key, rank)


# ------------------------- no processes needed ---------------------------- #
def test_meshes_need_an_initialised_group_of_the_right_size():
    from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                         make_single_device_mesh)
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="not initialised"):
        make_host_mesh(data=4, model=1)
    mesh = make_single_device_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None
    x = torch.arange(6.0)
    assert torch.equal(mesh.all_gather(x, "data", 0), x)


def test_neighbor_backup_is_the_identity_on_one_rank():
    from repro_torch.core.instant import neighbor_backup, ring_perm
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.parallel.sharding import P
    mesh = make_single_device_mesh()
    tree = {"a": torch.ones(3), "b": None}
    assert neighbor_backup(tree, {"a": P("data"), "b": None}, mesh) is tree
    assert ring_perm(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert ring_perm(4, 3) == [(0, 3), (1, 0), (2, 1), (3, 2)]


def test_pod_compression_on_a_model_axis_raises():
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import build_train_step
    model = build_model(reduce_for_smoke(get_arch("qwen3-0.6b")), device="meta")
    for axes, shape in ((("data", "model"), (2, 2)), (("pod", "data", "model"), (2, 1, 2))):
        with pytest.raises(NotImplementedError, match="item 9e"):
            build_train_step(model, Mesh(axes, shape), compress_pod_grads=True)


def test_world_one_step_equals_the_one_device_step():
    """At world size 1 (no process group) the sharded step is the
    simulated cluster's one-device step: loss, params and optimizer state
    equal within the fp32 tolerance after two steps."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_update, cast_params, cosine_schedule
    from repro_torch.parallel.sharding import join_tree
    from repro_torch.train.state import grad_tree, init_state, param_tree, shard_init_state
    from repro_torch.train.step import build_train_step
    from repro_torch.tree import Stacked, tree_flatten, tree_map

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    hp = AdamWConfig(**HP)
    model = build_model(cfg, device="cpu")
    ref = init_state(model, torch.Generator().manual_seed(0))
    mesh = make_single_device_mesh()
    art = build_train_step(model, mesh, hp)
    state = shard_init_state(param_tree(model), art.plan, mesh)
    rng = np.random.default_rng(1)
    for _ in range(2):
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17)))}
        state, metrics, backup = art.step_fn(state, batch)
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch)
        loss.backward()
        lr = cosine_schedule(ref["step"], lr=hp.lr, warmup_steps=hp.warmup_steps,
                             total_steps=hp.total_steps)
        adamw_update(grad_tree(model), ref["opt"], ref["step"], hp, lr)
        cast_params(ref["opt"]["master"], ref["params"])
        ref["step"].add_(1)
        torch.testing.assert_close(metrics["loss"], loss.detach(), **TOL)
    assert all(b is None for b in tree_flatten(backup, lambda x: x is None)[0])
    stack = lambda x: torch.stack(x.layers) if isinstance(x, Stacked) else x
    joined = join_tree(state, art.plan.state_pspecs, mesh)
    for a, b in zip(tree_flatten(joined)[0], tree_flatten(tree_map(stack, ref))[0]):
        torch.testing.assert_close(a, b.detach(), **TOL)


def test_quantize_int8_and_bytes_saved_match_jax():
    from repro.parallel.compression import compressed_bytes_saved as j_saved
    from repro.parallel.compression import quantize_int8 as j_quantize
    from repro_torch.parallel.compression import compressed_bytes_saved, quantize_int8
    x = np.random.default_rng(3).normal(size=(64, 33)).astype(np.float32) * 3
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = j_quantize(jax.numpy.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    for grad_bytes, npods in ((1 << 20, 1), (1 << 20, 2), (12345, 4)):
        assert compressed_bytes_saved(grad_bytes, npods) == j_saved(grad_bytes, npods)


def test_select_unique_and_traffic_of_a_built_step():
    """``select_unique`` keeps the razor-unique leaves, and the traffic of
    a built step is ``step_traffic`` with its razor, as the reference's."""
    from repro.train.step import step_traffic as j_step_traffic
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.core.razor import select_unique
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import artifacts_traffic, build_train_step
    from repro_torch.tree import tree_leaves
    model = build_model(reduce_for_smoke(get_arch("qwen3-0.6b")), device="meta")
    art = build_train_step(model, make_single_device_mesh())
    opt = art.plan.state_specs["opt"]
    kept = select_unique(opt, art.razor.unique_mask)
    assert [x is not None for x in tree_leaves(kept)] == tree_leaves(art.razor.unique_mask)
    prof = artifacts_traffic(art, 4e9, 4)
    ref = j_step_traffic(4e9, 4, state_bytes=art.razor.unique_bytes_per_device_ring)
    assert (prof.train_bytes, prof.state_bytes, prof.dcn_bytes) == \
        (ref.train_bytes, ref.state_bytes, ref.dcn_bytes)


@pytest.mark.cuda
def test_two_rank_step_on_the_card_matches_the_cpu(tmp_path):
    """2 gloo ranks of the FSDP step on cuda:0 against the same 2 ranks on
    the CPU: losses and the new state within the fp32 tolerance (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    results = {}
    for device in ("cpu", "cuda"):
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_two_rank_main, args=(r, str(tmp_path), device))
                 for r in range(2)]
        for p in procs:
            p.start()
        codes, hung = _join(procs, time.monotonic() + DEADLINE_S)
        assert not hung and codes == [0, 0], (device, codes, hung)
        results[device] = dict(np.load(tmp_path / f"two_rank_{device}.npz"))
    for k, v in results["cpu"].items():
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(results["cuda"][k], v, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=k)


def _two_rank_main(rank: int, data_dir: str, device: str):
    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rdv_{device}",
                                rank=rank, world_size=2)
        cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
        model = build_model(cfg, device="cpu")
        model.init(torch.Generator().manual_seed(0))
        mesh = make_host_mesh(data=2, model=1)
        art = build_train_step(model, mesh, AdamWConfig(**HP))
        state = shard_init_state(param_tree(model), art.plan, mesh, device=device)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17)))
        local = tokens[2 * rank:2 * rank + 2].to(device)
        out = {}
        for i in range(2):
            state, metrics, _ = art.step_fn(state, {"tokens": local})
            out[f"loss{i}"] = metrics["loss"].cpu().numpy()
        full = shd.join_tree(state, art.plan.state_pspecs, mesh)
        if rank == 0:
            out.update({k: v for k, v in _flat(tree_cpu(full), "state|").items()})
            np.savez(f"{data_dir}/two_rank_{device}.npz", **out)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        os._exit(1)


def tree_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)
