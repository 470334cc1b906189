"""The port's MoE in the sharded train step against the JAX package's, on the
CPU: gloo ranks of ``repro_torch.train.step.build_train_step`` against
``repro.train.step.build_train_step`` on the same host meshes of forced host
devices, from the same weights (the reference's ``init_state``, moved
through ``bridge.params_from_numpy``) and the same two batches of 8 x 128
tokens: qwen2-moe-a2.7b smoke (8 experts padded to 16, top-2, the shared
expert), fp32, on (data 4, model 1) with FSDP, (2, 2) without FSDP and a
binding gradient clip, (2, 2) with FSDP and (1, 2) with FSDP. Under the
reference's jit the MoE routes the global batch: 16 groups of 64 tokens at
capacity 16 against a mean load of 16 an expert, so assignments drop, and
a rank routes its rows as whole groups of that batch. Each run is two
steps; the losses, xent and aux, the new state (params, master, m, v, the
leaves replicated over "model" among them) and the second step's backup
are compared at 2e-4, and the neighbour drill (a rank's optimizer shard
dropped and rebuilt from its "data" neighbour's backup) must give the
uninterrupted step bit for bit.

The traps that are right at (4, 1) and wrong at (2, 2): the balance loss's
gradient, which every model rank computes whole (held alone at model 2
against model 1 at 1e-6, where the full loss's 2e-4 could hide a 2x error
on a term weighted 0.01); experts a rank does not hold (the smoke's 16
padded experts, 8 a rank, 4 of rank 1's padding); FSDP on expert leaves
(the bound blocks hold E/tp experts after the gather along "data"). A
control run routes each rank's rows alone and must miss JAX's losses.

The reference runs in two subprocesses and the port's ranks in two sets of
spawned processes (4 ranks, and 2 for (1, 2)), all at once, each joined
with a deadline."""
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
ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=2e-4, atol=2e-4)          # the training slice's fp32 tolerance
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
HP = dict(lr=1e-3, warmup_steps=0, total_steps=50)    # a non-zero rate at step 0
CLIP = 0.1                                 # the first gradient's global norm is 0.692
DEADLINE_S = 420                          # a hang guard: ~40 s alone, more beside other workers
SHAPE = (8, 128)                          # global batch, sequence: 16 groups of 64 tokens
# name -> (build_train_step keywords, mesh (data, model), AdamWConfig keywords)
RUNS = {
    "fsdp_41": (dict(fsdp_params=True), (4, 1), HP),
    "clip_22": (dict(fsdp_params=False), (2, 2), dict(HP, grad_clip=CLIP)),
    "fsdp_22": (dict(fsdp_params=True), (2, 2), HP),
    "fsdp_12": (dict(fsdp_params=True), (1, 2), HP),
}
# the control: fsdp_41 with each rank routing its own rows alone
CONTROL = {"local_41": RUNS["fsdp_41"]}
WITH_BACKUP = [k for k, v in RUNS.items() if v[1][0] > 1]
# the leaves replicated over "model": the router and the shared gate beside
# split experts (their gradients summed over "model"), the norms
REPLICATED = ("moe|router", "moe|shared_gate", "|ln1", "|ln2", "final_norm")

JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.step import build_train_step

runs, data_dir, (batch, seq), arch = (eval(sys.argv[1]), sys.argv[2], eval(sys.argv[3]),
                                      sys.argv[4])

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

inp = np.load(f"{data_dir}/in.npz", allow_pickle=True)
cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
model = build_model(cfg)
for name, (kw, (data, mdl), hp) in runs.items():
    state = inp["state"].item()
    out = {}
    if "grad_clip" in hp:          # the global norm of the first step's gradient
        tokens = jnp.asarray(inp["batches"][0])
        g = jax.jit(jax.grad(lambda p: model.loss(p, {"tokens": tokens})[0]))(state["params"])
        out["grad_norm0"] = np.sqrt(sum(float(jnp.sum(jnp.square(x.astype(jnp.float32))))
                                        for x in jax.tree_util.tree_leaves(g)))
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    art = build_train_step(model, mesh, AdamWConfig(**hp), donate=False,
                           shape=ShapeConfig("t", seq, batch, "train"), **kw)
    with mesh:
        for i, tokens in enumerate(inp["batches"]):
            state, metrics, backup = art.step_fn(state, {"tokens": jnp.asarray(tokens)})
            for k in ("loss", "xent", "aux"):
                out[f"{k}{i}"] = np.asarray(metrics[k], np.float32)
            if i == 0:
                out.update(flat(state["opt"]["m"], "state0|opt|m|"))
    out.update(flat(state, "state|"))
    out.update(flat(backup, "backup|"))
    np.savez(f"{data_dir}/{name}_jax.npz", **out)
"""


def _cfg():
    return dataclasses.replace(j_reduce(j_get_arch(ARCH)), dtype="float32")


def _flat(tree, prefix):
    from repro_torch.tree import keystr, tree_flatten_with_path
    return {prefix + keystr(p): t.detach().float().numpy()
            for p, t in tree_flatten_with_path(tree, lambda x: x is None) if t is not None}


# ------------------------------- the ranks -------------------------------- #
def _record_bound_shapes(seen: dict) -> None:
    """Wrap the calls that receive the bound blocks, so that a step records
    their shapes: the MoE leaves as the layer bodies get them (after the
    FSDP gather) and the q of the attention call."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    def wrap(owner, attr, record):
        fn = getattr(owner, attr)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            record(args, out)
            return out
        setattr(owner, attr, wrapped)

    def layer(args, p):
        if isinstance(p, dict) and "moe" in p:
            seen.setdefault("moe.w_gate", tuple(p["moe"]["w_gate"].shape))
            seen.setdefault("moe.w_down", tuple(p["moe"]["w_down"].shape))
            seen.setdefault("moe.shared.w_up", tuple(p["moe"]["shared"]["w_up"].shape))
    wrap(transformer, "unshard_layer_params", layer)
    wrap(ops, "flash_attention", lambda a, _: seen.setdefault("flash.q", tuple(a[0].shape)))


def _aux_grads(rank: int, data_dir: str) -> None:
    """The balance loss alone at model 2: layer 0's MoE region with this
    rank's experts on a (1, 2) mesh, d aux / d router (summed over "model",
    as the step sums a partial leaf) and d aux / d x (summed by f's
    backward); rank 0 writes them."""
    import contextlib

    from repro_torch.models.modes import TensorParallel, tensor_parallel
    from repro_torch.models.transformer import Block
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import tree_flatten_with_path
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model

    cfg, m, x = _aux_inputs()
    mesh = make_host_mesh(data=1, model=2)
    plan = make_state_plan(build_model(cfg, device="meta"), mesh, fsdp_params=False)
    specs = {p[2:]: s for p, s in tree_flatten_with_path(plan.param_pspecs, shd.is_spec)
             if p[:2] == ("blocks", "moe")}
    local = {}
    for path, full in tree_flatten_with_path(m):
        spec = specs[path]
        leaf = shd.local_block(full[None], spec, mesh)[0].clone().requires_grad_()
        node = local
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    x = x.clone().requires_grad_()
    tp = TensorParallel(mesh, contextlib.nullcontext)
    with tensor_parallel(tp):
        _, aux = Block(cfg, torch.float32, "meta")._moe_region(local, x)
    g_router, g_x = torch.autograd.grad(aux, [local["router"], x])
    g_router = mesh.all_reduce(g_router, "model")
    if rank == 0:
        np.savez(f"{data_dir}/aux_model2.npz", aux=aux.detach().numpy(),
                 router=g_router.numpy(), x=g_x.numpy())


def _aux_inputs():
    """The smoke config, one layer's MoE parameters (the reference's init)
    and an input of 2 x 64 tokens, from seeds."""
    from repro.models import moe as j_moe

    from repro_torch.configs import get_arch, reduce_for_smoke
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), dtype="float32")
    jp = j_moe.moe_init(jax.random.key(7), _cfg(), jax.numpy.float32)
    m = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 64, cfg.d_model))
                         .astype(np.float32))
    return cfg, m, x


def _rank_main(rank: int, world: int, data_dir: str, names: list):
    """One gloo rank: each run of ``names`` from the reference's initial
    state, two steps; rank 0 writes the joined state, backup, losses and
    the first step's dropped assignments, and every rank its bound shapes
    and collective counts."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
    from repro_torch.core.instant import neighbor_backup
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as step_mod
    from repro_torch.train.state import param_tree, shard_init_state
    try:
        torch.set_num_threads(1)      # the ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous{world}",
                                rank=rank, world_size=world)
        seen = {}
        _record_bound_shapes(seen)
        inp = np.load(f"{data_dir}/in.npz", allow_pickle=True)
        cfg = dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), dtype="float32")
        routing = step_mod._routing
        for name in names:
            kw, (data, mdl), hp = {**RUNS, **CONTROL}[name]
            step_mod._routing = (lambda *a: None) if name in CONTROL else routing
            model = params_from_numpy(inp["state"].item()["params"], cfg, device="cpu")
            mesh = make_host_mesh(data=data, model=mdl)
            art = step_mod.build_train_step(
                model, mesh, AdamWConfig(**hp), shape=ShapeConfig("t", SHAPE[1], SHAPE[0],
                                                                  "train"), **kw)
            state = shard_init_state(param_tree(model), art.plan, mesh)
            out = {}
            batches = [torch.from_numpy(b) for b in inp["batches"]]
            for i, tokens in enumerate(batches):
                local = shd.local_block(tokens, art.input_pspecs["tokens"], mesh).contiguous()
                if i == len(batches) - 1 and name == "fsdp_22":
                    out["drill_bitwise"] = np.asarray(
                        _drill(art, mesh, state, backup, local, neighbor_backup))
                seen.clear()
                mesh.reset_counts()
                with moe.record_routing() as log:
                    state, metrics, backup = art.step_fn(state, {"tokens": local})
                for k in ("loss", "xent", "aux"):
                    out[f"{k}{i}"] = metrics[k].numpy()
                if i == 0:
                    out.update(_flat(shd.join_tree(state["opt"]["m"], art.plan.opt_pspecs["m"],
                                                   mesh), "state0|opt|m|"))
                    out["grad_norm0"] = art.step_fn.last_grad_norm.numpy()
                    out["dropped"] = np.asarray(sum(int((~r["valid"]).sum()) for r in log))
                    out["capacity"] = np.asarray(log[0]["capacity"])
                    out["groups"] = np.asarray(log[0]["top_e"].shape[0])
                    out["counts"] = np.asarray(mesh.counts.get(("all_reduce", ("model",)),
                                                               [0, 0]))
                    out["formula"] = np.asarray(step_mod.model_all_reduces(
                        model, mesh, local.shape[0], SHAPE[1], **kw))
                    out["shapes"] = np.asarray(repr(dict(seen)))
            np.savez(f"{data_dir}/{name}_rank{rank}.npz", **{k: v for k, v in out.items()
                                                            if k in ("counts", "formula",
                                                                     "shapes")})
            full = shd.join_tree(state, art.plan.state_pspecs, mesh)
            joined_backup = shd.join_tree(backup, art.backup_pspecs, mesh)
            if rank == 0:
                out.update(_flat(full, "state|"))
                out.update(_flat(joined_backup, "backup|"))
                np.savez(f"{data_dir}/{name}_port.npz", **out)
        step_mod._routing = routing
        if world == 2:
            _aux_grads(rank, data_dir)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _drill(art, mesh, state, backup, local, neighbor_backup):
    """The ranks at data index 1 drop their optimizer shards and rebuild
    them from their "data" neighbours' backups (sent back one hop), their
    FSDP param blocks cast from the rebuilt master; the step from there
    must equal the uninterrupted one on every rank, bit for bit."""
    from repro_torch.tree import tree_flatten, tree_map
    clone = lambda t: tree_map(lambda x: x.clone(), t)   # noqa: E731
    ref_state, _, ref_backup = art.step_fn(clone(state), {"tokens": local})
    restored = clone(state)
    returned = neighbor_backup(backup, art.backup_pspecs, mesh, shift=-1)
    if mesh.index("data") == 1:
        for dst, src in zip(tree_flatten(restored["opt"])[0],
                            tree_flatten(returned, lambda x: x is None)[0]):
            if src is not None:              # a razor-unique leaf: only the backup has it
                dst.zero_()
                dst.copy_(src)
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
    """The reference's and the port's results of every run in RUNS and of
    the control, and the balance loss's gradients at model 2."""
    data_dir = tmp_path_factory.mktemp("moe_step")
    cfg = _cfg()
    state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
    batches = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, SHAPE[0], SHAPE[1] + 1)).astype(np.int32)
    np.savez(data_dir / "in.npz", state=np.asarray(state, dtype=object), batches=batches)
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    names = list(RUNS)
    groups = [{k: RUNS[k] for k in names[:2]}, {k: RUNS[k] for k in names[2:]}]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), repr(g), str(data_dir),
         repr(SHAPE), ARCH], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for g in groups]
    by_world = {4: [k for k in names if RUNS[k][1] != (1, 2)] + list(CONTROL),
                2: [k for k in names if RUNS[k][1] == (1, 2)]}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(data_dir), wanted))
             for world, wanted in by_world.items() for r in range(world)]
    for p in procs:
        p.start()
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
    assert not hung and codes == [0] * len(procs), f"port ranks exit codes {codes}, hung={hung}"
    out = {}
    for name, (_, (data, mdl), _) in {**RUNS, **CONTROL}.items():
        ranks = [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(data * mdl)]
        ref = "fsdp_41" if name in CONTROL else name
        out[name] = (dict(np.load(data_dir / f"{ref}_jax.npz")),
                     dict(np.load(data_dir / f"{name}_port.npz")), ranks)
    out["aux_model2"] = dict(np.load(data_dir / "aux_model2.npz"))
    return out


# --------------------------------- tests ---------------------------------- #
@pytest.mark.parametrize("name", list(RUNS))
def test_losses_xent_and_aux_match_jax(runs, name):
    ref, port, _ = runs[name]
    for i in range(2):
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(port[f"{k}{i}"], ref[f"{k}{i}"], err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_routing_is_the_global_batchs_and_drops(runs, name):
    """A rank routes 16 / ranks whole groups of 64 tokens at the global
    batch's capacity of 16, and assignments drop."""
    _, port, _ = runs[name]
    data = RUNS[name][1][0]
    assert int(port["groups"]) == 16 // data and int(port["capacity"]) == 16
    assert int(port["dropped"]) > 0


def test_routing_a_ranks_rows_alone_misses_jax(runs):
    """The control: each rank routing its 256 tokens alone takes other
    groups (16 of 16 tokens) and another capacity (8), and its losses leave
    JAX's tolerance, so the parity tests see that fault."""
    ref, port, _ = runs["local_41"]
    assert int(port["groups"]) == 16 and int(port["capacity"]) == 8
    err = max(abs(float(port[f"loss{i}"]) - float(ref[f"loss{i}"])) for i in range(2))
    assert err > 10 * TOL["atol"], err


def _assert_leaves_close(port, ref, keys, roll=None):
    """Every leaf of ``keys`` within TOL, the absolute part taken relative
    to the leaf's largest magnitude (m and v are far below 1); a param or
    master element also moves by what AdamW's first step makes of the
    gradient's own tolerance (as tests/test_torch_tp_step.py allows: an
    element whose first gradient is near eps takes a first step that the
    reduction order decides, at most 2 lr over two steps)."""
    for k in keys:
        atol = TOL["atol"] * float(np.abs(ref[k]).max())
        leaf = _updated_leaf(k)
        if leaf and "state0|opt|m|" + leaf in ref:
            g = np.abs(ref["state0|opt|m|" + leaf]) / (1 - 0.9)
            g = roll(leaf, g) if roll else g
            d = TOL["atol"] * float(g.max())
            atol = atol + HP["lr"] * np.minimum(2.0, 1e-8 * d / (g + 1e-8) ** 2)
        bad = np.abs(port[k] - ref[k]) > atol + TOL["rtol"] * np.abs(ref[k])
        assert not bad.any(), (f"{k}: {int(bad.sum())} of {bad.size} elements differ, "
                               f"largest {float(np.abs(port[k] - ref[k])[bad].max())}")


def _updated_leaf(key: str):
    """The leaf path of a param, master or backed-up master key, else None."""
    parts = key.split("|")
    for head in (["state", "params"], ["state", "opt", "master"], ["backup", "master"]):
        if parts[:len(head)] == head:
            return "|".join(parts[len(head):])
    return None


def _keys(port, ref, prefix):
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix))
    return keys


@pytest.mark.parametrize("part", ["params", "opt|master", "opt|m", "opt|v"])
@pytest.mark.parametrize("name", list(RUNS))
def test_state_matches_jax(runs, name, part):
    ref, port, _ = runs[name]
    _assert_leaves_close(port, ref, _keys(port, ref, f"state|{part}|"))


@pytest.mark.parametrize("name", list(RUNS))
def test_replicated_leaves_match_jax(runs, name):
    """The router and the shared gate (replicated beside split experts:
    each model rank's gradient a part, summed over "model", the balance
    loss's weighted 1/tp) and the norms: params, m and v."""
    ref, port, _ = runs[name]
    keys = [k for part in ("params", "opt|m", "opt|v")
            for k in _keys(port, ref, f"state|{part}|") if k.endswith(REPLICATED)]
    assert len(keys) == 3 * len(REPLICATED), keys
    _assert_leaves_close(port, ref, keys)


@pytest.mark.parametrize("name", WITH_BACKUP)
def test_backup_matches_jax(runs, name):
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_spec, sharded_dim
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import keystr, tree_flatten_with_path

    kw, shape, _ = RUNS[name]
    model = build_model(reduce_for_smoke(get_arch(ARCH)), device="meta")
    plan = make_state_plan(model, Mesh(("data", "model"), shape), fsdp_params=kw["fsdp_params"])
    dims = {keystr(p): sharded_dim(spec)
            for p, spec in tree_flatten_with_path(plan.opt_pspecs["master"], is_spec)}

    def roll(leaf, x):
        dim = dims[leaf]
        return x if dim is None else np.roll(x, x.shape[dim] // shape[0], axis=dim)

    ref, port, _ = runs[name]
    _assert_leaves_close(port, ref, _keys(port, ref, "backup|"), roll)


def test_neighbor_drill_rebuilds_the_step_bitwise(runs):
    assert runs["fsdp_22"][1]["drill_bitwise"]


def test_grad_norm_matches_jax_where_the_clip_binds(runs):
    ref, port, _ = runs["clip_22"]
    assert float(ref["grad_norm0"]) > 4 * CLIP
    np.testing.assert_allclose(port["grad_norm0"], ref["grad_norm0"], **TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_bound_blocks_hold_the_ranks_experts(runs, name):
    """After FSDP's gather (along "data" only) a layer body computes on its
    rank's E/tp experts, its columns and rows of the shared expert and its
    heads."""
    cfg = _cfg()
    data, mdl = RUNS[name][1]
    want = {"moe.w_gate": (cfg.padded_experts // mdl, cfg.d_model, cfg.moe_d_ff),
            "moe.w_down": (cfg.padded_experts // mdl, cfg.moe_d_ff, cfg.d_model),
            "moe.shared.w_up": (cfg.d_model, cfg.shared_expert_d_ff // mdl),
            "flash.q": (SHAPE[0] // data, SHAPE[1], cfg.num_heads // mdl,
                        cfg.resolved_head_dim)}
    for rank, rec in enumerate(runs[name][2]):
        assert eval(str(rec["shapes"])) == want, (rank, rec["shapes"])


@pytest.mark.parametrize("name", list(RUNS))
def test_model_all_reduces_equal_the_formula(runs, name):
    """The all-reduces over "model" of one step, counted by the mesh on
    every rank, equal ``model_all_reduces`` (the MoE layer one split
    sub-layer, the router and the shared gate partial leaves)."""
    for rank, rec in enumerate(runs[name][2]):
        assert (rec["counts"][0] > 0) == (RUNS[name][1][1] > 1)
        assert list(rec["counts"]) == list(rec["formula"]), rank


def test_balance_loss_gradient_at_model_2_equals_model_1(runs):
    """d aux / d router and d aux / d x alone, at model 2 (each rank's
    experts, every rank computing the balance loss whole) against model 1,
    at 1e-6: counted on both model ranks it would be 2x."""
    from repro_torch.models.transformer import Block
    cfg, m, x = _aux_inputs()
    m = {k: (v.requires_grad_() if k == "router" else v) for k, v in m.items()}
    x.requires_grad_()
    _, aux = Block(cfg, torch.float32, "meta")._moe_region(m, x)
    g_router, g_x = torch.autograd.grad(aux, [m["router"], x])
    got = runs["aux_model2"]
    np.testing.assert_allclose(got["aux"], aux.detach().numpy(), **AUX_TOL)
    assert np.abs(g_router.numpy()).max() > 1e-3 and np.abs(g_x.numpy()).max() > 1e-4
    np.testing.assert_allclose(got["router"], g_router.numpy(), **AUX_TOL)
    np.testing.assert_allclose(got["x"], g_x.numpy(), **AUX_TOL)


# ------------------------- no processes needed ---------------------------- #
@pytest.mark.parametrize("axes, sizes", [(("data", "model"), (2, 1)),
                                         (("pod", "data", "model"), (2, 1, 2))])
def test_microbatches_on_more_than_one_batch_rank_raise(axes, sizes):
    """The reference's microbatch is a block of the global rows; the port's
    a chunk of each rank's, which routes other tokens together."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import build_train_step
    model = build_model(reduce_for_smoke(get_arch(ARCH)), device="meta")
    with pytest.raises(NotImplementedError, match="item 9h"):
        build_train_step(model, Mesh(axes, sizes), microbatches=2)
    build_train_step(model, Mesh(("data", "model"), (1, 2)), microbatches=2)


def test_groups_that_do_not_divide_over_the_batch_ranks_raise():
    """24 global tokens route as 2 groups of 12, which 4 batch ranks of 6
    tokens would straddle: the call raises before any collective."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models.modes import GlobalRouting, global_routing
    cfg, m, _ = _aux_inputs()
    x = torch.zeros(1, 6, cfg.d_model)
    ctx = GlobalRouting(Mesh(("data", "model"), (4, 1)), ("data",), 24)
    with global_routing(ctx), pytest.raises(NotImplementedError, match="item 9g"):
        moe.moe_apply(m, cfg, x)
    with global_routing(GlobalRouting(ctx.mesh, ("data",), 25)), \
            pytest.raises(ValueError, match="global batch"):
        moe.moe_apply(m, cfg, x)
