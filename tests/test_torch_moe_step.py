"""The port's MoE in the sharded train step against the JAX package's, on the
CPU: gloo ranks of ``repro_torch.train.step.build_train_step`` against
``repro.train.step.build_train_step`` on the same host meshes of forced host
devices, from the same weights (the reference's ``init_state``, moved
through ``bridge.params_from_numpy``) and the same two batches of 8 x 128
tokens: qwen2-moe-a2.7b smoke (8 experts padded to 16, top-2, the shared
expert), fp32, on (data 4, model 1) with FSDP, (2, 2) without FSDP and a
binding gradient clip, (2, 2) with FSDP, (1, 2) with FSDP and (2, 1) with
2 microbatches. Under the reference's jit the MoE routes the global batch
(of a microbatch: its global rows): 16 groups of 64 tokens at capacity 16
against a mean load of 16 an expert, so assignments drop, and a rank routes
its rows as whole groups of that batch. One more run on (4, 1) takes two
batches of 4 x 6 tokens, whose 24 route as 2 groups of 12 that two ranks
share each, and one on (2, 2) two batches of 2 x 7, whose 14 tokens route
as one group that both batch ranks share, each with 8 of the 16 experts;
their weights crowd most of a group's tokens onto one expert (an offset
shared by every embedding row, and the router's column of expert 0 along
it), so that the group's later tokens, on its second rank, overflow the
capacity of 8. Each run is two steps; the losses, xent and aux, the new state (params, master, m, v, the
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

The reference runs in three subprocesses and the port's ranks in two sets of
spawned processes (4 ranks, and 2 for (1, 2) and (2, 1)), all at once, each joined
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
STRADDLE = (4, 6)                         # 24 tokens: 2 groups of 12 over 4 ranks
STRADDLE_TP = (2, 7)                      # 14 tokens: 1 group over 2 batch ranks
# name -> (build_train_step keywords, mesh (data, model), AdamWConfig keywords,
# global batch and sequence)
RUNS = {
    "fsdp_41": (dict(fsdp_params=True), (4, 1), HP, SHAPE),
    "clip_22": (dict(fsdp_params=False), (2, 2), dict(HP, grad_clip=CLIP), SHAPE),
    "fsdp_22": (dict(fsdp_params=True), (2, 2), HP, SHAPE),
    "fsdp_12": (dict(fsdp_params=True), (1, 2), HP, SHAPE),
    "mb2_21": (dict(fsdp_params=True, microbatches=2), (2, 1), HP, SHAPE),
    "straddle_41": (dict(fsdp_params=True), (4, 1), HP, STRADDLE),
    "straddle_22": (dict(fsdp_params=True), (2, 2), HP, STRADDLE_TP),
}
HOT = ("straddle_41", "straddle_22")                    # the runs whose weights crowd the experts
# the control: fsdp_41 with each rank routing its own rows alone
CONTROL = {"local_41": RUNS["fsdp_41"]}
WITH_BACKUP = [k for k, v in RUNS.items() if v[1][0] > 1]
WORLDS = {4: [k for k, v in RUNS.items() if v[1] in ((4, 1), (2, 2))] + list(CONTROL),
          2: [k for k, v in RUNS.items() if v[1] in ((1, 2), (2, 1))]}
# the leaves replicated over "model": the router and the shared gate beside
# split experts (their gradients summed over "model"), the norms (summed too
# where the sequence is split over "model")
REPLICATED = ("moe|router", "moe|shared_gate", "|ln1", "|ln2", "final_norm")

JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.step import build_train_step

runs, data_dir, arch = eval(sys.argv[1]), sys.argv[2], sys.argv[3]

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
model = build_model(cfg)
for name, (kw, (data, mdl), hp, (batch, seq)) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
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
    FSDP gather), the q of the attention call, the input of the MoE call
    and the residual stream entering a layer body (``run_layer``'s last
    argument)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer

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
    wrap(moe, "moe_apply", lambda a, _: seen.setdefault("moe.x", tuple(a[2].shape)))
    wrap(transformer, "run_layer", lambda a, _: seen.setdefault("residual", tuple(a[-1].shape)))


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
        cfg = dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), dtype="float32")
        routing = step_mod._routing
        for name in names:
            kw, (data, mdl), hp, (batch, seq) = {**RUNS, **CONTROL}[name]
            inp = np.load(f"{data_dir}/{_inputs_of(name)}_in.npz", allow_pickle=True)
            step_mod._routing = (lambda *a: None) if name in CONTROL else routing
            model = params_from_numpy(inp["state"].item()["params"], cfg, device="cpu")
            mesh = make_host_mesh(data=data, model=mdl)
            art = step_mod.build_train_step(
                model, mesh, AdamWConfig(**hp), shape=ShapeConfig("t", seq, batch, "train"),
                **kw)
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
                    out["counts"] = np.asarray(repr({k: v for k, v in mesh.counts.items()
                                                     if k[1] == ("model",)}))
                    out["formula"] = np.asarray(repr(step_mod.model_collectives(
                        model, mesh, local.shape[0], seq, **kw)))
                    out["shapes"] = np.asarray(repr(dict(seen)))
            np.savez(f"{data_dir}/{name}_rank{rank}.npz", **{k: v for k, v in out.items()
                                                            if k in ("counts", "formula",
                                                                     "shapes", "dropped",
                                                                     "groups", "capacity")})
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


def _inputs_of(name: str) -> str:
    """The run whose inputs ``name`` takes: the control takes fsdp_41's."""
    return "fsdp_41" if name in CONTROL else name


def _crowd_the_experts(state: dict, rng) -> None:
    """Every embedding row plus one offset c, 4x a row's norm, and the
    router's column of expert 0 plus 4 c / |c| in each layer, in the params
    and in their fp32 master: the hidden states share c's direction, which
    crowds most tokens of a group onto one expert (0, 5 or 6 at this seed),
    so a group of 12 tokens overflows its capacity of 8."""
    emb = state["params"]["embed"]["w"]
    c = rng.normal(size=emb.shape[1])
    c *= 4 * np.linalg.norm(emb, axis=1).mean() / np.linalg.norm(c)
    for tree in (state["params"], state["opt"]["master"]):
        tree["embed"]["w"] += c.astype(tree["embed"]["w"].dtype)
        router = tree["blocks"]["moe"]["router"]                  # (L, D, E)
        router[:, :, 0] += (4 * c / np.linalg.norm(c)).astype(router.dtype)


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
    rng = np.random.default_rng(0)
    for name, (_, _, _, (batch, seq)) in RUNS.items():
        state = jax.tree.map(np.array, j_init_state(j_build_model(cfg), jax.random.key(0)))
        if name in HOT:
            _crowd_the_experts(state, rng)
        batches = rng.integers(0, cfg.vocab_size, (2, batch, seq + 1)).astype(np.int32)
        np.savez(data_dir / f"{name}_in.npz", state=np.asarray(state, dtype=object),
                 batches=batches)
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    names = list(RUNS)
    groups = [{k: RUNS[k] for k in names[i::3]} for i in range(3)]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), repr(g), str(data_dir), ARCH],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in groups]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(data_dir), wanted))
             for world, wanted in WORLDS.items() for r in range(world)]
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
    for name, (_, (data, mdl), _, _) in {**RUNS, **CONTROL}.items():
        ranks = [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(data * mdl)]
        out[name] = (dict(np.load(data_dir / f"{_inputs_of(name)}_jax.npz")),
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


def _global_routing(name: str):
    """(groups, capacity) of a microbatch's global batch in run ``name``."""
    from repro_torch.models.moe import moe_capacity, moe_groups
    cfg = _cfg()
    kw, _, _, (batch, seq) = RUNS[name]
    tokens = batch * seq // kw.get("microbatches", 1)
    groups = moe_groups(tokens)
    return groups, moe_capacity(tokens // groups, cfg.padded_experts, cfg.top_k,
                                cfg.capacity_factor)


@pytest.mark.parametrize("name", [k for k in RUNS if k not in HOT])
def test_routing_is_the_global_batchs_and_drops(runs, name):
    """A rank routes 16 / ranks whole groups of the global batch's 64
    tokens at its capacity of 16 (at 2 microbatches, 16 / 2 groups of a
    microbatch's 32 at capacity 8), and assignments drop."""
    _, port, _ = runs[name]
    data = RUNS[name][1][0]
    groups, capacity = _global_routing(name)
    assert (groups, capacity) == ((16, 16) if name != "mb2_21" else (16, 8))
    assert int(port["groups"]) == groups // data and int(port["capacity"]) == capacity
    assert int(port["dropped"]) > 0


@pytest.mark.parametrize("name, groups", [("straddle_41", 2), ("straddle_22", 1)])
def test_groups_that_straddle_ranks_drop_on_the_later_rank(runs, name, groups):
    """24 tokens route as 2 groups of 12 at capacity 8 on 4 batch ranks of
    6, and 14 as one group on 2 batch ranks of 7 (each model rank with its
    8 experts): every rank routes its tokens as its part of one group, and
    most of a group's tokens choose one expert, so the group's first rank
    keeps its assignments (fewer tokens than 8) and the second overflows
    the capacity. Routed alone, or sorted alone, neither would drop any."""
    _, (data, mdl), _, _ = RUNS[name]
    ranks = runs[name][2]
    assert _global_routing(name) == (groups, 8)
    assert [(int(r["groups"]), int(r["capacity"])) for r in ranks] == [(1, 8)] * len(ranks)
    dropped = [int(r["dropped"]) for r in ranks]
    first = [(rank // mdl) % (data // groups) == 0 for rank in range(len(ranks))]
    assert all((d == 0) == f for d, f in zip(dropped, first)), dropped


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

    kw, shape, _, _ = RUNS[name]
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
    heads. The residual stream entering a layer body is the rank's block of
    the positions, (b, S/model, D), where "model" divides S (every run but
    straddle_22's 7 positions on model 2); the MoE call routes every
    position of the rank's rows, as without sequence parallelism."""
    cfg = _cfg()
    kw, (data, mdl), _, (batch, seq) = RUNS[name]
    b = batch // data // kw.get("microbatches", 1)
    want = {"moe.w_gate": (cfg.padded_experts // mdl, cfg.d_model, cfg.moe_d_ff),
            "moe.w_down": (cfg.padded_experts // mdl, cfg.moe_d_ff, cfg.d_model),
            "moe.shared.w_up": (cfg.d_model, cfg.shared_expert_d_ff // mdl),
            "flash.q": (b, seq, cfg.num_heads // mdl, cfg.resolved_head_dim),
            "moe.x": (b, seq, cfg.d_model),
            "residual": (b, seq // mdl if seq % mdl == 0 else seq, cfg.d_model)}
    for rank, rec in enumerate(runs[name][2]):
        assert eval(str(rec["shapes"])) == want, (rank, rec["shapes"])


@pytest.mark.parametrize("name", list(RUNS))
def test_model_collectives_equal_the_formula(runs, name):
    """The collectives over "model" of one step, counted by the mesh on
    every rank, equal ``model_collectives`` (the MoE layer one split
    sub-layer, the router and the shared gate partial leaves, the norms too
    where the sequence is split): all-gathers, reduce-scatters and
    all-reduces where "model" divides the sequence, all-reduces alone where
    it does not (straddle_22's 7 positions), none at model 1."""
    _, (_, mdl), _, (_, seq) = RUNS[name]
    ops = (set() if mdl == 1 else {"all_gather", "reduce_scatter", "all_reduce"}
           if seq % mdl == 0 else {"all_reduce"})
    for rank, rec in enumerate(runs[name][2]):
        counts = eval(str(rec["counts"]))
        assert {op for op, _ in counts} == ops, (rank, counts)
        assert counts == eval(str(rec["formula"])), rank


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
def test_a_call_that_is_not_a_block_of_the_global_batch_raises():
    """6 tokens on each of 4 batch ranks are not a global batch of 25: the
    call raises before any collective."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models.modes import GlobalRouting, global_routing
    cfg, m, _ = _aux_inputs()
    x = torch.zeros(1, 6, cfg.d_model)
    with global_routing(GlobalRouting(Mesh(("data", "model"), (4, 1)), ("data",), 25)), \
            pytest.raises(ValueError, match="global batch"):
        moe.moe_apply(m, cfg, x)
