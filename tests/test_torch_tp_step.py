"""The port's tensor-parallel train step against the JAX package's, on the
CPU: gloo ranks of ``repro_torch.train.step.build_train_step`` on meshes
with a "model" axis of 2 against ``repro.train.step.build_train_step`` on
the same host meshes of forced host devices, from the same weights (the
reference's ``init_state``, moved through ``bridge.params_from_numpy``) and
the same two batches: qwen3-0.6b smoke fp32 on (data 2, model 2) with FSDP
off, on and with 2 microbatches, and on (1, 2) (tensor parallelism alone);
mamba2 and zamba2 smoke on (2, 2) with FSDP. Each run is two steps; the
losses, the new state (params, master, m, v, every leaf replicated over
"model" among them) and the second step's backup are compared.

The qwen3 run without FSDP clips its gradients at ``CLIP``, well below the
global norm it sees (1.497 at its first step, in both packages), so a norm
that counted a leaf once too often or too rarely would show in m and v.
Within the port each rank's bound blocks have the local block's shape, the
all-reduces over "model" of a step equal ``train.step.model_all_reduces``
in count and bytes, and the neighbour drill (a rank's optimizer shard
dropped and rebuilt from its "data" neighbour's backup) gives the
uninterrupted step bit for bit.

The reference runs in three subprocesses and the port's ranks in two sets of
spawned processes (4 ranks for (2, 2), 2 for (1, 2); ``file://``
rendezvous under the test's temporary directory), all at once, each joined
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
TOL = dict(rtol=2e-4, atol=2e-4)          # the training slice's fp32 tolerance
HP = dict(lr=1e-3, warmup_steps=0, total_steps=50)    # a non-zero rate at step 0
CLIP = 0.25
DEADLINE_S = 420                          # a hang guard: ~60 s alone, more beside other workers
SHAPE = (8, 16)                           # global batch, sequence
# name -> (arch, build_train_step keywords, mesh (data, model), AdamWConfig keywords)
RUNS = {
    "qwen3_nofsdp": ("qwen3-0.6b", dict(fsdp_params=False), (2, 2), dict(HP, grad_clip=CLIP)),
    "qwen3_fsdp": ("qwen3-0.6b", dict(fsdp_params=True), (2, 2), HP),
    "qwen3_mb2": ("qwen3-0.6b", dict(fsdp_params=True, microbatches=2), (2, 2), HP),
    "qwen3_tp_only": ("qwen3-0.6b", dict(fsdp_params=False), (1, 2), HP),
    "mamba2_fsdp": ("mamba2-2.7b", dict(fsdp_params=True), (2, 2), HP),
    "zamba2_fsdp": ("zamba2-7b", dict(fsdp_params=True), (2, 2), HP),
}
WITH_BACKUP = [k for k, v in RUNS.items() if v[2][0] > 1]
# the leaves replicated over "model" that split blocks read or that follow a
# split region, by family
REPLICATED = {"qwen3-0.6b": ("attn|q_norm", "attn|k_norm", "|ln1", "|ln2", "final_norm"),
              "mamba2-2.7b": ("mamba|w_b", "mamba|w_c", "mamba|conv_b", "mamba|conv_c",
                              "|ln1", "final_norm"),
              "zamba2-7b": ("mamba|w_b", "mamba|w_c", "mamba|conv_b", "mamba|conv_c",
                            "shared_attn|ln1", "shared_attn|ln2", "final_norm")}

JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.step import build_train_step

runs, data_dir, (batch, seq) = eval(sys.argv[1]), sys.argv[2], eval(sys.argv[3])

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

for name, (arch, kw, (data, mdl), hp) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    state = inp["state"].item()
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
    model = build_model(cfg)
    out = {}
    if "grad_clip" in hp:          # the global norm of the first step's gradient
        tokens = jnp.asarray(inp["batches"][0])
        g = jax.grad(lambda p: model.loss(p, {"tokens": tokens})[0])(state["params"])
        out["grad_norm0"] = np.sqrt(sum(float(jnp.sum(jnp.square(x.astype(jnp.float32))))
                                        for x in jax.tree_util.tree_leaves(g)))
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    art = build_train_step(model, mesh, AdamWConfig(**hp), donate=False,
                           shape=ShapeConfig("t", seq, batch, "train"), **kw)
    with mesh:
        for i, tokens in enumerate(inp["batches"]):
            state, metrics, backup = art.step_fn(state, {"tokens": jnp.asarray(tokens)})
            out[f"loss{i}"] = np.asarray(metrics["loss"], np.float32)
            if i == 0:
                out.update(flat(state["opt"]["m"], "state0|opt|m|"))
    out.update(flat(state, "state|"))
    out.update(flat(backup, "backup|"))
    np.savez(f"{data_dir}/{name}_jax.npz", **out)
"""


def _cfg(arch):
    return dataclasses.replace(j_reduce(j_get_arch(arch)), dtype="float32")


def _flat(tree, prefix):
    from repro_torch.tree import keystr, tree_flatten_with_path
    return {prefix + keystr(p): t.detach().float().numpy()
            for p, t in tree_flatten_with_path(tree, lambda x: x is None) if t is not None}


# ------------------------------- the ranks -------------------------------- #
def _record_bound_shapes(seen: dict) -> None:
    """Wrap the calls that receive the bound blocks, so that the first step
    of a run records their shapes: the layer parameters as the bodies get
    them (after the FSDP gather), the embedding and the head, and the
    inputs of the attention and SSD calls."""
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
        for sub, leaf in (("attn", "wq"), ("mlp", "w_up"), ("mamba", "w_x")):
            if isinstance(p, dict) and sub in p:
                seen.setdefault(f"{sub}.{leaf}", tuple(p[sub][leaf].shape))
    wrap(transformer, "unshard_layer_params", layer)
    wrap(transformer, "embed_lookup", lambda a, _: seen.setdefault("embed.w", tuple(a[0].shape)))
    wrap(transformer, "chunked_xent", lambda a, _: seen.setdefault("head.w", tuple(a[0].shape)))
    wrap(ops, "flash_attention", lambda a, _: seen.setdefault("flash.q", tuple(a[0].shape)))
    wrap(ops, "ssd", lambda a, _: seen.setdefault("ssd.x", tuple(a[0].shape)))


def _rank_main(rank: int, world: int, data_dir: str, names: list):
    """One gloo rank: each run of ``names`` from the reference's initial
    state, two steps; rank 0 writes the joined state, backup and losses,
    and every rank its bound shapes and collective counts."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
    from repro_torch.core.instant import neighbor_backup
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step, model_all_reduces
    try:
        torch.set_num_threads(1)      # the ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous{world}",
                                rank=rank, world_size=world)
        seen = {}
        _record_bound_shapes(seen)
        for name in names:
            arch, kw, (data, mdl), hp = RUNS[name]
            inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
            model = params_from_numpy(inp["state"].item()["params"], cfg, device="cpu")
            mesh = make_host_mesh(data=data, model=mdl)
            art = build_train_step(model, mesh, AdamWConfig(**hp),
                                   shape=ShapeConfig("t", SHAPE[1], SHAPE[0], "train"), **kw)
            state = shard_init_state(param_tree(model), art.plan, mesh)
            out = {}
            batches = [torch.from_numpy(b) for b in inp["batches"]]
            for i, tokens in enumerate(batches):
                local = shd.local_block(tokens, art.input_pspecs["tokens"], mesh).contiguous()
                if i == len(batches) - 1 and name == "qwen3_fsdp":
                    out["drill_bitwise"] = np.asarray(
                        _drill(art, mesh, state, backup, local, neighbor_backup))
                seen.clear()
                mesh.reset_counts()
                state, metrics, backup = art.step_fn(state, {"tokens": local})
                out[f"loss{i}"] = metrics["loss"].numpy()
                if i == 0:
                    out.update(_flat(shd.join_tree(state["opt"]["m"], art.plan.opt_pspecs["m"],
                                                   mesh), "state0|opt|m|"))
                    out["grad_norm0"] = art.step_fn.last_grad_norm.numpy()
                    out["counts"] = np.asarray(mesh.counts.get(("all_reduce", ("model",)),
                                                               [0, 0]))
                    out["formula"] = np.asarray(model_all_reduces(
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
        # a param stored as the same block as its master is cast from it; one
        # replicated over "data" (the embedding) would come from a data peer
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


def _spawn_ranks(world: int, data_dir: Path, names: list):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(data_dir), names))
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
    data_dir = tmp_path_factory.mktemp("tp_step")
    rng = np.random.default_rng(0)
    for name, (arch, _, _, _) in RUNS.items():
        cfg = _cfg(arch)
        state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
        batches = rng.integers(0, cfg.vocab_size, (2, SHAPE[0], SHAPE[1] + 1)).astype(np.int32)
        np.savez(data_dir / f"{name}_in.npz", state=np.asarray(state, dtype=object),
                 batches=batches)
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    # three reference processes, each with its runs (the SSM family's two
    # compiles take as long as the dense family's four): the compiles are
    # the fixture's longest path
    def group(run):
        arch, kw, _, _ = run
        return "ssm" if arch != "qwen3-0.6b" else f"dense, fsdp {kw['fsdp_params']}"
    groups = [{k: v for k, v in RUNS.items() if group(v) == g}
              for g in dict.fromkeys(group(v) for v in RUNS.values())]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), repr(g), str(data_dir),
         repr(SHAPE)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for g in groups]
    by_world = {}
    for name, (_, _, (data, mdl), _) in RUNS.items():
        by_world.setdefault(data * mdl, []).append(name)
    procs = [p for world, names in by_world.items()
             for p in _spawn_ranks(world, data_dir, names)]
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
    for name, (_, _, (data, mdl), _) in RUNS.items():
        ranks = [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(data * mdl)]
        out[name] = (dict(np.load(data_dir / f"{name}_jax.npz")),
                     dict(np.load(data_dir / f"{name}_port.npz")), ranks)
    return out


# --------------------------------- tests ---------------------------------- #
@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax(runs, name):
    ref, port, _ = runs[name]
    for i in range(2):
        np.testing.assert_allclose(port[f"loss{i}"], ref[f"loss{i}"], **TOL)


def _assert_leaves_close(port, ref, keys, roll=None):
    """Every leaf of ``keys`` within TOL, the absolute part taken relative
    to the leaf's largest magnitude (m and v are far below 1).

    A param or master element also moves by what AdamW's first step makes
    of the gradient's own tolerance: lr * g / (|g| + eps) changes by up to
    lr * eps * d / (|g| + eps)^2 when g (here the reference's first clipped
    gradient, m / (1 - b1)) moves by d = TOL * the leaf's largest gradient,
    which m holds it to. That is negligible but where g is near eps: an
    element whose first gradient is below the noise of two reduction orders
    takes a first step that the noise decides (seen: 1 of 32,768 of zamba2's
    ``out``, g 1.6e-10 against 1.4e-9, moved 0.11 lr apart); it is held to
    at most 2 lr, what two steps can move it, and its m and v to TOL.
    ``roll(leaf, x)`` places a leaf's first gradient as the backup holds it
    (each rank's block is its predecessor's)."""
    for k in keys:
        atol = TOL["atol"] * float(np.abs(ref[k]).max())
        leaf = _updated_leaf(k)
        if leaf and "state0|opt|m|" + leaf in ref:
            g = np.abs(ref["state0|opt|m|" + leaf]) / (1 - 0.9)
            g = roll(leaf, g) if roll else g
            d = TOL["atol"] * float(g.max())
            atol = atol + HP["lr"] * np.minimum(2.0, 1e-8 * d / (g + 1e-8) ** 2)
        _close(port[k], ref[k], atol, k)


def _updated_leaf(key: str):
    """The leaf path of a param, master or backed-up master key, else None."""
    parts = key.split("|")
    for head in (["state", "params"], ["state", "opt", "master"], ["backup", "master"]):
        if parts[:len(head)] == head:
            return "|".join(parts[len(head):])
    return None


def _close(got, want, atol, name):
    bad = np.abs(got - want) > atol + TOL["rtol"] * np.abs(want)
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} elements differ, "
                           f"largest {float(np.abs(got - want)[bad].max())}")


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
    """The leaves replicated over "model" whose gradient each rank computes
    in part (qk-norm, Mamba2's SSD group) or in full after f's all-reduce
    (the norms): their m (the first step's gradient, and the second's) and
    params, with the rank at model index 0 holding the joined copy."""
    ref, port, _ = runs[name]
    wanted = REPLICATED[RUNS[name][0]]
    keys = [k for part in ("params", "opt|m", "opt|v")
            for k in _keys(port, ref, f"state|{part}|") if k.endswith(wanted)]
    assert len(keys) == 3 * len(wanted), keys
    _assert_leaves_close(port, ref, keys)


@pytest.mark.parametrize("name", WITH_BACKUP)
def test_backup_matches_jax(runs, name):
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_spec, sharded_dim
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import keystr, tree_flatten_with_path

    arch, kw, shape, _ = RUNS[name]
    model = build_model(reduce_for_smoke(get_arch(arch)), device="meta")
    plan = make_state_plan(model, Mesh(("data", "model"), shape),
                           fsdp_params=kw.get("fsdp_params", True))
    dims = {keystr(p): sharded_dim(spec)
            for p, spec in tree_flatten_with_path(plan.opt_pspecs["master"], is_spec)}

    def roll(leaf, x):
        dim = dims[leaf]
        return x if dim is None else np.roll(x, x.shape[dim] // shape[0], axis=dim)

    ref, port, _ = runs[name]
    _assert_leaves_close(port, ref, _keys(port, ref, "backup|"), roll)


def test_neighbor_drill_rebuilds_the_step_bitwise(runs):
    assert runs["qwen3_fsdp"][1]["drill_bitwise"]


def test_grad_norm_matches_jax_where_the_clip_binds(runs):
    """The port's global norm (``step_fn.last_grad_norm``) of the first
    step equals the norm of JAX's full-batch gradient, and the clip is well
    below it, so m and v (held by the state tests) carry the clip."""
    ref, port, _ = runs["qwen3_nofsdp"]
    assert float(ref["grad_norm0"]) > 4 * CLIP
    np.testing.assert_allclose(port["grad_norm0"], ref["grad_norm0"], **TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_bound_blocks_are_the_local_blocks(runs, name):
    """Every rank computes on its "model" blocks: the layer bodies' wq,
    w_up, w_x, the embedding and the head, and the q of the attention call
    and the x of the SSD call carry 1/model of the heads, columns or rows."""
    arch, _, (data, mdl), _ = RUNS[name]
    cfg = _cfg(arch)
    b, s, hd = SHAPE[0] // data // RUNS[name][1].get("microbatches", 1), SHAPE[1], \
        cfg.resolved_head_dim
    want = {"embed.w": (cfg.padded_vocab // mdl, cfg.d_model),
            "head.w": (cfg.padded_vocab // mdl, cfg.d_model)}
    if cfg.family in ("dense", "hybrid"):
        want["attn.wq"] = (cfg.d_model, cfg.num_heads * hd // mdl)
        want["mlp.w_up"] = (cfg.d_model, cfg.d_ff // mdl)
        want["flash.q"] = (b, s, cfg.num_heads // mdl, hd)
    if cfg.family in ("ssm", "hybrid"):
        want["mamba.w_x"] = (cfg.d_model, cfg.ssm_inner // mdl)
        want["ssd.x"] = (b, s, cfg.ssm_heads // mdl, cfg.ssm_head_dim)
    for rank, rec in enumerate(runs[name][2]):
        assert eval(str(rec["shapes"])) == want, (rank, rec["shapes"])


@pytest.mark.parametrize("name", list(RUNS))
def test_model_all_reduces_equal_the_formula(runs, name):
    """The all-reduces over "model" of one step, counted by the mesh on
    every rank, equal ``model_all_reduces`` in calls and in bytes."""
    for rank, rec in enumerate(runs[name][2]):
        assert rec["counts"][0] > 0
        assert list(rec["counts"]) == list(rec["formula"]), rank


# ------------------------- no processes needed ---------------------------- #
def test_split_q_heads_over_replicated_kv_heads_raise():
    """qwen3 smoke (4 q / 2 kv heads) on model 4: ``_leaf_spec`` splits wq
    and leaves wk and wv replicated; the step refuses it, naming its item."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import build_train_step
    model = build_model(reduce_for_smoke(get_arch("qwen3-0.6b")), device="meta")
    with pytest.raises(NotImplementedError, match="item 9f"):
        build_train_step(model, Mesh(("data", "model"), (1, 4)))


def test_the_formula_counts_every_split_region():
    """``model_all_reduces`` at full width: qwen3-0.6b on (2, 2), FSDP, one
    microbatch of 4 x 1024: 1 + 28 x 5 + 3 + 1 all-reduces (the embedding,
    each layer's two regions twice and its attention's recomputed g, the
    cross-entropy, the bf16 qk-norm gradients); none at model 1."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import model_all_reduces
    model = build_model(get_arch("qwen3-0.6b"), device="meta")
    act = 4 * 1024 * 1024 * 2
    calls, nbytes = model_all_reduces(model, Mesh(("data", "model"), (2, 2)), 4, 1024)
    assert calls == 1 + 28 * 5 + 3 + 1
    qk = 2 * 28 * 128 * 2 // 2                       # q_norm and k_norm, a "data" half
    assert nbytes == act * (1 + 28 * 5 + 1) + 4 * 1024 * 12 + qk
    assert model_all_reduces(model, Mesh(("data", "model"), (4, 1)), 2, 1024) == (0, 0)


@pytest.mark.parametrize("arch, mesh_shape, expected", [
    ("qwen3-0.6b", (2, 2), {"blocks.attn.q_norm", "blocks.attn.k_norm"}),
    ("mamba2-2.7b", (2, 2), {"blocks.mamba.w_b", "blocks.mamba.w_c", "blocks.mamba.conv_b",
                             "blocks.mamba.conv_c"}),
    ("zamba2-7b", (1, 2), {"blocks.mamba.w_b", "blocks.mamba.w_c", "blocks.mamba.conv_b",
                           "blocks.mamba.conv_c"}),
    ("qwen3-0.6b", (4, 1), set()),
])
def test_partial_leaves_come_from_the_specs(arch, mesh_shape, expected):
    """The leaves whose gradient ``data_mean`` sums over "model" are those
    replicated in a sub-layer whose other leaves the specs split, at full
    width: the qk-norm scales and Mamba2's SSD group, never a norm before a
    split region (its gradient is whole after f's backward), none at model 1."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.state import make_state_plan
    from repro_torch.train.step import _leaves, _Loss
    from repro_torch.tree import tree_flatten_with_path
    model = build_model(get_arch(arch), device="meta")
    mesh = Mesh(("data", "model"), mesh_shape)
    plan = make_state_plan(model, mesh, fsdp_params=True)
    paths = [".".join(map(str, p)) for p, _ in
             tree_flatten_with_path(plan.state_specs["params"])]
    partial = {p for p, leaf in zip(paths, _leaves(plan, _Loss(model), mesh)) if leaf.partial}
    assert partial == expected
