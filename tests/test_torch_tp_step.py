"""The port's tensor-parallel train step against the JAX package's, on the
CPU: gloo ranks of ``repro_torch.train.step.build_train_step`` on meshes
with a "model" axis of 2 against ``repro.train.step.build_train_step`` on
the same host meshes of forced host devices, from the same weights (the
reference's ``init_state``, moved through ``bridge.params_from_numpy``) and
the same two batches: qwen3-0.6b smoke fp32 on (data 2, model 2) with FSDP
off, on and with 2 microbatches, and on (1, 2) (tensor parallelism alone);
mamba2 and zamba2 smoke on (2, 2) with FSDP; and the q heads split over
"model" beside replicated kv heads: gemma-2b smoke (4 q heads, 1 kv head) on
(2, 2) with FSDP, qwen3-0.6b smoke (4 q, 2 kv) on (1, 4). Their 16
positions divide by 2 and 4, so every one of these runs splits the residual
stream by sequence over "model" (sequence parallelism: a layer body's input
is a rank's (b, 16/model, D) block). One more run, qwen3 on (1, 2) at 15
positions, which "model" does not divide, keeps the Megatron layout, as the
reference's ``constrain`` does. Each run is two steps; the losses, the new
state (params, master, m, v, every leaf replicated over "model" among them)
and the second step's backup are compared.

The qwen3 run without FSDP clips its gradients at ``CLIP``, well below the
global norm it sees (1.497 at its first step, in both packages), so a norm
that counted a leaf once too often or too rarely would show in m and v.
Within the port each rank's bound blocks have the local block's shape, the
collectives over "model" of a step equal ``train.step.model_collectives``
in count and bytes (no all-reduce of an activation where the sequence is
split), and the neighbour drill (a rank's optimizer shard dropped and
rebuilt from its "data" neighbour's backup) gives the uninterrupted step bit
for bit. The 2-rank processes also hold ``Mesh.gather_to`` and
``Mesh.scatter_from`` against their definitions, forward and backward.

The reference runs in four subprocesses and the port's ranks in two sets of
spawned processes (4 ranks for (2, 2) and (1, 4), 2 for (1, 2); ``file://``
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
BATCH, SEQ = 8, 16                        # global batch, sequence
# name -> (arch, build_train_step keywords, mesh (data, model), AdamWConfig keywords,
# sequence)
RUNS = {
    "qwen3_nofsdp": ("qwen3-0.6b", dict(fsdp_params=False), (2, 2), dict(HP, grad_clip=CLIP),
                     SEQ),
    "qwen3_fsdp": ("qwen3-0.6b", dict(fsdp_params=True), (2, 2), HP, SEQ),
    "qwen3_mb2": ("qwen3-0.6b", dict(fsdp_params=True, microbatches=2), (2, 2), HP, SEQ),
    "qwen3_tp_only": ("qwen3-0.6b", dict(fsdp_params=False), (1, 2), HP, SEQ),
    "mamba2_fsdp": ("mamba2-2.7b", dict(fsdp_params=True), (2, 2), HP, SEQ),
    "zamba2_fsdp": ("zamba2-7b", dict(fsdp_params=True), (2, 2), HP, SEQ),
    "gemma_fsdp": ("gemma-2b", dict(fsdp_params=True), (2, 2), HP, SEQ),
    "qwen3_model4": ("qwen3-0.6b", dict(fsdp_params=False), (1, 4), HP, SEQ),
    # 15 positions do not split over "model": the Megatron layout
    "qwen3_seq15": ("qwen3-0.6b", dict(fsdp_params=True), (1, 2), HP, 15),
}
WITH_BACKUP = [k for k, v in RUNS.items() if v[2][0] > 1]
SEQ_COLLECTIVES = ["gather_summed", "gather_whole", "scatter_summed", "scatter_whole"]
# the leaves replicated over "model" that split blocks read or that follow a
# split region, by family (and wk, wv where the kv heads do not divide the
# axis, ``KV_REPLICATED``)
KV_REPLICATED = ("attn|wk", "attn|wv")
REPLICATED = {"qwen3-0.6b": ("attn|q_norm", "attn|k_norm", "|ln1", "|ln2", "final_norm"),
              "gemma-2b": ("|ln1", "|ln2", "final_norm"),
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

runs, data_dir, batch = eval(sys.argv[1]), sys.argv[2], eval(sys.argv[3])

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

for name, (arch, kw, (data, mdl), hp, seq) in runs.items():
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


def _kv_replicated(arch, mdl):
    """The q heads split over "model" and the kv heads do not."""
    cfg = _cfg(arch)
    return cfg.family == "dense" and cfg.num_kv_heads % mdl != 0


def _flat(tree, prefix):
    from repro_torch.tree import keystr, tree_flatten_with_path
    return {prefix + keystr(p): t.detach().float().numpy()
            for p, t in tree_flatten_with_path(tree, lambda x: x is None) if t is not None}


# ------------------------------- the ranks -------------------------------- #
def _record_bound_shapes(seen: dict) -> None:
    """Wrap the calls that receive the bound blocks, so that the first step
    of a run records their shapes: the layer parameters as the bodies get
    them (after the FSDP gather), the embedding and the head, the inputs of
    the attention and SSD calls, the residual stream entering a layer body
    (``run_layer``'s last argument), and the all-reduces over "model" of an
    activation (a tensor of d_model columns; ``seen["d_model"]`` says which
    width that is)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
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
    wrap(ops, "flash_attention", lambda a, _: (seen.setdefault("flash.q", tuple(a[0].shape)),
                                               seen.setdefault("flash.k", tuple(a[1].shape))))
    wrap(ops, "ssd", lambda a, _: seen.setdefault("ssd.x", tuple(a[0].shape)))
    wrap(transformer, "run_layer", lambda a, _: seen.setdefault("residual", tuple(a[-1].shape)))
    all_reduce = Mesh.all_reduce

    def counted(self, x, axes, *args, **kw):
        if axes in ("model", ("model",)) and x.dim() == 3 and x.shape[-1] == seen.get("d_model"):
            seen["activation_all_reduces"] = seen.get("activation_all_reduces", 0) + 1
        return all_reduce(self, x, axes, *args, **kw)
    Mesh.all_reduce = counted


def _rank_main(rank: int, world: int, data_dir: str, names: list):
    """One gloo rank: each run of ``names`` from the reference's initial
    state, two steps; rank 0 writes the joined state, backup and losses,
    and every rank its bound shapes and collective counts; the 2-rank
    processes then hold the sequence collectives (``_seq_collectives``)."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
    from repro_torch.core.instant import neighbor_backup
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step, model_collectives
    try:
        torch.set_num_threads(1)      # the ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous{world}",
                                rank=rank, world_size=world)
        seen = {}
        _record_bound_shapes(seen)
        for name in names:
            arch, kw, (data, mdl), hp, seq = RUNS[name]
            inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
            model = params_from_numpy(inp["state"].item()["params"], cfg, device="cpu")
            mesh = make_host_mesh(data=data, model=mdl)
            art = build_train_step(model, mesh, AdamWConfig(**hp),
                                   shape=ShapeConfig("t", seq, BATCH, "train"), **kw)
            state = shard_init_state(param_tree(model), art.plan, mesh)
            out = {}
            batches = [torch.from_numpy(b) for b in inp["batches"]]
            for i, tokens in enumerate(batches):
                local = shd.local_block(tokens, art.input_pspecs["tokens"], mesh).contiguous()
                if i == len(batches) - 1 and name == "qwen3_fsdp":
                    out["drill_bitwise"] = np.asarray(
                        _drill(art, mesh, state, backup, local, neighbor_backup))
                seen.clear()
                seen["d_model"] = cfg.d_model
                mesh.reset_counts()
                state, metrics, backup = art.step_fn(state, {"tokens": local})
                out[f"loss{i}"] = metrics["loss"].numpy()
                if i == 0:
                    out.update(_flat(shd.join_tree(state["opt"]["m"], art.plan.opt_pspecs["m"],
                                                   mesh), "state0|opt|m|"))
                    out["grad_norm0"] = art.step_fn.last_grad_norm.numpy()
                    out["counts"] = np.asarray(repr({k: v for k, v in mesh.counts.items()
                                                     if k[1] == ("model",)}))
                    out["formula"] = np.asarray(repr(model_collectives(
                        model, mesh, local.shape[0], seq, **kw)))
                    out["activation_all_reduces"] = np.asarray(
                        seen.pop("activation_all_reduces", 0))
                    del seen["d_model"]
                    out["shapes"] = np.asarray(repr(dict(seen)))
            np.savez(f"{data_dir}/{name}_rank{rank}.npz", **{
                k: v for k, v in out.items()
                if k in ("counts", "formula", "shapes", "activation_all_reduces")})
            full = shd.join_tree(state, art.plan.state_pspecs, mesh)
            joined_backup = shd.join_tree(backup, art.backup_pspecs, mesh)
            if rank == 0:
                out.update(_flat(full, "state|"))
                out.update(_flat(joined_backup, "backup|"))
                np.savez(f"{data_dir}/{name}_port.npz", **out)
        if world == 2:
            np.savez(f"{data_dir}/seq_collectives_rank{rank}.npz", **_seq_collectives())
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _seq_collectives() -> dict:
    """``Mesh.gather_to`` and ``Mesh.scatter_from`` on a (1, 2) mesh, summed
    and not, against their definitions: each rank's input and the weights
    of its loss drawn from seeds that every rank knows, so each computes
    the expected output and gradient of its own. The largest difference of
    each, forward and backward."""
    import contextlib

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=1, model=2)
    me = mesh.index("model")

    def draw(seed, *shape):
        return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                                .astype(np.float32))
    blocks = [draw(10 + r, 2, 3, 4) for r in range(2)]          # a rank's positions
    wholes = [draw(20 + r, 2, 6, 4) for r in range(2)]          # a region's output
    weights = [draw(30 + r, 2, 6, 4) for r in range(2)]         # a loss on 6 positions
    cuts = [draw(40 + r, 2, 3, 4) for r in range(2)]            # a loss on 3 positions
    out = {}
    for summed in (True, False):
        tag = "summed" if summed else "whole"
        x = blocks[me].clone().requires_grad_()
        y = mesh.gather_to(x, "model", 1, contextlib.nullcontext, summed=summed)
        (g,) = torch.autograd.grad((y * weights[me]).sum(), [x])
        want = (sum(weights) if summed else weights[me])[:, 3 * me:3 * me + 3]
        out[f"gather_{tag}"] = np.asarray([
            float((y - torch.cat(blocks, 1)).abs().max()), float((g - want).abs().max())])
        z = wholes[me].clone().requires_grad_()
        y = mesh.scatter_from(z, "model", 1, contextlib.nullcontext, summed=summed)
        (g,) = torch.autograd.grad((y * cuts[me]).sum(), [z])
        want = (sum(wholes) if summed else wholes[me])[:, 3 * me:3 * me + 3]
        out[f"scatter_{tag}"] = np.asarray([
            float((y - want).abs().max()), float((g - torch.cat(cuts, 1)).abs().max())])
    return out


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
    for name, (arch, _, _, _, seq) in RUNS.items():
        cfg = _cfg(arch)
        state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
        batches = rng.integers(0, cfg.vocab_size, (2, BATCH, seq + 1)).astype(np.int32)
        np.savez(data_dir / f"{name}_in.npz", state=np.asarray(state, dtype=object),
                 batches=batches)
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    # four reference processes, each with its runs (the SSM family's two
    # compiles take as long as the dense family's four): the compiles are
    # the fixture's longest path
    def group(run):
        arch, kw, (_, mdl), _, _ = run
        if arch in ("mamba2-2.7b", "zamba2-7b"):
            return "ssm"
        if _kv_replicated(arch, mdl):
            return "kv heads replicated"
        return f"dense, fsdp {kw['fsdp_params']}"
    groups = [{k: v for k, v in RUNS.items() if group(v) == g}
              for g in dict.fromkeys(group(v) for v in RUNS.values())]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), repr(g), str(data_dir),
         repr(BATCH)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for g in groups]
    by_world = {}
    for name, (_, _, (data, mdl), _, _) in RUNS.items():
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
    for name, (_, _, (data, mdl), _, _) in RUNS.items():
        ranks = [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(data * mdl)]
        out[name] = (dict(np.load(data_dir / f"{name}_jax.npz")),
                     dict(np.load(data_dir / f"{name}_port.npz")), ranks)
    out["seq_collectives"] = [dict(np.load(data_dir / f"seq_collectives_rank{r}.npz"))
                              for r in range(2)]
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
    in part (qk-norm, Mamba2's SSD group, and the norms where the sequence
    is split: a rank's positions) or in full after f's all-reduce (the
    norms where it is not): their m (the first step's gradient, and the
    second's) and params, with the rank at model index 0 holding the joined
    copy."""
    ref, port, _ = runs[name]
    arch, _, (_, mdl), _, _ = RUNS[name]
    wanted = REPLICATED[arch] + (KV_REPLICATED if _kv_replicated(arch, mdl) else ())
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

    arch, kw, shape, _, _ = RUNS[name]
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
    and the x of the SSD call carry 1/model of the heads, columns or rows;
    the k of the attention call the kv heads of the rank's q heads (1/model
    of them, or the one that its q heads read where they do not divide).
    The residual stream entering a layer body is the rank's block of the
    positions, (b, S/model, D), where "model" divides S, else (b, S, D);
    the attention and the SSD read every position either way."""
    arch, _, (data, mdl), _, s = RUNS[name]
    cfg = _cfg(arch)
    b, hd = BATCH // data // RUNS[name][1].get("microbatches", 1), cfg.resolved_head_dim
    want = {"embed.w": (cfg.padded_vocab // mdl, cfg.d_model),
            "head.w": (cfg.padded_vocab // mdl, cfg.d_model),
            "residual": (b, s // mdl if s % mdl == 0 else s, cfg.d_model)}
    if cfg.family in ("dense", "hybrid"):
        want["attn.wq"] = (cfg.d_model, cfg.num_heads * hd // mdl)
        want["mlp.w_up"] = (cfg.d_model, cfg.d_ff // mdl)
        want["flash.q"] = (b, s, cfg.num_heads // mdl, hd)
        group = cfg.num_heads // cfg.num_kv_heads
        want["flash.k"] = (b, s, max(1, cfg.num_heads // mdl // group), hd)
    if cfg.family in ("ssm", "hybrid"):
        want["mamba.w_x"] = (cfg.d_model, cfg.ssm_inner // mdl)
        want["ssd.x"] = (b, s, cfg.ssm_heads // mdl, cfg.ssm_head_dim)
    for rank, rec in enumerate(runs[name][2]):
        assert eval(str(rec["shapes"])) == want, (rank, rec["shapes"])


@pytest.mark.parametrize("name", list(RUNS))
def test_model_collectives_equal_the_formula(runs, name):
    """The collectives over "model" of one step, counted by the mesh on
    every rank, equal ``model_collectives`` in calls and in bytes: with the
    sequence split, all-gathers and reduce-scatters and no all-reduce of an
    activation (only statistics and the summed leaves' gradients); at 15
    positions the Megatron layout's all-reduces alone."""
    _, _, (_, mdl), _, seq = RUNS[name]
    sp = seq % mdl == 0
    for rank, rec in enumerate(runs[name][2]):
        counts = eval(str(rec["counts"]))
        assert counts == eval(str(rec["formula"])), rank
        ops = {op for op, _ in counts}
        assert ops == ({"all_gather", "reduce_scatter", "all_reduce"} if sp
                       else {"all_reduce"}), (rank, counts)
        assert (int(rec["activation_all_reduces"]) == 0) == sp, (rank, counts)


@pytest.mark.parametrize("check", SEQ_COLLECTIVES)
def test_sequence_collectives_on_two_ranks(runs, check):
    """``Mesh.gather_to`` joins the ranks' blocks and reduce-scatters the
    gradient (summed) or takes the rank's block of it (whole);
    ``Mesh.scatter_from`` takes the rank's block of the ranks' sum (summed)
    or of its own input (whole) and all-gathers the gradient: output and
    gradient on both ranks of a (1, 2) mesh, exactly."""
    for rank, rec in enumerate(runs["seq_collectives"]):
        assert list(rec[check]) == [0.0, 0.0], (rank, list(rec[check]))


# ------------------------- no processes needed ---------------------------- #
@pytest.mark.parametrize("heads, kv_heads, tp", [(8, 1, 2), (4, 2, 4), (12, 3, 2), (12, 3, 4)])
def test_split_q_heads_read_their_kv_heads(heads, kv_heads, tp):
    """q heads split over "model" beside whole wk, wv (kv heads that do not
    divide the axis): each rank's attention output (its q heads, its rows of
    wo) summed over the ranks is the whole attention's, and so are the
    gradients of wk, wv and k_norm (each rank's a part of the sum, as the
    step sums a ``partial`` leaf). 8/1 on 2 and 4/2 on 4 keep one group a
    rank (gemma-2b, qwen3 smoke); 12/3 on 2 and 4 give a rank q heads of
    two kv heads unevenly, one kv head per q head."""
    import contextlib

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import attention as attn
    from repro_torch.models.modes import TensorParallel, tensor_parallel
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32",
                              num_heads=heads, num_kv_heads=kv_heads)
    hd, d = cfg.resolved_head_dim, cfg.d_model
    rng = np.random.default_rng(3)
    shapes = {"wq": (d, heads * hd), "wk": (d, kv_heads * hd), "wv": (d, kv_heads * hd),
              "wo": (heads * hd, d), "q_norm": (hd,), "k_norm": (hd,)}
    full = {k: torch.from_numpy((rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32))
            for k, s in shapes.items()}
    x = torch.from_numpy(rng.normal(size=(2, 12, d)).astype(np.float32))

    def run(p, tp_ctx):
        p = {k: v.clone().requires_grad_() for k, v in p.items()}
        with tensor_parallel(tp_ctx):
            out = attn.self_attention(p, cfg, x)
        grads = torch.autograd.grad((out * torch.linspace(-1, 1, d)).sum(),
                                    [p["wk"], p["wv"], p["k_norm"]])
        return out.detach(), grads

    want, want_grads = run(full, None)
    per = heads // tp * hd
    got, got_grads = 0, [0, 0, 0]
    for r in range(tp):
        p = dict(full, wq=full["wq"][:, r * per:(r + 1) * per],
                 wo=full["wo"][r * per:(r + 1) * per])
        mesh = Mesh(("data", "model"), (1, tp), rank=r)
        out, grads = run(p, TensorParallel(mesh, contextlib.nullcontext))
        got = got + out
        got_grads = [a + g for a, g in zip(got_grads, grads)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_the_formula_counts_gemmas_replicated_kv_heads():
    """``model_collectives`` for gemma-2b at full width on (2, 2), FSDP, one
    microbatch of 4 x 1024, the sequence split: as qwen3's below over 18
    layers, a = A/2; the all-reduces the cross-entropy's two and one over
    the bf16 wk and wv gradients (a "data" half of each) with the norms'.
    At 4 x 1023 the Megatron layout's 1 + 18 x 5 + 3 + 1 all-reduces."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import model_collectives
    model = build_model(get_arch("gemma-2b"), device="meta")
    mesh = Mesh(("data", "model"), (2, 2))
    act = 4 * 1024 * 2048 * 2
    kv = 2 * 18 * 2048 * 256 * 2 // 2
    norms = (2 * 18 * 2048 + 2048) * 2 // 2             # ln1, ln2, final_norm
    assert model_collectives(model, mesh, 4, 1024) == {
        ("all_gather", ("model",)): [1 + 18 * 6 + 1, (1 + 18 * 6 + 1) * act // 2],
        ("reduce_scatter", ("model",)): [1 + 18 * 5 + 1, (1 + 18 * 5 + 1) * act],
        ("all_reduce", ("model",)): [2 + 1, 4 * 1024 * 12 + kv + norms]}
    act = 4 * 1023 * 2048 * 2
    assert model_collectives(model, mesh, 4, 1023) == {("all_reduce", ("model",)): [
        1 + 18 * 5 + 3 + 1, act * (1 + 18 * 5 + 1) + 4 * 1023 * 12 + kv]}


def test_the_formula_counts_every_split_region():
    """``model_collectives`` at full width: qwen3-0.6b on (2, 2), FSDP, one
    microbatch of 4 x 1024, the sequence split, a = A/2: the embedding's
    reduce-scatter and its backward gather; each layer's two regions, each
    an all-gather in and a reduce-scatter out forward and backward, and the
    recompute's three (its last exit is not run again): 6 gathers and 5
    scatters a layer; the head's gather and its backward scatter; the
    cross-entropy's two statistics and one all-reduce of the bf16 qk-norm
    and norm gradients: 315 calls. At 4 x 1023, which "model" does not
    divide, the Megatron layout: 1 + 28 x 5 + 3 + 1 all-reduces. None at
    model 1."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import model_collectives
    model = build_model(get_arch("qwen3-0.6b"), device="meta")
    mesh = Mesh(("data", "model"), (2, 2))
    act = 4 * 1024 * 1024 * 2
    qk = 2 * 28 * 128 * 2 // 2                       # q_norm and k_norm, a "data" half
    norms = (2 * 28 * 1024 + 1024) * 2 // 2          # ln1, ln2, final_norm
    got = model_collectives(model, mesh, 4, 1024)
    assert got == {
        ("all_gather", ("model",)): [1 + 28 * 6 + 1, (1 + 28 * 6 + 1) * act // 2],
        ("reduce_scatter", ("model",)): [1 + 28 * 5 + 1, (1 + 28 * 5 + 1) * act],
        ("all_reduce", ("model",)): [2 + 1, 4 * 1024 * 12 + qk + norms]}
    assert sum(calls for calls, _ in got.values()) == 315
    act = 4 * 1023 * 1024 * 2
    assert model_collectives(model, mesh, 4, 1023) == {("all_reduce", ("model",)): [
        1 + 28 * 5 + 3 + 1, act * (1 + 28 * 5 + 1) + 4 * 1023 * 12 + qk]}
    assert model_collectives(model, Mesh(("data", "model"), (4, 1)), 2, 1024) == {}


@pytest.mark.parametrize("arch, mesh_shape, expected, norms", [
    ("qwen3-0.6b", (2, 2), {"blocks.attn.q_norm", "blocks.attn.k_norm"},
     {"blocks.ln1", "blocks.ln2", "final_norm"}),
    ("mamba2-2.7b", (2, 2), {"blocks.mamba.w_b", "blocks.mamba.w_c", "blocks.mamba.conv_b",
                             "blocks.mamba.conv_c"}, {"blocks.ln1", "final_norm"}),
    ("zamba2-7b", (1, 2), {"blocks.mamba.w_b", "blocks.mamba.w_c", "blocks.mamba.conv_b",
                           "blocks.mamba.conv_c"},
     {"blocks.ln1", "shared_attn.ln1", "shared_attn.ln2", "final_norm"}),
    ("gemma-2b", (2, 2), {"blocks.attn.wk", "blocks.attn.wv"},
     {"blocks.ln1", "blocks.ln2", "final_norm"}),
    ("qwen3-0.6b", (1, 16), {"blocks.attn.q_norm", "blocks.attn.k_norm", "blocks.attn.wk",
                             "blocks.attn.wv"}, {"blocks.ln1", "blocks.ln2", "final_norm"}),
    ("qwen3-0.6b", (4, 1), set(), set()),
])
def test_partial_leaves_come_from_the_specs(arch, mesh_shape, expected, norms):
    """The leaves whose gradient ``data_mean`` sums over "model" at full
    width. With the sequence replicated over "model" (the Megatron layout)
    those replicated in a sub-layer whose other leaves the specs split: the
    qk-norm scales and Mamba2's SSD group, never a norm before a split
    region (its gradient is whole after f's backward), wk and wv where the
    kv heads do not divide the axis. With the sequence split, the norms of
    the residual stream too (``ln1``, ``ln2``, the shared block's and
    ``final_norm``: each rank applies them to its positions). None at
    model 1."""
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
    leaves = _leaves(plan, _Loss(model), mesh)
    assert {p for p, leaf in zip(paths, leaves) if leaf.summed(False)} == expected
    assert {p for p, leaf in zip(paths, leaves) if leaf.summed(True)} == expected | norms
