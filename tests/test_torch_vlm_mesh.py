"""The port's VLM on a mesh against the JAX package's, on the CPU: gloo ranks
of ``repro_torch.train.step.build_train_step`` and of
``repro_torch.train.serve``'s mesh builders against ``repro.train.step`` /
``repro.train.serve`` on the same host meshes of forced host devices, from
the same weights (the reference's ``init_state`` / ``init``, moved through
``bridge.params_from_numpy``), the same tokens and the same patch
embeddings (``rng.normal``), at the smoke size of internvl2-26b (2 layers, 4
q / 2 kv heads of 16, 8 patch tokens, vocabulary 256), fp32, at 2e-4.

Train step, two steps a run; losses, the new state (params, master, m, v,
the leaves replicated over "model" among them) and the backup compared:

- (data 2, model 2) FSDP at S = 8 text tokens: 16 positions, so the residual
  stream splits by sequence and rank 0's block at "model" is all patches;
- (2, 2) FSDP at S = 12 (20 positions: a block of patches and tokens);
- (2, 2) FSDP with 2 microbatches (each rank's block of the patch rows);
- (1, 2) without FSDP at S = 7: 15 positions, which "model" does not
  divide, so the Megatron layout;
- (1, 4) with ``num_patch_tokens`` 6 (both packages' configs replaced alike)
  at S = 10 (16 positions: the sequence split) and at S = 12 (18 positions:
  not split, though 4 divides the 12 tokens);
- (2, 2) FSDP at 12 q / 2 kv heads: 6 q heads per kv head on a rank.

Within the port, every rank's collectives over "model" of a step equal
``train.step.model_collectives`` at num_patch_tokens + S positions, the
residual stream entering a layer body is the rank's block of those
positions where "model" divides them, and the cross-entropy reads the S
text positions of the gathered sequence.

Serve steps: prefill and 8 decode steps on (2, 2) and (1, 4), as
tests/test_torch_serve_mesh.py holds the other families: the prefill step at
max_len = the prompt's positions against JAX's step, at a longer cache T
against JAX's unsharded ``prefill``, then the decode steps against JAX's
decode step; the caches joined from the ranks' blocks; the collectives of a
prefill and of a decode step equal ``serve_collectives``.

The reference runs in three subprocesses and the port's ranks in two sets of
spawned processes (4 ranks, and 2 for the (1, 2) run; ``file://`` rendezvous
under the test's temporary directory), all at once, each joined with a
deadline."""
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
from test_torch_tp_step import HP, TOL, _assert_leaves_close, _flat, _join, _keys

ROOT = Path(__file__).resolve().parent.parent
ARCH = "internvl2-26b"
DEADLINE_S = 420                          # a hang guard: ~60 s alone, more beside other workers
BATCH = 8                                 # global batch
STEPS = 8                                 # decode steps
# name -> (build_train_step keywords, mesh (data, model), text tokens S,
#          config changes in both packages)
RUNS = {
    "fsdp_s8": (dict(fsdp_params=True), (2, 2), 8, {}),
    "fsdp_s12": (dict(fsdp_params=True), (2, 2), 12, {}),
    "mb2": (dict(fsdp_params=True, microbatches=2), (2, 2), 8, {}),
    "tp_only_odd": (dict(fsdp_params=False), (1, 2), 7, {}),
    "model4_s10": (dict(fsdp_params=False), (1, 4), 10, dict(num_patch_tokens=6)),
    "model4_s12": (dict(fsdp_params=False), (1, 4), 12, dict(num_patch_tokens=6)),
    "group6": (dict(fsdp_params=True), (2, 2), 8, dict(num_heads=12, num_kv_heads=2)),
}
WITH_BACKUP = [k for k, v in RUNS.items() if v[1][0] > 1]
# the leaves replicated over "model" whose gradient a rank computes in part
# (or whole after f's all-reduce), and wk, wv where the kv heads do not divide
REPLICATED = ("|ln1", "|ln2", "final_norm")
KV_REPLICATED = ("attn|wk", "attn|wv")
# name -> (mesh (data, model), global batch, text tokens S, cache length T)
SERVE = {
    "serve_2x2": ((2, 2), BATCH, 12, 28),
    "serve_1x4": ((1, 4), BATCH, 12, 28),
}

TRAIN_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.step import build_train_step

runs, data_dir, batch, hp = eval(sys.argv[1]), sys.argv[2], eval(sys.argv[3]), eval(sys.argv[4])

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

for name, (kw, (data, mdl), text, changes) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    state = inp["state"].item()
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("internvl2-26b")), dtype="float32",
                              **changes)
    model = build_model(cfg)
    out = {}
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    art = build_train_step(model, mesh, AdamWConfig(**hp), donate=False,
                           shape=ShapeConfig("t", cfg.num_patch_tokens + text, batch, "train"),
                           **kw)
    with mesh:
        for i, (tokens, patches) in enumerate(zip(inp["batches"], inp["patches"])):
            state, metrics, backup = art.step_fn(state, {"tokens": jnp.asarray(tokens),
                                                         "patch_embeds": jnp.asarray(patches)})
            out[f"loss{i}"] = np.asarray(metrics["loss"], np.float32)
            if i == 0:
                out.update(flat(state["opt"]["m"], "state0|opt|m|"))
    out.update(flat(state, "state|"))
    out.update(flat(backup, "backup|"))
    np.savez(f"{data_dir}/{name}_jax.npz", **out)
"""

SERVE_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.train.serve import build_decode_step, build_prefill_step

runs, data_dir = eval(sys.argv[1]), sys.argv[2]

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

cfg = dataclasses.replace(reduce_for_smoke(get_arch("internvl2-26b")), dtype="float32")
model = build_model(cfg)
for name, ((data, mdl), b, s, t) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    params, feed = inp["params"].item(), inp["feed"]
    batch = {"tokens": jnp.asarray(inp["tokens"]), "patch_embeds": jnp.asarray(inp["patches"])}
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    out = {}
    prefill, _, _ = build_prefill_step(model, mesh,
                                       ShapeConfig("p", cfg.num_patch_tokens + s, b, "prefill"))
    with mesh:
        logits, cache = prefill(params, batch)
    out["prefill|logits"] = np.asarray(logits, np.float32)
    out.update(flat({k: v for k, v in cache.items() if k != "index"}, "prefill|cache|"))
    logits, cache = model.prefill(params, dict(batch, max_len=t))
    out["prefill_t|logits"] = np.asarray(logits, np.float32)
    out.update(flat({k: v for k, v in cache.items() if k != "index"}, "prefill_t|cache|"))
    decode, _, _ = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
    cache = jax.tree.map(np.asarray, cache)
    with mesh:
        for i in range(len(feed)):
            logits, cache = decode(params, cache, feed[i])
            out[f"decode{i}|logits"] = np.asarray(logits, np.float32)
    out.update(flat({k: v for k, v in cache.items() if k != "index"}, "final|cache|"))
    np.savez(f"{data_dir}/{name}_jax.npz", **out)
"""


def _j_cfg(changes=None):
    return dataclasses.replace(j_reduce(j_get_arch(ARCH)), dtype="float32", **(changes or {}))


def _t_cfg(changes=None):
    from repro_torch.configs import get_arch, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), dtype="float32",
                               **(changes or {}))


def _positions(name) -> int:
    _, _, text, changes = RUNS[name]
    return _t_cfg(changes).num_patch_tokens + text


# ------------------------------- the ranks -------------------------------- #
def _record(seen: dict) -> None:
    """Wrap the calls whose inputs show the layout, so that the first step
    of a run records their shapes: the residual stream entering a layer
    body (``run_layer``'s last argument), the flash call's q and k, and the
    head and the hidden states the cross-entropy reads."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    def wrap(owner, attr, record):
        fn = getattr(owner, attr)

        def wrapped(*args, **kw):
            record(args)
            return fn(*args, **kw)
        setattr(owner, attr, wrapped)

    wrap(transformer, "run_layer", lambda a: seen.setdefault("residual", tuple(a[-1].shape)))
    wrap(ops, "flash_attention", lambda a: (seen.setdefault("flash.q", tuple(a[0].shape)),
                                            seen.setdefault("flash.k", tuple(a[1].shape))))
    wrap(transformer, "chunked_xent", lambda a: (seen.setdefault("head.w", tuple(a[0].shape)),
                                                 seen.setdefault("xent.x", tuple(a[1].shape))))


def _train(rank: int, data_dir: str, name: str, seen: dict) -> None:
    """One run of RUNS on this rank: two steps from the reference's initial
    state; rank 0 writes the joined state, backup and losses, every rank
    its shapes and its collectives beside ``model_collectives``."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step, model_collectives

    kw, (data, mdl), text, changes = RUNS[name]
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    cfg = _t_cfg(changes)
    seq = cfg.num_patch_tokens + text
    model = params_from_numpy(inp["state"].item()["params"], cfg, device="cpu")
    mesh = make_host_mesh(data=data, model=mdl)
    art = build_train_step(model, mesh, AdamWConfig(**HP),
                           shape=ShapeConfig("t", seq, BATCH, "train"), **kw)
    state = shard_init_state(param_tree(model), art.plan, mesh)
    out, rec = {}, {}
    for i, (tokens, patches) in enumerate(zip(inp["batches"], inp["patches"])):
        batch = {"tokens": torch.from_numpy(tokens), "patch_embeds": torch.from_numpy(patches)}
        local = {k: shd.local_block(v, art.input_pspecs[k], mesh).contiguous()
                 for k, v in batch.items()}
        seen.clear()
        mesh.reset_counts()
        state, metrics, backup = art.step_fn(state, local)
        out[f"loss{i}"] = metrics["loss"].numpy()
        if i == 0:
            out.update(_flat(shd.join_tree(state["opt"]["m"], art.plan.opt_pspecs["m"], mesh),
                             "state0|opt|m|"))
            rec["counts"] = repr({k: v for k, v in mesh.counts.items() if k[1] == ("model",)})
            rec["formula"] = repr(model_collectives(model, mesh, local["tokens"].shape[0], seq,
                                                    **kw))
            rec["shapes"] = repr(dict(seen))
    np.savez(f"{data_dir}/{name}_rank{rank}.npz", **rec)
    full = shd.join_tree(state, art.plan.state_pspecs, mesh)
    joined_backup = shd.join_tree(backup, art.backup_pspecs, mesh)
    if rank == 0:
        out.update(_flat(full, "state|"))
        out.update(_flat(joined_backup, "backup|"))
        np.savez(f"{data_dir}/{name}_port.npz", **out)


def _serve(rank: int, data_dir: str, name: str) -> None:
    """One run of SERVE on this rank, as tests/test_torch_serve_mesh.py's
    ranks serve the other families, the patch rows given beside the
    tokens."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import P
    from repro_torch.train.serve import build_decode_step, build_prefill_step, serve_collectives
    from repro_torch.train.state import param_tree, shard_params
    from repro_torch.tree import keystr, tree_flatten_with_path

    (data, mdl), b, s, t = SERVE[name]
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    cfg = _t_cfg()
    model = params_from_numpy(inp["params"].item(), cfg, device="cpu")
    mesh = make_host_mesh(data=data, model=mdl)
    positions = cfg.num_patch_tokens + s
    prefill, plan, in_specs = build_prefill_step(model, mesh,
                                                 ShapeConfig("p", positions, b, "prefill"))
    decode, _, dec_specs = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
    params = shard_params(param_tree(model), plan, mesh)
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "patch_embeds": torch.from_numpy(inp["patches"])}
    local = {k: shd.local_block(v, in_specs[k], mesh) for k, v in batch.items()}
    want = serve_collectives(model, mesh, b, s, t)
    rows = P(in_specs["tokens"][0], None)

    def flat(tree, prefix):
        return {prefix + keystr(p): x.float().numpy() for p, x in tree_flatten_with_path(tree)}

    def joined(logits, cache, length, prefix):
        specs = shd.cache_pspecs(cfg, model.cache_specs(b, length), mesh)
        blocks = {k: v for k, v in cache.items() if k != "index"}
        full = shd.join_tree({"logits": logits, "cache": blocks},
                             {"logits": rows, "cache": {k: specs[k] for k in blocks}}, mesh)
        return flat(full, prefix)

    out, rec = {}, {}
    logits, cache = prefill(params, local)
    out.update(joined(logits, cache, positions, "prefill|"))
    rec["prefill_index"] = np.asarray(cache["index"])
    mesh.reset_counts()
    logits, cache = prefill(params, dict(local, max_len=t))
    rec["prefill_counts"] = repr(sorted(mesh.counts.items()))
    out.update(joined(logits, cache, t, "prefill_t|"))
    whole = dict(tree_flatten_with_path(model.cache_specs(b, t)))
    specs = dict(tree_flatten_with_path(shd.cache_pspecs(cfg, model.cache_specs(b, t), mesh),
                                        shd.is_spec))
    rec["blocks"] = repr({keystr(p): (tuple(x.shape), shd.block_shape(
        specs[p], tuple(whole[p].shape), mesh)) for p, x in tree_flatten_with_path(
            {k: v for k, v in cache.items() if k != "index"})})
    for i, tok in enumerate(inp["feed"]):
        mesh.reset_counts()
        logits, cache = decode(params, cache,
                               shd.local_block(torch.from_numpy(tok), dec_specs["token"], mesh))
        if i == 0:
            rec["decode_counts"] = repr(sorted(mesh.counts.items()))
        out.update({f"decode{i}|{k.split('|', 1)[1]}": v
                    for k, v in joined(logits, {}, t, "x|").items()})
    out.update({k: v for k, v in joined(logits, cache, t, "final|").items() if "|cache|" in k})
    rec["want_prefill"] = repr(sorted(want["prefill"].items()))
    rec["want_decode"] = repr(sorted(want["decode"].items()))
    rec["index"] = np.asarray(cache["index"])
    np.savez(f"{data_dir}/{name}_rank{rank}.npz", **rec)
    if rank == 0:
        np.savez(f"{data_dir}/{name}_port.npz", **out)


def _rank_main(rank: int, world: int, data_dir: str, names: list):
    """One gloo rank of ``world``: each train run of ``names``, then each
    serve run."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)      # the ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous{world}",
                                rank=rank, world_size=world)
        seen = {}
        _record(seen)
        for name in names:
            if name in RUNS:
                _train(rank, data_dir, name, seen)
            else:
                _serve(rank, data_dir, name)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's results of every run in RUNS and SERVE."""
    data_dir = tmp_path_factory.mktemp("vlm_mesh")
    rng = np.random.default_rng(0)
    for name, (_, _, text, changes) in RUNS.items():
        cfg = _j_cfg(changes)
        state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
        np.savez(data_dir / f"{name}_in.npz", state=np.asarray(state, dtype=object),
                 batches=rng.integers(0, cfg.vocab_size, (2, BATCH, text + 1)).astype(np.int32),
                 patches=rng.normal(size=(2, BATCH, cfg.num_patch_tokens, cfg.d_model))
                 .astype(np.float32))
    cfg = _j_cfg()
    params = jax.tree.map(np.asarray, j_build_model(cfg).init(jax.random.key(0)))
    for name, (_, b, s, _) in SERVE.items():
        np.savez(data_dir / f"{name}_in.npz", params=np.asarray(params, dtype=object),
                 tokens=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 patches=rng.normal(size=(b, cfg.num_patch_tokens, cfg.d_model))
                 .astype(np.float32),
                 feed=rng.integers(0, cfg.vocab_size, (STEPS, b)).astype(np.int32))
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    # the reference's compiles are the fixture's longest path: three processes
    train_groups = [{k: v for k, v in RUNS.items() if (v[1] == (2, 2)) == first}
                    for first in (True, False)]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(TRAIN_SCRIPT), repr(g), str(data_dir),
         repr(BATCH), repr(HP)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for g in train_groups]
    refs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(SERVE_SCRIPT), repr(SERVE), str(data_dir)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    by_world = {}
    for name, (_, (data, mdl), _, _) in RUNS.items():
        by_world.setdefault(data * mdl, []).append(name)
    for name, ((data, mdl), _, _, _) in SERVE.items():
        by_world.setdefault(data * mdl, []).append(name)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(data_dir), names))
             for world, names in by_world.items() for r in range(world)]
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
        assert r.returncode == 0, f"reference failed:\n{out}\n{err[-4000:]}"
    assert not hung and codes == [0] * len(procs), f"port ranks exit codes {codes}, hung={hung}"
    out = {}
    for name, mesh in [(k, v[1]) for k, v in RUNS.items()] + [(k, v[0]) for k, v in SERVE.items()]:
        ranks = [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(mesh[0] * mesh[1])]
        out[name] = (dict(np.load(data_dir / f"{name}_jax.npz")),
                     dict(np.load(data_dir / f"{name}_port.npz")), ranks)
    return out


# ------------------------------ train step -------------------------------- #
@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax(runs, name):
    ref, port, _ = runs[name]
    for i in range(2):
        np.testing.assert_allclose(port[f"loss{i}"], ref[f"loss{i}"], **TOL)


@pytest.mark.parametrize("part", ["params", "opt|master", "opt|m", "opt|v"])
@pytest.mark.parametrize("name", list(RUNS))
def test_state_matches_jax(runs, name, part):
    ref, port, _ = runs[name]
    _assert_leaves_close(port, ref, _keys(port, ref, f"state|{part}|"))


@pytest.mark.parametrize("name", list(RUNS))
def test_replicated_leaves_match_jax(runs, name):
    """The leaves replicated over "model" beside split ones: the norms
    (a part of the sum a rank where the sequence is split, whole after f's
    all-reduce where not) and wk, wv where the 2 kv heads do not divide
    "model": params, m and v."""
    ref, port, _ = runs[name]
    _, (_, mdl), _, changes = RUNS[name]
    wanted = REPLICATED + (KV_REPLICATED if _t_cfg(changes).num_kv_heads % mdl else ())
    keys = [k for part in ("params", "opt|m", "opt|v")
            for k in _keys(port, ref, f"state|{part}|") if k.endswith(wanted)]
    assert len(keys) == 3 * len(wanted), keys
    _assert_leaves_close(port, ref, keys)


@pytest.mark.parametrize("name", WITH_BACKUP)
def test_backup_matches_jax(runs, name):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_spec, sharded_dim
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import keystr, tree_flatten_with_path

    kw, shape, _, changes = RUNS[name]
    model = build_model(_t_cfg(changes), device="meta")
    plan = make_state_plan(model, Mesh(("data", "model"), shape),
                           fsdp_params=kw.get("fsdp_params", True))
    dims = {keystr(p): sharded_dim(spec)
            for p, spec in tree_flatten_with_path(plan.opt_pspecs["master"], is_spec)}

    def roll(leaf, x):
        dim = dims[leaf]
        return x if dim is None else np.roll(x, x.shape[dim] // shape[0], axis=dim)

    ref, port, _ = runs[name]
    _assert_leaves_close(port, ref, _keys(port, ref, "backup|"), roll)


@pytest.mark.parametrize("name", list(RUNS))
def test_the_layout_follows_the_positions(runs, name):
    """The residual stream entering a layer body is the rank's block of
    the num_patch_tokens + S positions, (b, (P + S)/model, D), where "model"
    divides them, else (b, P + S, D): at (1, 4) with 6 patches, S = 12
    tokens divide 4 ways but the 18 positions do not. The flash call reads
    every position at the rank's q heads and their kv heads (6 q heads of
    one kv head on a model-2 rank of the 12/2 run)."""
    kw, (data, mdl), _, changes = RUNS[name]
    cfg = _t_cfg(changes)
    n = _positions(name)
    b, hd = BATCH // data // kw.get("microbatches", 1), cfg.resolved_head_dim
    heads = cfg.num_heads // mdl
    kv = (cfg.num_kv_heads // mdl if cfg.num_kv_heads % mdl == 0
          else max(1, heads // (cfg.num_heads // cfg.num_kv_heads)))
    for rank, rec in enumerate(runs[name][2]):
        seen = eval(str(rec["shapes"]))
        assert seen["residual"] == (b, n // mdl if n % mdl == 0 else n, cfg.d_model), (rank, seen)
        assert seen["flash.q"] == (b, n, heads, hd), (rank, seen)
        assert seen["flash.k"] == (b, n, kv, hd), (rank, seen)


@pytest.mark.parametrize("name", list(RUNS))
def test_the_loss_scores_the_text_of_the_gathered_sequence(runs, name):
    """The cross-entropy reads the S text positions of the whole sequence,
    gathered from the ranks' blocks before the patches are cut off: a cut
    of a rank's block instead (rank 0's block all patches at S = 8 on
    model 2) would hand it another length. Its head is the rank's vocab
    block."""
    kw, (data, mdl), text, changes = RUNS[name]
    cfg = _t_cfg(changes)
    b = BATCH // data // kw.get("microbatches", 1)
    for rank, rec in enumerate(runs[name][2]):
        seen = eval(str(rec["shapes"]))
        assert seen["xent.x"] == (b, text, cfg.d_model), (rank, seen)
        assert seen["head.w"] == (cfg.padded_vocab // mdl, cfg.d_model), (rank, seen)


@pytest.mark.parametrize("name", list(RUNS))
def test_model_collectives_equal_the_formula(runs, name):
    """The collectives over "model" of one step, counted by the mesh on
    every rank, equal ``model_collectives`` at P + S positions in calls
    and bytes: gathers and reduce-scatters where "model" divides them, the
    Megatron layout's all-reduces alone where not."""
    _, (_, mdl), _, _ = RUNS[name]
    sp = _positions(name) % mdl == 0
    for rank, rec in enumerate(runs[name][2]):
        counts = eval(str(rec["counts"]))
        assert counts == eval(str(rec["formula"])), rank
        assert {op for op, _ in counts} == ({"all_gather", "reduce_scatter", "all_reduce"} if sp
                                            else {"all_reduce"}), (rank, counts)


# ------------------------------ serve steps ------------------------------- #
def _compare(runs, name, prefix):
    ref, port, _ = runs[name]
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix)), (keys, sorted(port))
    for k in keys:
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_step_matches_jax(runs, name):
    """The prefill step at its default max_len, the patches and the tokens:
    logits and the joined cache blocks; its index counts the patches."""
    _compare(runs, name, "prefill|")
    _, _, s, _ = SERVE[name]
    for rec in runs[name][2]:
        assert int(rec["prefill_index"]) == _t_cfg().num_patch_tokens + s


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_to_a_longer_cache_matches_jax(runs, name):
    """The port's prefill step at max_len = T against the reference's
    unsharded prefill at T: logits and the cache, zero past the prompt."""
    _compare(runs, name, "prefill_t|")


@pytest.mark.parametrize("name", list(SERVE))
def test_decode_steps_match_jax(runs, name):
    """8 decode steps' logits, each step fed the same token on both sides."""
    for i in range(STEPS):
        _compare(runs, name, f"decode{i}|")


@pytest.mark.parametrize("name", list(SERVE))
def test_final_cache_matches_jax(runs, name):
    """The cache after the 8 steps, joined from the ranks' blocks (the
    patch positions among them); its index a host int on every rank."""
    _compare(runs, name, "final|")
    _, _, s, _ = SERVE[name]
    for rec in runs[name][2]:
        assert int(rec["index"]) == _t_cfg().num_patch_tokens + s + STEPS


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_blocks_are_the_cache_pspecs_blocks(runs, name):
    """Every rank's cache leaves have the shapes of its blocks under
    ``cache_pspecs``: a block of the T positions over "model"."""
    for rank, rec in enumerate(runs[name][2]):
        blocks = eval(str(rec["blocks"]))
        assert blocks and all(have == want for have, want in blocks.values()), (rank, blocks)
        (data, mdl), b, _, t = SERVE[name]
        assert blocks["k"][0] == (2, b // data, t // mdl, 2, 16), (rank, blocks)


@pytest.mark.parametrize("name", list(SERVE))
def test_collectives_equal_serve_collectives(runs, name):
    """The collectives the mesh counted in a prefill (at T) and in a decode
    step, by kind, axes, calls and bytes, equal ``serve_collectives`` on
    every rank."""
    for rank, rec in enumerate(runs[name][2]):
        assert str(rec["prefill_counts"]) == str(rec["want_prefill"]), rank
        assert str(rec["decode_counts"]) == str(rec["want_decode"]), rank


# ------------------------- no processes needed ---------------------------- #
def test_the_formula_at_internvl2_full_width():
    """``model_collectives`` for internvl2-26b at full width on (2, 2),
    FSDP, one microbatch of 4 rows of 1,024 patches + 1,024 tokens: 2,048
    positions, the sequence split, A = 4 x 2048 x 6144 x 2, a = A/2: the
    embedding's reduce-scatter of the whole sequence and its backward
    gather, each layer's 6 gathers and 5 scatters, the head's gather and
    its backward scatter, the cross-entropy's two statistics over the 1,024
    text positions, one all-reduce of the norms (a "data" half); at 1,024 +
    1,023 the Megatron layout, the embedding's and the head's all-reduces
    over the 1,023 tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import model_collectives
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=2)
    model = build_model(cfg, device="meta")
    mesh = Mesh(("data", "model"), (2, 2))
    d, layers = 6144, 2
    act = 4 * 2048 * d * 2
    norms = (2 * layers * d + d) * 2 // 2
    assert model_collectives(model, mesh, 4, 2048) == {
        ("all_gather", ("model",)): [1 + layers * 6 + 1, (1 + layers * 6 + 1) * act // 2],
        ("reduce_scatter", ("model",)): [1 + layers * 5 + 1, (1 + layers * 5 + 1) * act],
        ("all_reduce", ("model",)): [2 + 1, 4 * 1024 * 12 + norms]}
    act, text = 4 * 2047 * d * 2, 4 * 1023 * d * 2
    assert model_collectives(model, mesh, 4, 2047) == {("all_reduce", ("model",)): [
        1 + layers * 5 + 3, text + act * layers * 5 + 4 * 1023 * 12 + text]}


def test_serve_collectives_at_internvl2_full_width():
    """internvl2-26b at full width on (data 2, model 2), 8 prompts of 1,000
    tokens behind 1,024 patches, a cache of 2,056: per rank 4 rows; prefill
    the embedding's all-reduce over the 1,000 tokens, two all-reduces a
    layer over the 2,024 positions, the kv heads' gather (8 kv heads, 4 a
    rank) and the logits' gather; decode the same of one position, the q
    heads' gather and the merge of (o, lse) over "model"."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.serve import serve_collectives
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=12)
    model = build_model(cfg, device="meta")
    got = serve_collectives(model, Mesh(("data", "model"), (2, 2)), 8, 1000, 2056)
    m, L, d = ("model",), 12, 6144
    logits = 4 * 4 * 92672 // 2
    assert got["prefill"] == {
        ("all_reduce", m): [1 + 2 * L, 4 * 1000 * d * 2 + 2 * L * 4 * 2024 * d * 2],
        ("all_gather", m): [L + 1, L * 2 * 4 * 2024 * 4 * 128 * 2 + logits]}
    assert got["decode"] == {
        ("all_reduce", m): [1 + 2 * L, (1 + 2 * L) * 4 * d * 2],
        ("all_gather", m): [3 * L + 1, L * (2 * 4 * 4 * 128 * 2 + 4 * 24 * 128 * 2
                                            + 4 * 4 * 48 * 129) + logits]}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_mesh_steps_take_the_vlm(kind):
    """The mesh steps build for internvl2-26b (they refused it before the
    patches went through them) and their input specs hold the patch rows,
    split over "data" like the tokens."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_prefill_step
    from repro_torch.train.step import build_train_step
    model = build_model(_t_cfg(), device="meta")
    mesh = Mesh(("data", "model"), (2, 2))
    shape = ShapeConfig("s", 24, 8, kind)
    specs = (build_prefill_step(model, mesh, shape)[2] if kind == "prefill"
             else build_train_step(model, mesh, shape=shape).input_pspecs)
    assert tuple(specs["patch_embeds"]) == ("data", None, None)
    assert specs["patch_embeds"][0] == specs["tokens"][0]


@pytest.mark.parametrize("arch,stacked", [
    ("qwen3-0.6b", True), ("qwen2-moe-a2.7b", True), (ARCH, True),
    ("mamba2-2.7b", False), ("zamba2-7b", False), ("whisper-small", False)])
def test_both_formulas_count_decoder_stacks_alike(arch, stacked):
    """``model_collectives`` and ``serve_collectives`` take the same
    decision of which families count as a stack of attention + FFN blocks:
    the families that build a ``DecoderLM``, the VLM among them."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.transformer import DecoderLM, is_decoder_stack
    cfg = get_arch(arch)
    assert is_decoder_stack(cfg) is stacked
    assert isinstance(build_model(cfg, device="meta"), DecoderLM) is stacked
