"""The port's enc-dec on a mesh against the JAX package's, on the CPU: gloo
ranks of ``repro_torch.train.step.build_train_step`` and of
``repro_torch.train.serve``'s mesh builders against ``repro.train.step`` /
``repro.train.serve`` on the same host meshes of forced host devices, from
the same weights (the reference's ``init_state`` / ``init``, moved through
``bridge.params_from_numpy``), the same tokens and the same frame
embeddings (``rng.normal``), at the smoke size of whisper-small (2 encoder
and 2 decoder layers, 4 heads of 16, 16 frames, vocabulary 256), fp32, at
2e-4.

Train step, two steps a run; losses, the new state (params, master, m, v)
and the backup compared, and every encoder leaf's first gradient (the m of
step 1: a rank whose gradient of the encoder's output missed the other
ranks' parts would move all of them):

- (data 2, model 2) FSDP;
- (2, 2) FSDP with 2 microbatches (each rank's block of the frame rows);
- (1, 2) without FSDP;
- (1, 4).

Within the port, every rank's collectives over "model" of a step equal
``train.step.model_collectives`` (all-reduces only: the residual streams
stay whole, as the reference's ``_build_encdec`` keeps them), and the
streams entering the encoder and the decoder bodies are whole.

Serve steps: prefill and 8 decode steps, as tests/test_torch_serve_mesh.py
holds the other families: the prefill step at max_len = the prompt against
JAX's step, at a longer cache T against JAX's unsharded ``prefill``, then the
decode steps against JAX's decode step; both caches joined from the ranks'
blocks; the collectives of a prefill and of a decode step equal
``serve_collectives``. On (2, 2) and (1, 4); a batch of 1 on (2, 2), whose
caches split over ("data", "model"); ``encoder_seq`` 18 on (1, 4), where
the cross cache stays whole while the self cache splits.

The reference runs in two subprocesses and the port's ranks in two sets of
spawned processes (4 ranks, and 2 for the (1, 2) run; ``file://``
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
from test_torch_tp_step import HP, TOL, _assert_leaves_close, _flat, _join, _keys

ROOT = Path(__file__).resolve().parent.parent
ARCH = "whisper-small"
DEADLINE_S = 420                          # a hang guard: ~60 s alone, more beside other workers
BATCH = 8                                 # global batch
SEQ = 8                                   # decoder positions of a train row
STEPS = 8                                 # decode steps
# name -> (build_train_step keywords, mesh (data, model))
RUNS = {
    "fsdp": (dict(fsdp_params=True), (2, 2)),
    "mb2": (dict(fsdp_params=True, microbatches=2), (2, 2)),
    "tp_only": (dict(fsdp_params=False), (1, 2)),
    "model4": (dict(fsdp_params=False), (1, 4)),
}
WITH_BACKUP = [k for k, v in RUNS.items() if v[1][0] > 1]
# name -> (mesh (data, model), global batch, prompt tokens S, cache length T,
#          config changes in both packages)
SERVE = {
    "serve_2x2": ((2, 2), BATCH, 6, 16, {}),
    "serve_1x4": ((1, 4), BATCH, 6, 16, {}),
    "serve_b1": ((2, 2), 1, 6, 16, {}),
    "serve_senc18": ((1, 4), BATCH, 6, 16, dict(encoder_seq=18)),
}

TRAIN_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.step import build_train_step

runs, data_dir, batch, seq, hp = (eval(sys.argv[1]), sys.argv[2], eval(sys.argv[3]),
                                  eval(sys.argv[4]), eval(sys.argv[5]))

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

cfg = dataclasses.replace(reduce_for_smoke(get_arch("whisper-small")), dtype="float32")
model = build_model(cfg)
for name, (kw, (data, mdl)) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    state = inp["state"].item()
    out = {}
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    art = build_train_step(model, mesh, AdamWConfig(**hp), donate=False,
                           shape=ShapeConfig("t", seq, batch, "train"), **kw)
    with mesh:
        for i, (tokens, frames) in enumerate(zip(inp["batches"], inp["frames"])):
            state, metrics, backup = art.step_fn(state, {"tokens": jnp.asarray(tokens),
                                                         "frames": jnp.asarray(frames)})
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

for name, ((data, mdl), b, s, t, changes) in runs.items():
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("whisper-small")), dtype="float32",
                              **changes)
    model = build_model(cfg)
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    params, feed = inp["params"].item(), inp["feed"]
    batch = {"tokens": jnp.asarray(inp["tokens"]), "frames": jnp.asarray(inp["frames"])}
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    out = {}
    prefill, _, _ = build_prefill_step(model, mesh, ShapeConfig("p", s, b, "prefill"))
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


# ------------------------------- the ranks -------------------------------- #
def _record(seen: dict) -> None:
    """Wrap the calls whose inputs show the layout, so that the first step
    of a run records their shapes: the stream entering an encoder body and
    a decoder body and the encoder's output beside it (``run_layer``'s
    arguments), and every (q, k) shape the flash calls read."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    def wrap(owner, attr, record):
        fn = getattr(owner, attr)

        def wrapped(*args, **kw):
            record(args)
            return fn(*args, **kw)
        setattr(owner, attr, wrapped)

    def layer(a):
        if len(a) == 3:                       # (body, params, x): an encoder layer
            seen.setdefault("encoder", tuple(a[2].shape))
        else:                                 # (body, params, x, enc_out): a decoder layer
            seen.setdefault("decoder", tuple(a[2].shape))
            seen.setdefault("enc_out", tuple(a[3].shape))

    wrap(transformer, "run_layer", layer)
    wrap(ops, "flash_attention",
         lambda a: seen.setdefault("flash", set()).add((tuple(a[0].shape), tuple(a[1].shape))))


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

    kw, (data, mdl) = RUNS[name]
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    model = params_from_numpy(inp["state"].item()["params"], _t_cfg(), device="cpu")
    mesh = make_host_mesh(data=data, model=mdl)
    art = build_train_step(model, mesh, AdamWConfig(**HP),
                           shape=ShapeConfig("t", SEQ, BATCH, "train"), **kw)
    state = shard_init_state(param_tree(model), art.plan, mesh)
    out, rec = {}, {}
    for i, (tokens, frames) in enumerate(zip(inp["batches"], inp["frames"])):
        batch = {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames)}
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
            rec["formula"] = repr(model_collectives(model, mesh, local["tokens"].shape[0], SEQ,
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
    ranks serve the other families, the frame rows given beside the
    tokens."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import P
    from repro_torch.train.serve import build_decode_step, build_prefill_step, serve_collectives
    from repro_torch.train.state import param_tree, shard_params
    from repro_torch.tree import keystr, tree_flatten_with_path

    (data, mdl), b, s, t, changes = SERVE[name]
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    cfg = _t_cfg(changes)
    model = params_from_numpy(inp["params"].item(), cfg, device="cpu")
    mesh = make_host_mesh(data=data, model=mdl)
    prefill, plan, in_specs = build_prefill_step(model, mesh, ShapeConfig("p", s, b, "prefill"))
    decode, _, dec_specs = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
    params = shard_params(param_tree(model), plan, mesh)
    batch = {"tokens": torch.from_numpy(inp["tokens"]), "frames": torch.from_numpy(inp["frames"])}
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
    out.update(joined(logits, cache, s, "prefill|"))
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
    data_dir = tmp_path_factory.mktemp("encdec_mesh")
    rng = np.random.default_rng(0)
    cfg = _j_cfg()
    state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
    for name in RUNS:
        np.savez(data_dir / f"{name}_in.npz", state=np.asarray(state, dtype=object),
                 batches=rng.integers(0, cfg.vocab_size, (2, BATCH, SEQ + 1)).astype(np.int32),
                 frames=rng.normal(size=(2, BATCH, cfg.encoder_seq, cfg.d_model))
                 .astype(np.float32))
    for name, (_, b, s, _, changes) in SERVE.items():
        cfg = _j_cfg(changes)
        params = jax.tree.map(np.asarray, j_build_model(cfg).init(jax.random.key(0)))
        np.savez(data_dir / f"{name}_in.npz", params=np.asarray(params, dtype=object),
                 tokens=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 frames=rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
                 feed=rng.integers(0, cfg.vocab_size, (STEPS, b)).astype(np.int32))
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(TRAIN_SCRIPT), repr(RUNS), str(data_dir),
         repr(BATCH), repr(SEQ), repr(HP)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(SERVE_SCRIPT), repr(SERVE), str(data_dir)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    by_world = {}
    for name, (_, (data, mdl)) in RUNS.items():
        by_world.setdefault(data * mdl, []).append(name)
    for name, ((data, mdl), _, _, _, _) in SERVE.items():
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
def test_encoder_gradients_match_jax(runs, name):
    """Every encoder leaf's first gradient, as step 1's m holds it ((1 - b1)
    times the gradient): the leaves that only the cross-attention's k and
    v reach through the encoder's output, whose gradient each rank holds a
    part of until the f before the decoder all-reduces it."""
    ref, port, _ = runs[name]
    keys = _keys(port, ref, "state0|opt|m|encoder|") + _keys(port, ref, "state0|opt|m|enc_norm")
    assert len(keys) == 9, keys           # ln1, ln2, wq, wk, wv, wo, w_up, w_down; enc_norm
    _assert_leaves_close(port, ref, keys)


@pytest.mark.parametrize("name", WITH_BACKUP)
def test_backup_matches_jax(runs, name):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_spec, sharded_dim
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import keystr, tree_flatten_with_path

    kw, shape = RUNS[name]
    model = build_model(_t_cfg(), device="meta")
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
def test_the_streams_stay_whole(runs, name):
    """The stream entering an encoder body is (b, Senc, D) and a decoder
    body's (b, S, D), whole over "model" though it divides both (the
    reference's bodies constrain neither); the encoder's output enters the
    decoder whole. The flash calls read the rank's heads: the encoder's
    non-causal (Senc against Senc), the decoder's causal (S against S) and
    the cross-attention's (S against Senc)."""
    kw, (data, mdl) = RUNS[name]
    cfg = _t_cfg()
    b, senc, d = BATCH // data // kw.get("microbatches", 1), cfg.encoder_seq, cfg.d_model
    heads, hd = cfg.num_heads // mdl, cfg.resolved_head_dim
    for rank, rec in enumerate(runs[name][2]):
        seen = eval(str(rec["shapes"]))
        assert seen["encoder"] == seen["enc_out"] == (b, senc, d), (rank, seen)
        assert seen["decoder"] == (b, SEQ, d), (rank, seen)
        enc, dec = (b, senc, heads, hd), (b, SEQ, heads, hd)
        assert seen["flash"] == {(enc, enc), (dec, dec), (dec, enc)}, (rank, seen)


@pytest.mark.parametrize("name", list(RUNS))
def test_model_collectives_equal_the_formula(runs, name):
    """The collectives over "model" of one step, counted by the mesh on
    every rank, equal ``model_collectives`` in calls and bytes: the
    Megatron layout's all-reduces alone."""
    for rank, rec in enumerate(runs[name][2]):
        counts = eval(str(rec["counts"]))
        assert counts == eval(str(rec["formula"])), rank
        assert {op for op, _ in counts} == {"all_reduce"}, (rank, counts)


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
    """The prefill step at its default max_len: logits and the joined
    blocks of the self and cross caches."""
    _compare(runs, name, "prefill|")
    _, _, s, _, _ = SERVE[name]
    for rec in runs[name][2]:
        assert int(rec["prefill_index"]) == s


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_to_a_longer_cache_matches_jax(runs, name):
    """The port's prefill step at max_len = T against the reference's
    unsharded prefill at T: logits and both caches, the self cache zero
    past the prompt."""
    _compare(runs, name, "prefill_t|")


@pytest.mark.parametrize("name", list(SERVE))
def test_decode_steps_match_jax(runs, name):
    """8 decode steps' logits, each step fed the same token on both sides."""
    for i in range(STEPS):
        _compare(runs, name, f"decode{i}|")


@pytest.mark.parametrize("name", list(SERVE))
def test_final_cache_matches_jax(runs, name):
    """Both caches after the 8 steps, joined from the ranks' blocks; the
    index a host int on every rank."""
    _compare(runs, name, "final|")
    _, _, s, _, _ = SERVE[name]
    for rec in runs[name][2]:
        assert int(rec["index"]) == s + STEPS


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_blocks_are_the_cache_pspecs_blocks(runs, name):
    """Every rank's cache leaves have the shapes of its blocks under
    ``cache_pspecs``: the self cache a block of T positions, the cross
    cache a block of the encoder's, each by its own split (the cross cache
    whole where "model" does not divide 18 frames; both over ("data",
    "model") for a batch of 1)."""
    (data, mdl), b, _, t, changes = SERVE[name]
    senc = _t_cfg(changes).encoder_seq
    rows = b // data if b % data == 0 else b
    ranks = mdl if b % data == 0 else data * mdl
    for rank, rec in enumerate(runs[name][2]):
        blocks = eval(str(rec["blocks"]))
        assert blocks and all(have == want for have, want in blocks.values()), (rank, blocks)
        assert blocks["k"][0] == (2, rows, t // ranks, 4, 16), (rank, blocks)
        cross = senc // ranks if senc % ranks == 0 else senc
        assert blocks["cross_k"][0] == (2, rows, cross, 4, 16), (rank, blocks)


@pytest.mark.parametrize("name", list(SERVE))
def test_collectives_equal_serve_collectives(runs, name):
    """The collectives the mesh counted in a prefill (at T) and in a decode
    step, by kind, axes, calls and bytes, equal ``serve_collectives`` on
    every rank."""
    for rank, rec in enumerate(runs[name][2]):
        assert str(rec["prefill_counts"]) == str(rec["want_prefill"]), rank
        assert str(rec["decode_counts"]) == str(rec["want_decode"]), rank


# ------------------------- no processes needed ---------------------------- #
def test_the_formula_at_whisper_small_full_width():
    """``model_collectives`` for whisper-small at full width and depth on
    (2, 2), 4 rows of 448 tokens against 1,500 frames, bf16: the Megatron
    layout's all-reduces alone, though "model" divides both. A = 4 x 448 x
    768 x 2, Aenc = 4 x 1500 x 768 x 2. FSDP: the embedding's AR A; each of
    the 12 encoder bodies 2 regions forward, 2 backward, 1 in the recompute
    (its last g not re-run), of Aenc; the f on the encoder's output, one AR
    Aenc; each of the 12 decoder bodies 3 + 3 + 2 of A; the head's two
    statistics and its AR A. Without FSDP no recompute."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import model_collectives
    model = build_model(get_arch(ARCH), device="meta")
    mesh = Mesh(("data", "model"), (2, 2))
    act, enc, stat = 4 * 448 * 768 * 2, 4 * 1500 * 768 * 2, 4 * 448 * 4
    head = stat + 2 * stat + act
    assert model_collectives(model, mesh, 4, 448) == {("all_reduce", ("model",)): [
        1 + 12 * 5 + 1 + 12 * 8 + 3, act + 60 * enc + enc + 96 * act + head]}
    assert model_collectives(model, mesh, 4, 448, fsdp_params=False) == {
        ("all_reduce", ("model",)): [1 + 12 * 4 + 1 + 12 * 6 + 3,
                                     act + 48 * enc + enc + 72 * act + head]}
    assert model_collectives(model, mesh, 4, 448)[("all_reduce", ("model",))] == \
        [161, 831_943_680]


def test_serve_collectives_at_whisper_small_full_width():
    """whisper-small at full width and depth on (data 2, model 2), 8 clips
    of 1,500 frames and 16-token prompts, a cache of 48: per rank 4 rows,
    both caches split over "model". Prefill: the embedding's all-reduce,
    the encoder's 24 regions of 1,500 positions, the decoder's 36 of 16,
    each decoder layer's self and cross kv heads gathered (6 a rank), the
    logits' gather; a decode step: the embedding, 36 regions, and in each
    layer the self kv gather, the q gathers of both attentions and both
    (o, lse) gathers, then the logits."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.serve import serve_collectives
    model = build_model(get_arch(ARCH), device="meta")
    got = serve_collectives(model, Mesh(("data", "model"), (2, 2)), 8, 16, 48)
    m, L, d = ("model",), 12, 768
    logits = 4 * 4 * 51968 // 2
    assert got["prefill"] == {
        ("all_reduce", m): [1 + 2 * L + 3 * L, 4 * 16 * d * 2 + 2 * L * 4 * 1500 * d * 2
                            + 3 * L * 4 * 16 * d * 2],
        ("all_gather", m): [2 * L + 1, L * 2 * 4 * 16 * 6 * 64 * 2
                            + L * 2 * 4 * 1500 * 6 * 64 * 2 + logits]}
    assert got["decode"] == {
        ("all_reduce", m): [1 + 3 * L, (1 + 3 * L) * 4 * d * 2],
        ("all_gather", m): [5 * L + 1, L * (2 * 4 * 6 * 64 * 2 + 2 * 4 * 6 * 64 * 2
                                            + 2 * 4 * 4 * 12 * 65) + logits]}
    assert (got["prefill"][("all_reduce", m)][0], got["decode"][("all_reduce", m)][0],
            got["decode"][("all_gather", m)][0]) == (61, 37, 61)
