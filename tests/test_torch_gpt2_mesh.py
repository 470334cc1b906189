"""The paper's GPT-2 2.7B on a mesh in the port against the JAX package, on
the CPU: gloo ranks of ``repro_torch.train.step.build_train_step`` and of
``repro_torch.train.serve``'s mesh builders against ``repro.train.step`` /
``repro.train.serve`` on the same (data 2, model 2) host mesh of forced host
devices, from the same weights (the reference's ``init_state`` / ``init``,
moved through ``bridge.params_from_numpy``) and the same tokens, fp32, at
2e-4.

gpt2-2.7b at smoke width with its head_dim kept (4 heads of 80, MHA, so 2
a rank; d_model 320, the gelu MLP, the untied head, 2 layers) and a
vocabulary of 200, padded to 256: "model" splits the embedding and the head
by rows, so rank 1's half (rows 128-255) holds the 56 pad rows, which the
vocab-parallel lookup and cross-entropy must pass over as the reference's
do. Neither package masks the pad columns' logits: a greedy token may be a
pad id, and it must be the reference's.

Train step, (2, 2) with FSDP and the instant backup, two steps over 8 x 8
tokens (the sequence split over "model"): the losses, the new state
(params, master, m, v) and the backup; every rank's collectives over
"model" equal ``train.step.model_collectives``, the stream entering a layer
body is a rank's block of positions, and the flash calls read a rank's 2
heads.

Serve steps on (2, 2), 8 prompts of 6 tokens and a cache of 16 (a rank's 4
rows and 8 positions: rank 1's block empty until the third decode step):
the prefill step at max_len = the prompt against JAX's step, at max_len 16
against JAX's unsharded ``prefill``, then 8 decode steps against JAX's
decode step; the logits, their greedy tokens and the caches joined from the
ranks' blocks; the collectives of a prefill and of a decode step equal
``serve_collectives`` on every rank.

The reference runs in one subprocess and the port's ranks in one set of
four spawned processes (``file://`` rendezvous under the test's temporary
directory), at once, each joined with a deadline."""
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
ARCH = "gpt2-2.7b"
DEADLINE_S = 420                          # a hang guard: ~40 s alone, more beside other workers
WORLD, MESH = 4, (2, 2)                   # (data, model)
BATCH, SEQ = 8, 8                         # a train step's global batch and sequence
PROMPT, MAX_LEN, STEPS = 6, 16, 8         # the serve's prompt, cache and decode steps
# gpt2-2.7b's smoke config in both packages: head_dim 80 kept, and a
# vocabulary that 256 does not divide
CHANGES = dict(d_model=320, num_heads=4, num_kv_heads=4, head_dim=80, vocab_size=200,
               dtype="float32")

SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.serve import build_decode_step, build_prefill_step
from repro.train.step import build_train_step

data_dir, changes, (data, mdl), (batch, seq), (prompt, max_len), hp = (
    sys.argv[1], *map(eval, sys.argv[2:]))

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}

cfg = dataclasses.replace(reduce_for_smoke(get_arch("gpt2-2.7b")), **changes)
model = build_model(cfg)
mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])

inp = np.load(f"{data_dir}/train_in.npz", allow_pickle=True)
state, out = inp["state"].item(), {}
art = build_train_step(model, mesh, AdamWConfig(**hp), donate=False, fsdp_params=True,
                       shape=ShapeConfig("t", seq, batch, "train"))
with mesh:
    for i, tokens in enumerate(inp["batches"]):
        state, metrics, backup = art.step_fn(state, {"tokens": jnp.asarray(tokens)})
        out[f"loss{i}"] = np.asarray(metrics["loss"], np.float32)
        if i == 0:
            out.update(flat(state["opt"]["m"], "state0|opt|m|"))
out.update(flat(state, "state|"))
out.update(flat(backup, "backup|"))
np.savez(f"{data_dir}/train_jax.npz", **out)

inp = np.load(f"{data_dir}/serve_in.npz", allow_pickle=True)
params, tokens, feed, out = inp["params"].item(), inp["tokens"], inp["feed"], {}
prefill, _, _ = build_prefill_step(model, mesh, ShapeConfig("p", prompt, batch, "prefill"))
with mesh:
    logits, cache = prefill(params, {"tokens": tokens})
out["prefill|logits"] = np.asarray(logits, np.float32)
out.update(flat({k: v for k, v in cache.items() if k != "index"}, "prefill|cache|"))
logits, cache = model.prefill(params, {"tokens": jnp.asarray(tokens), "max_len": max_len})
out["prefill_t|logits"] = np.asarray(logits, np.float32)
out.update(flat({k: v for k, v in cache.items() if k != "index"}, "prefill_t|cache|"))
decode, _, _ = build_decode_step(model, mesh, ShapeConfig("d", max_len, batch, "decode"))
cache = jax.tree.map(np.asarray, cache)
with mesh:
    for i in range(len(feed)):
        logits, cache = decode(params, cache, feed[i])
        out[f"decode{i}|logits"] = np.asarray(logits, np.float32)
out.update(flat({k: v for k, v in cache.items() if k != "index"}, "final|cache|"))
np.savez(f"{data_dir}/serve_jax.npz", **out)
"""


def _j_cfg():
    return dataclasses.replace(j_reduce(j_get_arch(ARCH)), **CHANGES)


def _t_cfg():
    from repro_torch.configs import get_arch, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), **CHANGES)


# ------------------------------- the ranks -------------------------------- #
def _record(seen: dict) -> None:
    """Wrap the calls whose inputs show the layout, so that the first step
    records their shapes: the stream entering a layer body (``run_layer``'s
    third argument) and every (q, k) shape the flash calls read."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    def wrap(owner, attr, record):
        fn = getattr(owner, attr)

        def wrapped(*args, **kw):
            record(args)
            return fn(*args, **kw)
        setattr(owner, attr, wrapped)

    wrap(transformer, "run_layer", lambda a: seen.setdefault("layer", set()).add(
        tuple(a[2].shape)))
    wrap(ops, "flash_attention",
         lambda a: seen.setdefault("flash", set()).add((tuple(a[0].shape), tuple(a[1].shape))))


def _train(rank: int, data_dir: str, seen: dict) -> None:
    """Two FSDP steps on (2, 2) from the reference's initial state; rank 0
    writes the joined state, backup and losses, every rank its shapes, its
    embedding block and its collectives beside ``model_collectives``."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step, model_collectives

    inp = np.load(f"{data_dir}/train_in.npz", allow_pickle=True)
    model = params_from_numpy(inp["state"].item()["params"], _t_cfg(), device="cpu")
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    art = build_train_step(model, mesh, AdamWConfig(**HP), fsdp_params=True,
                           shape=ShapeConfig("t", SEQ, BATCH, "train"))
    state = shard_init_state(param_tree(model), art.plan, mesh)
    rec = {"embed_block": np.asarray(tuple(state["params"]["embed"]["w"].shape)),
           "head_block": np.asarray(tuple(state["params"]["lm_head"]["w"].shape))}
    out = {}
    for i, tokens in enumerate(inp["batches"]):
        local = {"tokens": shd.local_block(torch.from_numpy(tokens), art.input_pspecs["tokens"],
                                           mesh).contiguous()}
        seen.clear()
        mesh.reset_counts()
        state, metrics, backup = art.step_fn(state, local)
        out[f"loss{i}"] = metrics["loss"].numpy()
        if i == 0:
            out.update(_flat(shd.join_tree(state["opt"]["m"], art.plan.opt_pspecs["m"], mesh),
                             "state0|opt|m|"))
            rec["counts"] = repr({k: v for k, v in mesh.counts.items() if k[1] == ("model",)})
            rec["formula"] = repr(model_collectives(model, mesh, local["tokens"].shape[0], SEQ,
                                                    fsdp_params=True))
            rec["shapes"] = repr(dict(seen))
    np.savez(f"{data_dir}/train_rank{rank}.npz", **rec)
    full = shd.join_tree(state, art.plan.state_pspecs, mesh)
    joined_backup = shd.join_tree(backup, art.backup_pspecs, mesh)
    if rank == 0:
        out.update(_flat(full, "state|"))
        out.update(_flat(joined_backup, "backup|"))
        np.savez(f"{data_dir}/train_port.npz", **out)


def _serve(rank: int, data_dir: str) -> None:
    """The serve on (2, 2), as tests/test_torch_serve_mesh.py's ranks serve
    the other families."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import P
    from repro_torch.train.serve import build_decode_step, build_prefill_step, serve_collectives
    from repro_torch.train.state import param_tree, shard_params
    from repro_torch.tree import keystr, tree_flatten_with_path

    inp = np.load(f"{data_dir}/serve_in.npz", allow_pickle=True)
    cfg = _t_cfg()
    model = params_from_numpy(inp["params"].item(), cfg, device="cpu")
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    b, s, t = BATCH, PROMPT, MAX_LEN
    prefill, plan, in_specs = build_prefill_step(model, mesh, ShapeConfig("p", s, b, "prefill"))
    decode, _, dec_specs = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
    params = shard_params(param_tree(model), plan, mesh)
    local = {"tokens": shd.local_block(torch.from_numpy(inp["tokens"]), in_specs["tokens"], mesh)}
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
    np.savez(f"{data_dir}/serve_rank{rank}.npz", **rec)
    if rank == 0:
        np.savez(f"{data_dir}/serve_port.npz", **out)


def _rank_main(rank: int, data_dir: str):
    """One gloo rank: the train run, then the serve run."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)      # the ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous",
                                rank=rank, world_size=WORLD)
        seen = {}
        _record(seen)
        _train(rank, data_dir, seen)
        _serve(rank, data_dir)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's results: {"train": ..., "serve": ...},
    each (reference, port's rank 0, every rank's record)."""
    data_dir = tmp_path_factory.mktemp("gpt2_mesh")
    rng = np.random.default_rng(0)
    cfg = _j_cfg()
    state = jax.tree.map(np.asarray, j_init_state(j_build_model(cfg), jax.random.key(0)))
    np.savez(data_dir / "train_in.npz", state=np.asarray(state, dtype=object),
             batches=rng.integers(0, cfg.vocab_size, (2, BATCH, SEQ + 1)).astype(np.int32))
    params = jax.tree.map(np.asarray, j_build_model(cfg).init(jax.random.key(1)))
    np.savez(data_dir / "serve_in.npz", params=np.asarray(params, dtype=object),
             tokens=rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32),
             feed=rng.integers(0, cfg.vocab_size, (STEPS, BATCH)).astype(np.int32))
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(SCRIPT), str(data_dir), repr(CHANGES),
         repr(MESH), repr((BATCH, SEQ)), repr((PROMPT, MAX_LEN)), repr(HP)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(data_dir))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        out, err = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        codes, hung = _join(procs, deadline)
    assert ref.returncode == 0, f"reference failed:\n{out}\n{err[-4000:]}"
    assert not hung and codes == [0] * WORLD, f"port ranks exit codes {codes}, hung={hung}"
    return {name: (dict(np.load(data_dir / f"{name}_jax.npz")),
                   dict(np.load(data_dir / f"{name}_port.npz")),
                   [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(WORLD)])
            for name in ("train", "serve")}


# ------------------------------ train step -------------------------------- #
def test_losses_match_jax(runs):
    ref, port, _ = runs["train"]
    for i in range(2):
        np.testing.assert_allclose(port[f"loss{i}"], ref[f"loss{i}"], **TOL)


@pytest.mark.parametrize("part", ["params", "opt|master", "opt|m", "opt|v"])
def test_state_matches_jax(runs, part):
    """Every leaf of the state after two steps, the embedding's and the
    head's pad rows among them."""
    ref, port, _ = runs["train"]
    keys = _keys(port, ref, f"state|{part}|")
    assert len(keys) == 3 + 8, keys       # embed, lm_head, final_norm; 8 a stacked block
    _assert_leaves_close(port, ref, keys)


def test_backup_matches_jax(runs):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_spec, sharded_dim
    from repro_torch.train.state import make_state_plan
    from repro_torch.tree import keystr, tree_flatten_with_path

    model = build_model(_t_cfg(), device="meta")
    plan = make_state_plan(model, Mesh(("data", "model"), MESH), fsdp_params=True)
    dims = {keystr(p): sharded_dim(spec)
            for p, spec in tree_flatten_with_path(plan.opt_pspecs["master"], is_spec)}

    def roll(leaf, x):
        dim = dims[leaf]
        return x if dim is None else np.roll(x, x.shape[dim] // MESH[0], axis=dim)

    ref, port, _ = runs["train"]
    _assert_leaves_close(port, ref, _keys(port, ref, "backup|"), roll)


def test_vocab_blocks_hold_the_pad_rows_on_the_last_model_rank(runs):
    """The embedding and the head split by rows over "model" (FSDP leaves
    them whole over "data"): each rank holds 128 of the 256 padded rows,
    and the last model rank's half holds all 56 pad rows. The first step's
    gradient of the embedding's pad rows is 0 in both packages (no token
    reads them); that of the head's is not (the cross-entropy's softmax
    runs over the pad columns too, in both)."""
    _, port, recs = runs["train"]
    ref = runs["train"][0]
    d = CHANGES["d_model"]
    for rec in recs:
        assert tuple(rec["embed_block"]) == tuple(rec["head_block"]) == (256 // MESH[1], d)
    for leaf in ("embed|w", "lm_head|w"):
        for m in (ref[f"state0|opt|m|{leaf}"], port[f"state0|opt|m|{leaf}"]):
            assert m.shape == (256, d) and np.abs(m[:200]).max() > 0
            assert m[200:].any() == (leaf == "lm_head|w"), leaf


def test_the_stream_and_flash_calls_are_a_ranks_blocks(runs):
    """The sequence splits over "model" (8 positions, 4 a rank): the stream
    entering every layer body is a rank's (4, 4, 320) block, and the flash
    calls read its 2 heads of 80 over the gathered 8 positions."""
    rows, heads = BATCH // MESH[0], CHANGES["num_heads"] // MESH[1]
    for rank, rec in enumerate(runs["train"][2]):
        seen = eval(str(rec["shapes"]))
        assert seen["layer"] == {(rows, SEQ // MESH[1], CHANGES["d_model"])}, (rank, seen)
        q = (rows, SEQ, heads, 80)
        assert seen["flash"] == {(q, q)}, (rank, seen)


def test_model_collectives_equal_the_formula(runs):
    """The collectives over "model" of one step, counted by the mesh on
    every rank, equal ``model_collectives`` in calls and bytes: the
    sequence-parallel gathers and reduce-scatters and the cross-entropy's
    and norms' all-reduces."""
    for rank, rec in enumerate(runs["train"][2]):
        counts = eval(str(rec["counts"]))
        assert counts == eval(str(rec["formula"])), rank
        assert {op for op, _ in counts} == {"all_gather", "reduce_scatter", "all_reduce"}, rank


# ------------------------------ serve steps ------------------------------- #
def _compare(runs, prefix):
    ref, port, _ = runs["serve"]
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix)), (keys, sorted(port))
    for k in keys:
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)


def test_prefill_step_matches_jax(runs):
    """The prefill step at its default max_len: the logits (all 256 padded
    columns) and the joined cache blocks."""
    _compare(runs, "prefill|")
    assert runs["serve"][1]["prefill|logits"].shape == (BATCH, 256)
    for rec in runs["serve"][2]:
        assert int(rec["prefill_index"]) == PROMPT


def test_prefill_to_a_longer_cache_matches_jax(runs):
    """The port's prefill step at max_len 16 against the reference's
    unsharded prefill at 16: logits and the cache, zero past the prompt."""
    _compare(runs, "prefill_t|")


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_steps_match_jax(runs, step):
    """A decode step's logits, each step fed the same token on both sides."""
    _compare(runs, f"decode{step}|")


def test_greedy_tokens_equal_jax_pad_ids_included(runs):
    """The greedy token of the prefill and of every decode step, the argmax
    over all 256 columns, equals the reference's: neither package masks the
    56 pad columns, so some greedy tokens here are pad ids (200-255), and
    they are the reference's."""
    ref, port, _ = runs["serve"]
    names = ["prefill|logits"] + [f"decode{i}|logits" for i in range(STEPS)]
    got = np.stack([port[k].argmax(-1) for k in names])
    want = np.stack([ref[k].argmax(-1) for k in names])
    np.testing.assert_array_equal(got, want)
    assert (want >= 200).any() and (want < 200).any()


def test_final_cache_matches_jax(runs):
    """The cache after the 8 steps, joined from the ranks' blocks; the
    index a host int on every rank."""
    _compare(runs, "final|")
    for rec in runs["serve"][2]:
        assert int(rec["index"]) == PROMPT + STEPS


def test_cache_blocks_are_the_cache_pspecs_blocks(runs):
    """Every rank's cache leaves have the shapes of its blocks under
    ``cache_pspecs``: 4 rows, 8 of the 16 positions, every kv head (the
    cache splits by sequence over "model")."""
    for rank, rec in enumerate(runs["serve"][2]):
        blocks = eval(str(rec["blocks"]))
        assert blocks and all(have == want for have, want in blocks.values()), (rank, blocks)
        assert blocks["k"][0] == blocks["v"][0] == (2, BATCH // MESH[0], MAX_LEN // MESH[1],
                                                    4, 80), (rank, blocks)


def test_collectives_equal_serve_collectives(runs):
    """The collectives the mesh counted in a prefill (at 16) and in a decode
    step, by kind, axes, calls and bytes, equal ``serve_collectives`` on
    every rank."""
    for rank, rec in enumerate(runs["serve"][2]):
        assert str(rec["prefill_counts"]) == str(rec["want_prefill"]), rank
        assert str(rec["decode_counts"]) == str(rec["want_decode"]), rank


# ------------------------- no processes needed ---------------------------- #
@pytest.mark.parametrize("layers", [2, 32])
def test_the_formula_at_gpt2_full_width(layers):
    """``model_collectives`` for gpt2-2.7b at full width on (2, 2), FSDP, one
    microbatch of 4 x 1024, the sequence split (a = A/2, A = 4 x 1024 x
    2560 x 2): the embedding's reduce-scatter and its backward gather; each
    layer's two regions, 6 gathers and 5 scatters with the recompute; the
    head's gather and its backward scatter; the cross-entropy's two
    statistics and one all-reduce of the norms' gradients (a "data" half of
    ln1, ln2 and final_norm, bf16). At 2 layers, the card's cut, and at
    32."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import model_collectives
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=layers)
    model = build_model(cfg, device="meta")
    act = 4 * 1024 * 2560 * 2
    norms = (2 * layers * 2560 + 2560) * 2 // 2
    assert model_collectives(model, Mesh(("data", "model"), MESH), 4, 1024) == {
        ("all_gather", ("model",)): [2 + layers * 6, (2 + layers * 6) * act // 2],
        ("reduce_scatter", ("model",)): [2 + layers * 5, (2 + layers * 5) * act],
        ("all_reduce", ("model",)): [2 + 1, 4 * 1024 * 12 + norms]}


def test_serve_collectives_at_gpt2_full_width():
    """gpt2-2.7b at full width and depth on (data 2, model 2), 8 prompts of
    1,000 tokens and a cache of 1,032: per rank 4 rows and 16 of the 32
    heads. Prefill: the embedding's all-reduce and 2 a layer of the 4 x
    1000 x 2560 bf16 activations, each layer's k and v heads gathered for
    the cache, the logits' gather (4 rows of a rank's 25,216 columns, fp32);
    a decode step: the same all-reduces of one position, and in each layer
    the new position's k and v heads, the q heads and the (o, lse) of the
    32 heads gathered, then the logits."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.serve import serve_collectives
    model = build_model(get_arch(ARCH), device="meta")
    got = serve_collectives(model, Mesh(("data", "model"), MESH), 8, 1000, 1032)
    m, L = ("model",), 32
    act = 4 * 1000 * 2560 * 2
    logits = 4 * 4 * 50432 // 2
    assert got["prefill"] == {
        ("all_reduce", m): [1 + 2 * L, (1 + 2 * L) * act],
        ("all_gather", m): [L + 1, L * 2 * 4 * 1000 * 16 * 80 * 2 + logits]}
    assert got["decode"] == {
        ("all_reduce", m): [1 + 2 * L, (1 + 2 * L) * act // 1000],
        ("all_gather", m): [3 * L + 1, L * (2 * 4 * 16 * 80 * 2 + 4 * 16 * 80 * 2
                                            + 4 * 4 * 32 * 81) + logits]}
