"""The port's serve steps on a mesh against the JAX package's, on the CPU:
gloo ranks of ``repro_torch.train.serve.build_prefill_step`` /
``build_decode_step`` on (data, model) meshes against
``repro.train.serve``'s builders on the same host meshes of forced host
devices, from the same weights (the reference's ``init``, moved through
``bridge.params_from_numpy``), in fp32 at 2e-4:

- qwen3-0.6b smoke on (2, 2), and on (1, 4), where its 2 kv heads stay
  replicated beside 4 split q heads;
- gemma-2b smoke on (2, 2) (one kv head);
- qwen2-moe smoke on (2, 2), routing the global batch;
- mamba2 and zamba2 smoke on (2, 2) (the SSM state split by heads);
- qwen3 with a batch of 1, whose cache splits over ("data", "model");
- qwen3 with a cache length that does not divide over "model", so that the
  cache stays whole there.

Compared: the prefill step's logits and its joined cache blocks
(``shd.join_tree``) at max_len = S; the port's prefill at max_len = T
against the reference's unsharded ``model.prefill`` at T; then 8 decode
steps' logits and the final cache, the reference's decode step started
from that unsharded cache (its prefill step cannot take a max_len beyond
the prompt: ``batch.get("max_len", ...)`` runs inside its jit, and its
``input_pspecs`` hold only ``tokens``). Within the port each rank's cache
blocks are those that ``parallel.sharding.cache_pspecs`` gives, and the
collectives the mesh counted in a prefill and in a decode step equal
``train.serve.serve_collectives`` on every rank.

The reference runs in three subprocesses and the port's ranks in one set of
four spawned processes (``file://`` rendezvous under the test's temporary
directory), all at once, each joined with a deadline."""
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

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)          # the serving slice's fp32 tolerance
DEADLINE_S = 420                          # a hang guard: ~40 s alone, more beside other workers
STEPS = 8                                 # decode steps
WORLD = 4
# name -> (arch, mesh (data, model), global batch, prompt S, cache length T,
#          the axes the KV cache's sequence splits over at T)
RUNS = {
    "qwen3_2x2": ("qwen3-0.6b", (2, 2), 8, 12, 20, ("model",)),
    "qwen3_1x4": ("qwen3-0.6b", (1, 4), 8, 12, 20, ("model",)),
    "gemma_2x2": ("gemma-2b", (2, 2), 8, 12, 20, ("model",)),
    "moe_2x2": ("qwen2-moe-a2.7b", (2, 2), 8, 12, 20, ("model",)),
    "mamba2_2x2": ("mamba2-2.7b", (2, 2), 8, 12, 20, ()),
    "zamba2_2x2": ("zamba2-7b", (2, 2), 8, 12, 20, ("model",)),
    "batch1_2x2": ("qwen3-0.6b", (2, 2), 1, 12, 20, ("data", "model")),
    "odd_len_2x2": ("qwen3-0.6b", (2, 2), 8, 13, 21, ()),
}
GROUPS = ({k for k, v in RUNS.items() if v[0] == "qwen3-0.6b"},
          {"gemma_2x2", "moe_2x2"}, {"mamba2_2x2", "zamba2_2x2"})

JAX_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.train.serve import build_decode_step, build_prefill_step

runs, data_dir, steps = eval(sys.argv[1]), sys.argv[2], int(sys.argv[3])

def flat(tree, prefix):
    return {prefix + "|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

for name, (arch, (data, mdl), b, s, t, _) in runs.items():
    inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
    params, tokens, feed = inp["params"].item(), inp["tokens"], inp["feed"]
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
    model = build_model(cfg)
    mesh = make_mesh_compat((data, mdl), ("data", "model"), devices=jax.devices()[:data * mdl])
    out = {}
    prefill, _, _ = build_prefill_step(model, mesh, ShapeConfig("p", s, b, "prefill"))
    with mesh:
        logits, cache = prefill(params, {"tokens": tokens})
    out["prefill|logits"] = np.asarray(logits, np.float32)
    out.update(flat({k: v for k, v in cache.items() if k != "index"}, "prefill|cache|"))
    logits, cache = model.prefill(params, {"tokens": jnp.asarray(tokens), "max_len": t})
    out["prefill_t|logits"] = np.asarray(logits, np.float32)
    out.update(flat({k: v for k, v in cache.items() if k != "index"}, "prefill_t|cache|"))
    decode, _, _ = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
    cache = jax.tree.map(np.asarray, cache)
    with mesh:
        for i in range(steps):
            logits, cache = decode(params, cache, feed[i])
            out[f"decode{i}|logits"] = np.asarray(logits, np.float32)
    out.update(flat({k: v for k, v in cache.items() if k != "index"}, "final|cache|"))
    np.savez(f"{data_dir}/{name}_jax.npz", **out)
"""


def _cfg(arch):
    return dataclasses.replace(j_reduce(j_get_arch(arch)), dtype="float32")


# ------------------------------- the ranks -------------------------------- #
def _rank_main(rank: int, data_dir: str):
    """One gloo rank: every run of RUNS from the reference's weights; rank 0
    writes the joined logits and caches, every rank its cache blocks'
    shapes and the collectives it counted beside ``serve_collectives``."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import P
    from repro_torch.train.serve import build_decode_step, build_prefill_step, serve_collectives
    from repro_torch.train.state import param_tree, shard_params
    from repro_torch.tree import keystr, tree_flatten_with_path
    try:
        torch.set_num_threads(1)      # the ranks and the reference share the cores
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous",
                                rank=rank, world_size=WORLD)

        def flat(tree, prefix):
            return {prefix + keystr(p): t.float().numpy()
                    for p, t in tree_flatten_with_path(tree)}

        for name, (arch, (data, mdl), b, s, t, _) in RUNS.items():
            inp = np.load(f"{data_dir}/{name}_in.npz", allow_pickle=True)
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
            model = params_from_numpy(inp["params"].item(), cfg, device="cpu")
            mesh = make_host_mesh(data=data, model=mdl)
            prefill, plan, in_specs = build_prefill_step(
                model, mesh, ShapeConfig("p", s, b, "prefill"))
            decode, _, dec_specs = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
            params = shard_params(param_tree(model), plan, mesh)
            tokens = shd.local_block(torch.from_numpy(inp["tokens"]), in_specs["tokens"], mesh)
            want = serve_collectives(model, mesh, b, s, t)
            rows = P(in_specs["tokens"][0], None)

            def joined(logits, cache, length, prefix):
                specs = shd.cache_pspecs(cfg, model.cache_specs(b, length), mesh)
                blocks = {k: v for k, v in cache.items() if k != "index"}
                full = shd.join_tree({"logits": logits, "cache": blocks},
                                     {"logits": rows,
                                      "cache": {k: specs[k] for k in blocks}}, mesh)
                return flat(full, prefix)

            out, rec = {}, {}
            logits, cache = prefill(params, {"tokens": tokens})
            out.update(joined(logits, cache, s, "prefill|"))
            mesh.reset_counts()
            logits, cache = prefill(params, {"tokens": tokens, "max_len": t})
            rec["prefill_counts"] = repr(sorted(mesh.counts.items()))
            out.update(joined(logits, cache, t, "prefill_t|"))
            whole = dict(tree_flatten_with_path(model.cache_specs(b, t)))
            specs = dict(tree_flatten_with_path(shd.cache_pspecs(
                cfg, model.cache_specs(b, t), mesh), shd.is_spec))
            rec["blocks"] = repr({keystr(p): (tuple(x.shape), shd.block_shape(
                specs[p], tuple(whole[p].shape), mesh)) for p, x in tree_flatten_with_path(
                    {k: v for k, v in cache.items() if k != "index"})})
            for i, tok in enumerate(inp["feed"]):
                mesh.reset_counts()
                local = shd.local_block(torch.from_numpy(tok), dec_specs["token"], mesh)
                logits, cache = decode(params, cache, local)
                if i == 0:
                    rec["decode_counts"] = repr(sorted(mesh.counts.items()))
                out.update({f"decode{i}|{k.split('|', 1)[1]}": v for k, v in joined(
                    logits, {}, t, "x|").items()})
            out.update({k: v for k, v in joined(logits, cache, t, "final|").items()
                        if "|cache|" in k})
            rec["want_prefill"] = repr(sorted(want["prefill"].items()))
            rec["want_decode"] = repr(sorted(want["decode"].items()))
            rec["index"] = np.asarray(cache["index"])
            np.savez(f"{data_dir}/{name}_rank{rank}.npz", **rec)
            if rank == 0:
                np.savez(f"{data_dir}/{name}_port.npz", **out)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


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
    data_dir = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(0)
    for name, (arch, _, b, s, _, _) in RUNS.items():
        cfg = _cfg(arch)
        params = jax.tree.map(np.asarray, j_build_model(cfg).init(jax.random.key(0)))
        np.savez(data_dir / f"{name}_in.npz", params=np.asarray(params, dtype=object),
                 tokens=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 feed=rng.integers(0, cfg.vocab_size, (STEPS, b)).astype(np.int32))
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         repr({k: RUNS[k] for k in sorted(g)}), str(data_dir), str(STEPS)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in GROUPS]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(data_dir))) for r in range(WORLD)]
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
        assert r.returncode == 0, f"reference serve failed:\n{out}\n{err[-4000:]}"
    assert not hung and codes == [0] * WORLD, f"port ranks exit codes {codes}, hung={hung}"
    return {name: (dict(np.load(data_dir / f"{name}_jax.npz")),
                   dict(np.load(data_dir / f"{name}_port.npz")),
                   [dict(np.load(data_dir / f"{name}_rank{r}.npz")) for r in range(WORLD)])
            for name in RUNS}


def _compare(runs, name, prefix):
    ref, port, _ = runs[name]
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix)), (keys, sorted(port))
    for k in keys:
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)


# --------------------------------- tests ---------------------------------- #
@pytest.mark.parametrize("name", list(RUNS))
def test_prefill_step_matches_jax(runs, name):
    """The prefill step at max_len = S: logits and the joined cache blocks."""
    _compare(runs, name, "prefill|")


@pytest.mark.parametrize("name", list(RUNS))
def test_prefill_to_a_longer_cache_matches_jax(runs, name):
    """The port's prefill step at max_len = T against the reference's
    unsharded prefill at T: logits and the cache, zero past the prompt."""
    _compare(runs, name, "prefill_t|")


@pytest.mark.parametrize("name", list(RUNS))
def test_decode_steps_match_jax(runs, name):
    """8 decode steps' logits, each step fed the same token on both sides."""
    for i in range(STEPS):
        _compare(runs, name, f"decode{i}|")


@pytest.mark.parametrize("name", list(RUNS))
def test_final_cache_matches_jax(runs, name):
    """The cache after the 8 steps, joined from the ranks' blocks; its
    index is a host int on every rank."""
    _compare(runs, name, "final|")
    for rec in runs[name][2]:
        assert int(rec["index"]) == RUNS[name][3] + STEPS


@pytest.mark.parametrize("name", list(RUNS))
def test_cache_blocks_are_the_cache_pspecs_blocks(runs, name):
    """Every rank's cache leaves have the shapes of its blocks under
    ``cache_pspecs``, whose KV caches split the sequence over the run's
    axes (whole where T does not divide over "model"), and the SSM state
    the heads over "model"."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd
    arch, mesh_shape, b, _, t, t_axes = RUNS[name]
    model = build_model(reduce_for_smoke(get_arch(arch)), device="meta")
    specs = shd.cache_pspecs(model.cfg, model.cache_specs(b, t), Mesh(("data", "model"),
                                                                      mesh_shape))
    if "k" in specs:
        got = specs["k"][2]
        assert ((got,) if isinstance(got, str) else tuple(got or ())) == t_axes
    if "mamba" in specs:
        assert specs["mamba"]["ssm"][2] == "model"
    for rank, rec in enumerate(runs[name][2]):
        blocks = eval(str(rec["blocks"]))
        assert blocks and all(have == want for have, want in blocks.values()), (rank, blocks)


@pytest.mark.parametrize("name", list(RUNS))
def test_collectives_equal_serve_collectives(runs, name):
    """The collectives the mesh counted in a prefill (at T) and in a decode
    step, by kind, axes, calls and bytes, equal ``serve_collectives`` on
    every rank; a split run makes some."""
    for rank, rec in enumerate(runs[name][2]):
        assert str(rec["prefill_counts"]) == str(rec["want_prefill"]), rank
        assert str(rec["decode_counts"]) == str(rec["want_decode"]), rank
        assert eval(str(rec["decode_counts"])), rank


# ------------------------- no processes needed ---------------------------- #
def test_serve_collectives_at_gemma_full_width():
    """gemma-2b at full width on (data 2, model 2), 8 prompts of 1,000 and a
    cache of 1,032: per rank 4 rows; prefill 1 + 18 x 2 all-reduces of the
    4 x 1000 x 2048 bf16 activations and the logits' gather; decode the same
    all-reduces of one position, 18 q-head gathers, 18 merges of (o, lse)
    over "model" and the logits' gather. The one kv head is replicated, so
    nothing gathers kv heads."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.serve import serve_collectives
    model = build_model(get_arch("gemma-2b"), device="meta")
    got = serve_collectives(model, Mesh(("data", "model"), (2, 2)), 8, 1000, 1032)
    m = ("model",)
    act = 4 * 1000 * 2048 * 2
    logits = 4 * 4 * 256000 // 2
    assert got["prefill"] == {("all_reduce", m): [37, 37 * act], ("all_gather", m): [1, logits]}
    assert got["decode"] == {("all_reduce", m): [37, 37 * act // 1000],
                             ("all_gather", m): [18 + 18 + 1,
                                                 18 * 4 * 4 * 256 * 2
                                                 + 18 * 4 * 4 * 8 * 257 + logits]}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_a_one_rank_mesh_serves_as_one_device_and_holds_no_weights(arch):
    """On a (1, 1) mesh with no process group the mesh's steps run the
    one-device calls' math on the params given (their blocks are the whole
    leaves), bit for bit, and keep no reference to the model they were built
    from: its weights are freed once the caller drops it."""
    import gc
    import weakref

    from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    from repro_torch.train.state import param_tree, shard_params
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mesh = make_single_device_mesh()
    b, s, t = 2, 6, 10
    prefill, plan, _ = build_prefill_step(model, mesh, ShapeConfig("p", s, b, "prefill"))
    decode, _, _ = build_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
    params = shard_params(param_tree(model), plan, mesh)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s)))
    want, cache_w = build_prefill_step(model)(tokens, t)
    got, cache = prefill(params, {"tokens": tokens, "max_len": t})
    assert torch.equal(got, want)
    for _ in range(3):
        tok = want.argmax(-1)
        want, cache_w = build_decode_step(model)(cache_w, tok)
        got, cache = decode(params, cache, tok)
        assert torch.equal(got, want)
    weights = weakref.ref(model.embed["w"])
    del model, cache_w
    gc.collect()
    assert weights() is None
