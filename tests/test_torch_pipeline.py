"""The port's GPipe forward (``repro_torch.parallel.pipeline``) on four gloo
CPU ranks of a ("pipe",) mesh, against the sequential loop and against the
JAX package's ``pipeline_forward`` on four forced host devices, on the
inputs of tests/test_pipeline.py (8 layers of ``tanh(h @ w)``, D 16, 6
microbatches of 2 x 4, seed 0), at 1e-5; then two smoke qwen3 blocks a
stage through ``Block.apply_layer`` against the loop over the same 8
blocks; the collectives the schedule ran; and ``bubble_fraction`` against
the reference's.

The reference runs in a subprocess and the port's ranks in spawned
processes (``file://`` rendezvous under the test's temporary directory),
at once, each joined with a deadline."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
DEADLINE_S = 300
STAGES = 4
L, D, M, MB, S = 8, 16, 6, 2, 4          # tests/test_pipeline.py's
BLOCKS = dict(layers=8, microbatches=4, rows=2, seq=8)   # two smoke qwen3 blocks a stage

JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh_compat
from repro.parallel.pipeline import pipeline_forward

inp = np.load(sys.argv[1] + "/in.npz")
mesh = make_mesh_compat((4,), ("pipe",))
params = {"w": jnp.asarray(inp["w"])}
with mesh:
    out = jax.jit(lambda p, x: pipeline_forward(
        lambda p, h: jnp.tanh(h @ p["w"]), p, x, mesh))(params, jnp.asarray(inp["x"]))
np.save(sys.argv[1] + "/jax.npy", np.asarray(out))
"""


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, MB, S, D)).astype(np.float32)
    return w, x


def _blocks_model():
    """The smoke qwen3 at 8 layers, fp32, weights from a host seed."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")),
                              num_layers=BLOCKS["layers"], dtype="float32")
    return build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))


def _blocks_input(cfg):
    b = BLOCKS
    return torch.from_numpy(np.random.default_rng(4).normal(
        size=(b["microbatches"], b["rows"], b["seq"], cfg.d_model)).astype(np.float32))


def _rank_main(rank: int, world: int, data_dir: str):
    """One stage: its block of the tanh stack and of the qwen3 blocks
    through ``pipeline_forward``; each rank writes its outputs and the
    mesh's collective counts."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import pipeline_forward
    from repro_torch.parallel.sharding import P, local_block
    from repro_torch.tree import tree_map
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{data_dir}/rendezvous",
                                rank=rank, world_size=world)
        mesh = make_mesh((world,), ("pipe",))
        w, x = _inputs()
        stacked = {"w": local_block(torch.from_numpy(w), P("pipe"), mesh)}
        out = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), stacked,
                               torch.from_numpy(x), mesh)
        counts = {f"{op}|{'.'.join(axes)}": list(v) for (op, axes), v in mesh.counts.items()}

        model = _blocks_model()
        per = len(model.blocks) // world
        mine = [blk.layer_params() for blk in model.blocks[rank * per:(rank + 1) * per]]
        stage = tree_map(lambda *layers: torch.stack(layers), *mine)
        blk = model.blocks[0]
        with torch.no_grad():
            blocks_out = pipeline_forward(lambda p, h: blk.apply_layer(p, h)[0], stage,
                                          _blocks_input(model.cfg), mesh)
        np.savez(f"{data_dir}/rank{rank}.npz", out=out.numpy(), blocks=blocks_out.numpy(),
                 counts=np.asarray(repr(counts)))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's outputs and counts, and the reference's output."""
    data_dir = tmp_path_factory.mktemp("pipeline")
    w, x = _inputs()
    np.savez(data_dir / "in.npz", w=w, x=x)
    deadline = time.monotonic() + DEADLINE_S
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(data_dir)],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, STAGES, str(data_dir)))
             for r in range(STAGES)]
    for p in procs:
        p.start()
    try:
        out, err = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert ref.returncode == 0, f"reference pipeline failed:\n{out}\n{err[-4000:]}"
    codes = [p.exitcode for p in procs]
    assert not hung and codes == [0] * STAGES, f"port ranks exit codes {codes}"
    return ([dict(np.load(data_dir / f"rank{r}.npz")) for r in range(STAGES)],
            np.load(data_dir / "jax.npy"))


def _sequential():
    w, x = _inputs()
    h = torch.from_numpy(x)
    for i in range(L):
        h = torch.tanh(h @ torch.from_numpy(w[i]))
    return h.numpy()


@pytest.mark.parametrize("rank", range(STAGES))
def test_pipeline_matches_sequential_on_every_rank(runs, rank):
    np.testing.assert_allclose(runs[0][rank]["out"], _sequential(), **TOL)


def test_pipeline_matches_jax(runs):
    np.testing.assert_allclose(runs[0][0]["out"], runs[1], **TOL)


def test_qwen3_blocks_through_apply_layer_match_the_loop(runs):
    """Two smoke qwen3 blocks a stage, ``Block.apply_layer`` as the layer,
    against the loop over the same 8 blocks on the whole batch."""
    model = _blocks_model()
    x = _blocks_input(model.cfg)
    h = x.reshape(-1, *x.shape[2:])
    with torch.no_grad():
        for blk in model.blocks:
            h = blk.apply_layer(blk.layer_params(), h)[0]
    want = h.reshape(x.shape).numpy()
    assert np.abs(want - x.numpy()).max() > 0.1          # the blocks did something
    for rank in range(STAGES):
        np.testing.assert_allclose(runs[0][rank]["blocks"], want, **TOL)


def test_the_schedule_runs_one_exchange_a_tick_and_one_broadcast(runs):
    """M + P - 1 ring exchanges of one microbatch's activations, and the
    last stage's outputs broadcast once, on every rank."""
    tick_bytes = MB * S * D * 4
    for rec in runs[0]:
        counts = eval(str(rec["counts"]))
        assert counts == {"ring_exchange|pipe": [M + STAGES - 1, (M + STAGES - 1) * tick_bytes],
                          "broadcast|pipe": [1, M * tick_bytes]}


@pytest.mark.parametrize("stages, micro", [(4, 6), (4, 8), (2, 1), (1, 5), (8, 16)])
def test_bubble_fraction_is_the_references(stages, micro):
    from repro.parallel.pipeline import bubble_fraction as j_bubble_fraction

    from repro_torch.parallel import bubble_fraction
    assert bubble_fraction(stages, micro) == j_bubble_fraction(stages, micro)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
