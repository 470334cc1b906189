"""The port's sharding rules and checkpoint razor against the JAX
package's, on the CPU and without devices: every config the port has, at
full size, on abstract meshes of shape (4, 2), (16, 16) and (2, 16, 16).
Each leaf's ``param_pspecs`` (FSDP on and off), the ZeRO-1 ``opt_pspecs``
of ``make_state_plan``, ``input_pspecs`` of every shape the config can run
and ``cache_pspecs`` equal the reference's (the port's ``P`` turned into a
tuple of parts beside ``jax.sharding.PartitionSpec``'s), and every field of
the ``RazorPlan`` equals the reference's exactly. Then the cut of a tensor
into this rank's block and the join back, on a mesh without processes."""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.core.razor import razor_plan as j_razor_plan
from repro.models import build_model as j_build_model
from repro.parallel import sharding as j_shd
from repro.train.state import make_state_plan as j_make_state_plan
from repro_torch.configs import SHAPES, get_arch
from repro_torch.core.razor import razor_plan
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P
from repro_torch.train.state import make_state_plan
from repro_torch.tree import keystr, tree_flatten_with_path

ARCHS = ["deepseek-67b", "gemma-2b", "gpt2-2.7b", "llama2-13b", "llama3-70b", "llama3-8b",
         "mamba2-2.7b", "nemotron-4-15b", "qwen3-0.6b", "zamba2-7b"]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def test_the_configs_are_every_config_of_the_port():
    get_arch("qwen3-0.6b")
    from repro_torch.configs import _REGISTRY
    assert sorted(_REGISTRY) == ARCHS


@functools.lru_cache(maxsize=None)
def _meshes(mesh_name):
    sizes, axes = MESHES[mesh_name]
    return AbstractMesh(sizes, axes), Mesh(axes, sizes)


@functools.lru_cache(maxsize=None)
def _models(arch):
    return j_build_model(j_get_arch(arch)), build_model(get_arch(arch), device="meta")


@functools.lru_cache(maxsize=None)
def _plans(arch, mesh_name, fsdp):
    jmodel, model = _models(arch)
    jmesh, mesh = _meshes(mesh_name)
    return (j_make_state_plan(jmodel, jmesh, fsdp_params=fsdp),
            make_state_plan(model, mesh, fsdp_params=fsdp))


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in flat}


def _port_specs(tree):
    return {keystr(path): tuple(spec)
            for path, spec in tree_flatten_with_path(tree, shd.is_spec)}


def _assert_same_specs(port_tree, jax_tree):
    port, ref = _port_specs(port_tree), _jax_specs(jax_tree)
    assert sorted(port) == sorted(ref)
    bad = {k: (port[k], ref[k]) for k in ref if port[k] != ref[k]}
    assert not bad, bad


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_pspecs_match_jax(arch, mesh_name, fsdp):
    jplan, plan = _plans(arch, mesh_name, fsdp)
    _assert_same_specs(plan.param_pspecs, jplan.param_pspecs)
    _assert_same_specs(plan.opt_pspecs, jplan.opt_pspecs)
    _assert_same_specs(plan.state_pspecs, jplan.state_pspecs)
    # and param_pspecs called directly on the reference's specs' shapes
    _assert_same_specs(shd.param_pspecs(get_arch(arch), plan.state_specs["params"],
                                        _meshes(mesh_name)[1], fsdp=fsdp),
                       j_shd.param_pspecs(j_get_arch(arch), jplan.state_specs["params"],
                                          _meshes(mesh_name)[0], fsdp=fsdp))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_razor_plan_matches_jax(arch, mesh_name, fsdp):
    jplan, plan = _plans(arch, mesh_name, fsdp)
    jmesh, mesh = _meshes(mesh_name)
    jr = j_razor_plan(jplan.state_specs["opt"], jplan.opt_pspecs,
                      jplan.state_specs["params"], jmesh)
    r = razor_plan(plan.state_specs["opt"], plan.opt_pspecs, plan.state_specs["params"], mesh)
    assert (r.dp, r.unique_bytes, r.redundant_bytes, r.full_bytes) == \
        (jr.dp, jr.unique_bytes, jr.redundant_bytes, jr.full_bytes)
    assert r.unique_bytes_per_device_ring == jr.unique_bytes_per_device_ring
    assert r.reduction == jr.reduction
    jmask = {"|".join(str(getattr(k, "key", k)) for k in p): bool(m)
             for p, m in jax.tree_util.tree_flatten_with_path(jr.unique_mask)[0]}
    assert {keystr(p): bool(m) for p, m in tree_flatten_with_path(r.unique_mask)} == jmask


def test_razor_plan_of_qwen3_on_4x2_with_fsdp():
    """The reference's numbers: 12 bytes a parameter of unique state."""
    _, plan = _plans("qwen3-0.6b", "4x2", True)
    r = razor_plan(plan.state_specs["opt"], plan.opt_pspecs, plan.state_specs["params"],
                   _meshes("4x2")[1])
    assert (r.dp, r.unique_bytes, r.full_bytes) == (4, 7_154_171_904, 33_386_135_552)


def _shapes(arch):
    cfg = get_arch(arch)
    return [name for name, s in SHAPES.items()
            if not s.requires_sub_quadratic or cfg.sub_quadratic]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_pspecs_match_jax(arch, mesh_name):
    jmodel, model = _models(arch)
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    for name in _shapes(arch):
        jshape, shape = J_SHAPES[name], SHAPES[name]
        _assert_same_specs(shd.input_pspecs(cfg, model.input_specs(shape), mesh),
                           j_shd.input_pspecs(jcfg, jmodel.input_specs(jshape), jmesh))
        if shape.kind == "decode":
            b, s = shape.global_batch, shape.seq_len
            _assert_same_specs(shd.cache_pspecs(cfg, model.cache_specs(b, s), mesh),
                               j_shd.cache_pspecs(jcfg, jmodel.cache_specs(b, s), jmesh))


# ----------------------------- blocks ------------------------------------ #
def test_p_is_an_immutable_leaf_normalized_as_jax_does():
    spec = P("data", ["pod", "data"], None, ("model",), ())
    assert spec.parts == tuple(JP("data", ("pod", "data"), None, ("model",), ()))
    assert spec.parts == ("data", ("pod", "data"), None, "model", None) and len(spec) == 5
    assert spec == P("data", ("pod", "data"), None, "model", None) and spec != P("data")
    with pytest.raises(AttributeError):
        spec.parts = ()
    assert tree_flatten_with_path({"a": spec})[0][1] is spec


@pytest.mark.parametrize("spec", [P("data", None), P(None, "data"), P(("pod", "data")),
                                  P("pod", "data"), P(None, ("data", "model"), "pod")])
def test_blocks_tile_the_tensor_in_rank_order(spec):
    """Every rank's block, placed at block_slices, covers the tensor once
    per replica, and the block index along a dim named by several axes is
    the first axis's coordinate major."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(4 * 8 * 4, dtype=torch.float32).reshape(4, 8, 4)
    covered = torch.zeros_like(x)
    replicas = 8 // 2 ** sum(len(shd._names(p)) for p in spec)
    for rank in range(8):
        mesh = Mesh(tuple(sizes), tuple(sizes.values()), rank=rank)
        block = shd.local_block(x, spec, mesh)
        view = covered
        for dim, start, size in shd.block_slices(spec, tuple(x.shape), mesh):
            view = view.narrow(dim, start, size)
        view += 1
        torch.testing.assert_close(block, _expected_block(x, spec, mesh.coords, sizes))
    assert torch.equal(covered, torch.full_like(x, replicas))


def _expected_block(x, spec, coords, sizes):
    for dim, part in enumerate(spec):
        names = shd._names(part)
        if not names:
            continue
        n, i = 1, 0
        for a in names:
            n *= sizes[a]
            i = i * sizes[a] + coords[a]
        x = x.chunk(n, dim=dim)[i]
    return x


def test_join_on_one_rank_is_the_tensor():
    mesh = Mesh(("data", "model"), (1, 1))
    x = torch.randn(4, 6)
    block = shd.local_block(x, P("data", "model"), mesh)
    joined = shd.join_tree({"a": block, "b": None}, {"a": P("data", "model"), "b": None}, mesh)
    assert torch.equal(joined["a"], x) and joined["b"] is None
