"""The dry-run's config names and the HBM memory model of the port against
the JAX package's, on the CPU and without devices: ``ASSIGNED``,
``PAPER_WORKLOADS``, ``list_archs``, ``get_shape`` and ``dryrun_cells``
equal the reference's; every registered config and its smoke form equal
the reference's field by field; and ``roofline.memory_model``'s
``analytic_hbm_traffic`` gives the reference's floats, every key, for every
dry-run cell (the ten assigned archs, the four shapes, long_500k's skipped
cells too) on the abstract meshes (4, 2), (16, 16) and (2, 16, 16) of
tests/test_torch_sharding.py, with the razor's unique bytes for the train
shapes. Plans are built once per (arch, mesh) and shared by the shapes."""
import dataclasses
import functools

import pytest
from jax.sharding import AbstractMesh

from repro import configs as j_configs
from repro.core.razor import razor_plan as j_razor_plan
from repro.models import build_model as j_build_model
from repro.roofline import memory_model as j_mm
from repro.train.state import make_state_plan as j_make_state_plan
from repro_torch import configs
from repro_torch.core.razor import razor_plan
from repro_torch.launch.mesh import Mesh, make_single_device_mesh
from repro_torch.models import build_model, param_count
from repro_torch.roofline import memory_model as mm
from repro_torch.train.state import make_state_plan

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(cfg.name, shape.name) for cfg, shape, _ in configs.dryrun_cells(include_skips=True)]


# ------------------------------ config names ----------------------------- #
def test_config_names_are_the_references():
    assert configs.ASSIGNED == j_configs.ASSIGNED
    assert configs.PAPER_WORKLOADS == j_configs.PAPER_WORKLOADS
    assert configs.list_archs() == j_configs.list_archs()
    assert len(configs.ASSIGNED) == 10 and set(configs.ASSIGNED) < set(configs.list_archs())


@pytest.mark.parametrize("name", list(j_configs.SHAPES))
def test_get_shape_is_the_references(name):
    shape, ref = configs.get_shape(name), j_configs.get_shape(name)
    assert dataclasses.asdict(shape) == dataclasses.asdict(ref)


def test_an_unknown_shape_raises_the_references_error():
    with pytest.raises(KeyError) as port:
        configs.get_shape("train_8k")
    with pytest.raises(KeyError) as ref:
        j_configs.get_shape("train_8k")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("include_skips", [False, True])
def test_dryrun_cells_are_the_references(include_skips):
    port = [(cfg.name, shape.name, skip)
            for cfg, shape, skip in configs.dryrun_cells(include_skips)]
    ref = [(cfg.name, shape.name, skip)
           for cfg, shape, skip in j_configs.dryrun_cells(include_skips)]
    assert port == ref
    assert len(port) == (40 if include_skips else 32)
    assert all(not skip for *_, skip in port) or include_skips


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", j_configs.list_archs())
def test_arch_config_is_the_references_field_by_field(arch, smoke):
    """The same field names in the same order, and the same values; the
    smoke form sets ``remat_policy`` to "none" as the reference's does."""
    cfg, ref = configs.get_arch(arch), j_configs.get_arch(arch)
    if smoke:
        cfg, ref = configs.reduce_for_smoke(cfg), j_configs.reduce_for_smoke(ref)
    names = [f.name for f in dataclasses.fields(cfg)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    assert {n: getattr(cfg, n) for n in names} == {n: getattr(ref, n) for n in names}
    assert cfg.remat_policy == ("none" if smoke else "full")


# ----------------------------- memory model ------------------------------ #
@functools.lru_cache(maxsize=None)
def _meshes(mesh_name):
    sizes, axes = MESHES[mesh_name]
    return AbstractMesh(sizes, axes), Mesh(axes, sizes)


@functools.lru_cache(maxsize=None)
def _plans(arch, mesh_name):
    """The reference's and the port's (plan, razor) as the reference's
    dry-run makes them: ``make_state_plan`` at its default (no FSDP)."""
    jmesh, mesh = _meshes(mesh_name)
    jplan = j_make_state_plan(j_build_model(j_configs.get_arch(arch)), jmesh)
    plan = make_state_plan(build_model(configs.get_arch(arch), device="meta"), mesh)
    jrazor = j_razor_plan(jplan.state_specs["opt"], jplan.opt_pspecs,
                          jplan.state_specs["params"], jmesh)
    razor = razor_plan(plan.state_specs["opt"], plan.opt_pspecs, plan.state_specs["params"],
                       mesh)
    return (jplan, jrazor), (plan, razor)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_hbm_traffic_is_the_references(arch, shape, mesh_name):
    """Every key, as floats equal to the reference's (the train shapes with
    the razor's unique bytes, the serve shapes with the cache's)."""
    (jplan, jrazor), (plan, razor) = _plans(arch, mesh_name)
    jmesh, mesh = _meshes(mesh_name)
    train = configs.get_shape(shape).kind == "train"
    got = mm.analytic_hbm_traffic(configs.get_arch(arch), configs.get_shape(shape), mesh,
                                  plan, razor if train else None)
    want = j_mm.analytic_hbm_traffic(j_configs.get_arch(arch), j_configs.get_shape(shape),
                                     jmesh, jplan, jrazor if train else None)
    assert got == want
    assert set(got) == ({"params_local", "opt_local", "traffic"}
                        | (set() if train else {"cache_local"}))
    assert all(isinstance(v, float) and v > 0 for v in got.values())


def test_sharded_bytes_of_qwen3_on_one_device_are_two_a_parameter():
    """The port's tests/test_substrates.py::test_memory_model_param_accounting:
    bf16 params, unsharded on a (1, 1) mesh."""
    cfg = configs.get_arch("qwen3-0.6b")
    mesh = make_single_device_mesh()
    plan = make_state_plan(build_model(cfg, device="meta"), mesh)
    assert mm.sharded_bytes(plan.state_specs["params"], plan.param_pspecs, mesh) \
        == 2 * param_count(cfg)


def test_sharded_bytes_divide_by_the_named_axes():
    """A leaf's bytes over the product of the axes its spec names, a tuple
    part counting each of its axes; a None spec keeps the whole leaf."""
    import torch

    from repro_torch.parallel.sharding import P
    mesh = Mesh(("pod", "data", "model"), (2, 4, 8))
    x = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    y = torch.empty((16,), dtype=torch.float32, device="meta")
    specs = {"a": x, "b": x, "c": y, "d": y}
    pspecs = {"a": P(("pod", "data"), "model"), "b": P(None, "data"), "c": None, "d": P()}
    assert mm.sharded_bytes(specs, pspecs, mesh) == \
        64 * 32 * 2 // 64 + 64 * 32 * 2 // 4 + 16 * 4 + 16 * 4
