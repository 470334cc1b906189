"""The port's roofline analysis, report and dry-run against the JAX package.

``roofline.probes.probe_plan``, ``roofline.analyze.attention_score_bytes``,
``RooflineReport.finalize`` (the reference's run with its ``hw`` constants
set to the port's H100 figures, no file edited) and the report's tables are
held equal to the reference's. The cost count (``CostCount``) is held to a
hand count of every matmul of one analysis-mode forward per family, and
beside XLA's ``cost_analysis()`` of the reference's same forward. The
dry-run's cells run on a fake (2, 2) mesh (torch's ``"fake"`` process-group
backend, fake CPU tensors): their collectives equal the port's formulas and
their peak holds the rank's parameters.

The reference's ``repro.launch.dryrun`` is never imported here: its first
line forces 512 XLA host devices.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.models import modes as j_modes
from repro.roofline import analyze as j_analyze
from repro.roofline import hw as j_hw
from repro.roofline import report as j_report
from repro.roofline.probes import probe_plan as j_probe_plan
from repro_torch.configs import (ShapeConfig, dryrun_cells, get_arch, list_archs,
                                 reduce_for_smoke)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, modes
from repro_torch.models.moe import moe_capacity, moe_groups
from repro_torch.roofline import analyze, hw, report
from repro_torch.roofline.memory_model import sharded_bytes
from repro_torch.roofline.probes import fit, probe_plan
from repro_torch.train.serve import serve_collectives
from repro_torch.train.state import make_state_plan
from repro_torch.train.step import model_collectives

FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-7b", "vlm": "internvl2-26b", "encdec": "whisper-small"}


# ------------------------------ probes ------------------------------------ #
@pytest.mark.parametrize("arch", list_archs())
def test_probe_plan_equals_jax(arch):
    """Every registered config: the probe configs field by field, the
    features and the target equal to the reference's."""
    cfgs, feats, target = probe_plan(get_arch(arch))
    jcfgs, jfeats, jtarget = j_probe_plan(j_get_arch(arch))
    assert len(cfgs) == len(jcfgs)
    for c, jc in zip(cfgs, jcfgs):
        for f in dataclasses.fields(c):
            assert getattr(c, f.name) == getattr(jc, f.name), (arch, f.name)
    np.testing.assert_array_equal(feats, jfeats)
    np.testing.assert_array_equal(target, jtarget)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", "whisper-small"])
def test_fit_is_exact_on_an_affine_cost(arch):
    """Costs that are affine in the probes' features come back exactly at
    the target (to fp64 rounding), each key on its own; a cost that falls
    below 0 there is floored at 0."""
    _, feats, target = probe_plan(get_arch(arch))
    rng = np.random.default_rng(0)
    thetas = {k: rng.uniform(1e3, 1e9, feats.shape[1]) for k in ("flops", "bytes")}
    rows = [{k: float(f @ th) for k, th in thetas.items()} for f in feats]
    got = fit(rows, feats, target)
    for k, th in thetas.items():
        np.testing.assert_allclose(got[k], target @ th, rtol=1e-12)
    neg = fit([{"x": float(f @ -thetas["flops"])} for f in feats], feats, target)
    assert neg == {"x": 0.0}


# ------------------------------ analyze ----------------------------------- #
def test_attention_score_bytes_equals_jax_on_every_cell():
    cells = dryrun_cells(include_skips=True)
    assert len(cells) == 40
    for cfg, shape, _ in cells:
        for n in (1, 256, 512):
            assert analyze.attention_score_bytes(cfg, shape, n) == \
                j_analyze.attention_score_bytes(j_get_arch(cfg.name), shape, n), \
                (cfg.name, shape.name, n)


def _report_args(rng) -> dict:
    """Inputs drawn log-uniform over ranges wide enough for every term to
    dominate and for both fit verdicts."""
    def draw(lo, hi):
        return float(10 ** rng.uniform(lo, hi))
    return dict(arch="a", shape="s", mesh="pod16x16", n_devices=256,
                flops_per_device=draw(6, 15), hbm_bytes_per_device=draw(6, 13),
                hbm_bytes_flash_adj=draw(6, 13), hbm_bytes_model=draw(6, 13),
                collective_bytes_per_device=draw(4, 13), collective_wire_bytes=draw(4, 13),
                peak_memory_per_device=draw(10, 11.5), model_flops=draw(12, 17))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_report_finalize_equals_jax_on_the_h100_constants(monkeypatch, dtype):
    """``finalize`` of the same inputs equals the reference's, whose ``hw``
    module is given the port's figures for the run (peak FLOP/s of the
    dtype, HBM rate and size, NVLink 4 in place of its link rate): every
    field, on 40 draws that give every bottleneck and both fit verdicts."""
    monkeypatch.setattr(j_hw, "PEAK_FLOPS", hw.PEAK_FLOPS[dtype])
    monkeypatch.setattr(j_hw, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(j_hw, "ICI_LINK_BW", hw.FABRIC_LINK_BW)
    monkeypatch.setattr(j_hw, "HBM_BYTES", hw.HBM_BYTES)
    rng = np.random.default_rng(1)
    seen = set()
    for _ in range(40):
        kw = _report_args(rng)
        got = analyze.RooflineReport(**kw, dtype=dtype).finalize().to_dict()
        want = j_analyze.RooflineReport(**kw).finalize().to_dict()
        assert got.pop("dtype") == dtype
        assert got == want
        seen.add((got["bottleneck"], got["fits_hbm"]))
    assert {b for b, _ in seen} == {"compute", "memory", "collective"}
    assert {f for _, f in seen} == {True, False}


def test_collective_costs_apply_the_ring_factors():
    """``collective_costs`` from a mesh's counts: operand bytes as handed,
    the reference's ring factors for the wire, calls by kind."""
    mesh = Mesh(("data", "model"), (16, 4))
    counts = {("all_reduce", ("model",)): [3, 4000], ("all_gather", ("data",)): [2, 160],
              ("reduce_scatter", ("data",)): [1, 1600],
              ("ring_exchange", ("data",)): [1, 77],
              ("broadcast", ("data", "model")): [1, 640]}
    got = analyze.collective_costs(counts, mesh)
    assert got["bytes_by_kind"] == {"all-reduce": 4000, "all-gather": 160,
                                    "reduce-scatter": 1600, "collective-permute": 77,
                                    "broadcast": 640}
    assert got["wire_by_kind"] == {"all-reduce": 2 * 4000 * 3 // 4, "all-gather": 160 * 15,
                                   "reduce-scatter": 1600 * 15 // 16,
                                   "collective-permute": 77, "broadcast": 640 * 63 // 64}
    assert got["count_by_kind"] == {"all-reduce": 3, "all-gather": 2, "reduce-scatter": 1,
                                    "collective-permute": 1, "broadcast": 1}
    assert (got["total_bytes"], got["total_count"]) == (6477, 8)
    assert got["wire_bytes"] == sum(got["wire_by_kind"].values())


# ------------------------------ report ------------------------------------ #
def _cells(rng) -> dict:
    """JSON dicts with the reference's keys for every cell but one (left
    pending), on both meshes."""
    cells = {}
    for i, (cfg, shape, _) in enumerate(dryrun_cells()):
        for mesh in ("pod16x16", "pod2x16x16"):
            if i == 3 and mesh == "pod16x16":
                continue
            d = {"arch": cfg.name, "shape": shape.name, "mesh": mesh, "kind": shape.kind,
                 "compile_s": float(rng.uniform(0, 100)),
                 "memory_analysis": {k: int(rng.integers(0, 2**34)) for k in (
                     "argument_size_in_bytes", "output_size_in_bytes",
                     "temp_size_in_bytes")} | {"alias_size_in_bytes": 0},
                 "production_collectives": {"count_by_kind": {
                     "all-reduce": int(rng.integers(0, 300))}}}
            if mesh == "pod16x16":
                d.update(compute_s=float(rng.uniform(0, 2)), memory_s=float(rng.uniform(0, 2)),
                         collective_s=float(rng.uniform(0, 2)),
                         useful_ratio=float(rng.uniform()),
                         roofline_fraction=float(rng.uniform()),
                         peak_memory_per_device=float(rng.uniform(0, 2**37)),
                         fits_hbm=bool(rng.integers(2)))
                d["bottleneck"] = max(("compute", "memory", "collective"),
                                      key=lambda k: d[f"{k}_s"])
            cells[(mesh, cfg.name, shape.name)] = d
    return cells


def test_report_tables_equal_jax():
    """The roofline and dry-run tables equal the reference's on the same
    JSON dicts; the diagnosis table too, but for its sentences, which the
    port words for the card: each of the reference's maps to one of the
    port's (the same branch)."""
    cells = _cells(np.random.default_rng(2))
    assert report.roofline_table(cells) == j_report.roofline_table(cells)
    assert report.dryrun_table(cells) == j_report.dryrun_table(cells)
    got = report.diagnosis_table(cells).splitlines()
    want = j_report.diagnosis_table(cells).splitlines()
    assert len(got) == len(want) > 2
    mapping = {}
    for g, w in zip(got, want):
        gs, ws = g.split(" | "), w.split(" | ")
        assert gs[:-1] == ws[:-1]
        assert mapping.setdefault(ws[-1], gs[-1]) == gs[-1]
    assert len(set(mapping.values())) == len(mapping) >= 3
    assert report.summary(cells).replace(" run:", " compiled:") == j_report.summary(cells)


# ------------------------------ the cost count ---------------------------- #
def _attn_flops(cfg, b: int, sq: int, skv: int, kv_proj: int) -> int:
    """One attention sub-block: q, k, v (over ``kv_proj`` positions) and o
    projections, Q.K^T and P.V."""
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return (2 * b * sq * d * h * hd + 2 * 2 * b * kv_proj * d * k * hd
            + 2 * b * sq * h * hd * d + 2 * 2 * b * h * sq * skv * hd)


def _mlp_flops(cfg, t: int, d_ff: int) -> int:
    mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return mats * 2 * t * cfg.d_model * d_ff


def _moe_flops(cfg, t: int) -> int:
    d, e, k = cfg.d_model, cfg.padded_experts, cfg.top_k
    grp = moe_groups(t)
    slots = grp * moe_capacity(t // grp, e, k, cfg.capacity_factor)
    out = 2 * t * d * e + 3 * 2 * e * slots * d * cfg.moe_d_ff
    if cfg.num_shared_experts:
        out += 3 * 2 * t * d * cfg.shared_expert_d_ff + 2 * t * d
    return out


def _mamba_flops(cfg, b: int, s: int) -> int:
    """The projections, the output and the parallel SSD's four products."""
    d, inner, n = cfg.d_model, cfg.ssm_inner, cfg.ssm_state
    h, p, lc = cfg.ssm_heads, cfg.ssm_head_dim, min(cfg.ssm_chunk, s)
    nc = -(-s // lc)
    t = b * s
    proj = 2 * t * d * (2 * inner + 2 * n + h) + 2 * t * inner * d
    ssd = (2 * b * nc * lc * lc * n + 2 * b * nc * lc * lc * h * p
           + 2 * b * nc * n * h * p * lc + 2 * b * nc * lc * n * h * p)
    return proj + ssd


def _hand_flops(cfg, b: int, s: int) -> int:
    """Every matmul FLOP of ``model.loss``'s forward under analysis mode on
    (b, s + 1) tokens: the layers and the head over the scored positions."""
    t, v = b * s, cfg.padded_vocab
    if cfg.family in ("dense", "moe", "vlm"):
        sq = cfg.num_patch_tokens + s
        ffn = _moe_flops(cfg, b * sq) if cfg.is_moe else _mlp_flops(cfg, b * sq, cfg.d_ff)
        layer = _attn_flops(cfg, b, sq, sq, sq) + ffn
        return cfg.num_layers * layer + 2 * t * cfg.d_model * v
    if cfg.family == "encdec":
        se = cfg.encoder_seq
        enc = _attn_flops(cfg, b, se, se, se) + _mlp_flops(cfg, b * se, cfg.d_ff)
        dec = (_attn_flops(cfg, b, s, s, s) + _attn_flops(cfg, b, s, se, se)
               + _mlp_flops(cfg, t, cfg.d_ff))
        return cfg.encoder_layers * enc + cfg.num_layers * dec + 2 * t * cfg.d_model * v
    n_attn = sum(1 for kind in cfg.layer_kinds() if kind == "mamba_attn")
    shared = _attn_flops(cfg, b, s, s, s) + _mlp_flops(cfg, t, cfg.d_ff)
    return cfg.num_layers * _mamba_flops(cfg, b, s) + n_attn * shared \
        + 2 * t * cfg.d_model * v


def _smoke(arch: str):
    return (dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32"),
            dataclasses.replace(j_reduce(j_get_arch(arch)), dtype="float32"))


def _probe_batch(cfg, b: int, s: int) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = rng.standard_normal((b, cfg.num_patch_tokens, cfg.d_model),
                                                    np.float32)
    return batch


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_counted_flops_equal_a_hand_count_and_sit_below_xla(family):
    """The FLOPs that ``CostCount`` counts in one forward of ``model.loss``
    under analysis mode (2 x 24 positions at smoke width, fp32) equal the
    hand count of its matmuls exactly. XLA's ``cost_analysis()`` of the
    reference's same forward (compiled here, under its analysis mode)
    counts those products and every elementwise and transcendental op
    besides (the norms, RoPE, softmax, the SSD's decays, the MoE's routing):
    at this width (d_model 64, vocab 256) it lies between the count and
    twice it."""
    tcfg, jcfg = _smoke(FAMILIES[family])
    b, s = 2, 24
    batch = _probe_batch(tcfg, b, s)
    model = build_model(tcfg, device="cpu")
    with torch.no_grad(), modes.analysis_mode(), analyze.CostCount() as cost:
        model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert cost.flops == _hand_flops(tcfg, b, s)
    assert cost.bytes > 0
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    with j_modes.analysis_mode():
        compiled = jax.jit(lambda p, bt: jmodel.loss(p, bt)[0]).lower(
            params, {k: jnp.asarray(v) for k, v in batch.items()}).compile()
    xla = compiled.cost_analysis()
    xla = float((xla[0] if isinstance(xla, (list, tuple)) else xla)["flops"])
    assert cost.flops <= xla <= 2 * cost.flops, (cost.flops, xla)


def test_cost_count_sums_operands_and_results_and_skips_views():
    """An op's bytes are its operands' and results' bytes; a view moves none."""
    a, w = torch.ones(4, 8), torch.ones(8, 16)
    with analyze.CostCount() as cost:
        y = a @ w
        y.view(-1)
        y.transpose(0, 1)
    assert cost.flops == 2 * 4 * 8 * 16
    assert cost.bytes == (4 * 8 + 8 * 16 + 4 * 16) * 4


def test_no_data_leaves_no_fake_tensor_in_the_rope_cache():
    """``no_data()`` leaves no fake tensor in RoPE's cache: the frequencies
    that ``apply_rope`` keeps for a (head_dim, theta, device) hold data
    after it, so a real call after a dry-run in the same process still
    computes."""
    from repro_torch.models import layers
    layers._rope_frequencies_on.cache_clear()
    with analyze.no_data():
        layers.apply_rope(torch.zeros(1, 4, 2, 128), torch.arange(4), 1e4)
    out = layers.apply_rope(torch.ones(1, 4, 2, 128), torch.arange(4), 1e4)
    assert type(out) is torch.Tensor and torch.isfinite(out).all()


# ------------------------------ the dry-run ------------------------------- #
@pytest.fixture(scope="module")
def fake_mesh():
    """A (data 2, model 2) mesh over a fake process group of 4 ranks, this
    process its rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_host_mesh(data=2, model=2)
    finally:
        dist.destroy_process_group()


SMOKE_SHAPES = {"train": ShapeConfig("smoke_train", 16, 4, "train"),
                "prefill": ShapeConfig("smoke_prefill", 16, 4, "prefill"),
                "decode": ShapeConfig("smoke_decode", 16, 4, "decode")}


def _dryrun_smoke(arch: str, kind: str, mesh, monkeypatch):
    """The production step of one smoke cell on ``mesh`` (fake tensors),
    with every call of a kernel's wrapper recorded with the analysis flag it
    saw: (cfg, shape, memory_analysis, counts, flags)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32")
    shape = SMOKE_SHAPES[kind]
    if cfg.num_patch_tokens and kind != "decode":
        shape = dataclasses.replace(shape, seq_len=cfg.num_patch_tokens + 16)
    flags = []
    for name in ("flash_attention", "decode_attention", "decode_attention_partial", "ssd"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _real=real, **kw: (
            flags.append(modes.in_analysis_mode()) or _real(*a, **kw)))
    with analyze.no_data():
        step, args = dryrun.build_cell(cfg, shape, mesh)
        mesh.reset_counts()
        _, mem, _ = dryrun.peak_step(step, args)
    assert not modes.in_analysis_mode()
    return cfg, shape, mem, {k: list(v) for k, v in mesh.counts.items()}, flags


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dryrun_cell_on_a_fake_mesh(fake_mesh, monkeypatch, family, kind):
    """One smoke cell per family and kind on the fake (2, 2) mesh: the
    collectives the mesh counted over "model" equal ``model_collectives``
    (train) and all of them ``serve_collectives`` (prefill, decode); the
    peak holds at least the rank's parameter blocks; the step took the
    kernels' plain forms (the kernels' wrappers reached, never in analysis
    mode; the SSM's decode reaches none) and left analysis mode off."""
    cfg, shape, mem, counts, flags = _dryrun_smoke(FAMILIES[family], kind, fake_mesh,
                                                   monkeypatch)
    model = build_model(cfg, device="meta")
    if kind == "train":
        rows = shape.global_batch // 2
        want = model_collectives(model, fake_mesh, rows, shape.seq_len)
        got = {k: v for k, v in counts.items() if k[1] == ("model",)}
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    else:
        text = shape.seq_len - cfg.num_patch_tokens
        want = serve_collectives(model, fake_mesh, shape.global_batch, text,
                                 max_len=shape.seq_len)[kind]
        assert {k: tuple(v) for k, v in counts.items()} == \
            {k: tuple(v) for k, v in want.items()}
    plan = make_state_plan(model, fake_mesh, fsdp_params=kind == "train")
    params = sharded_bytes(plan.state_specs["params"], plan.param_pspecs, fake_mesh)
    assert dryrun.peak_bytes(mem) >= params > 0
    assert mem["argument_size_in_bytes"] >= params
    if not (cfg.family == "ssm" and kind == "decode"):      # a recurrent step, no kernel
        assert flags
    assert not any(flags)


def test_run_cell_writes_the_references_keys(fake_mesh, tmp_path):
    """``run_cell`` on the fake (2, 2) mesh, qwen3-0.6b at full width cut
    to 4 layers at a small train shape: the production step and the analysis
    probes; its JSON has every key the reference's run_cell writes and the
    report renders it."""
    shape = ShapeConfig("tiny_train", 32, 4, "train")
    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=4)
    d = dryrun.run_cell(cfg, shape, fake_mesh, "pod16x16", out_dir=tmp_path, verbose=False)
    keys = {"arch", "shape", "mesh", "kind", "n_devices", "instant_ckpt", "lower_s",
            "compile_s", "memory_analysis", "production_collectives", "probe_costs",
            "hbm_model", "analysis_compile_s", "active_params"}
    keys |= {f.name for f in dataclasses.fields(j_analyze.RooflineReport)}
    assert keys <= set(d)
    assert d["n_devices"] == 4 and d["fits_hbm"] and d["recompute"].startswith("every layer")
    assert d["production_collectives"]["count_by_kind"]["collective-permute"] == 1
    assert d["probe_costs"]["flops"] > 0 and d["flops_per_device"] == d["probe_costs"]["flops"]
    on_disk = json.loads((tmp_path / "pod16x16__qwen3-0.6b__tiny_train.json").read_text())
    assert on_disk["peak_memory_per_device"] == dryrun.peak_bytes(d["memory_analysis"])
    table = report.dryrun_table(report.load(tmp_path))
    assert "| pod16x16 | qwen3-0.6b | tiny_train |" in table
    assert not modes.in_analysis_mode()


def test_run_cell_on_a_one_card_mesh_fits_and_refuses():
    """A (1, 1) mesh needs no process group: nemotron-4-15b's decode of 8
    rows at a cache of 1,032 (bf16) fits one card; deepseek-67b's at the same
    shape (134.9 GB of bf16 parameters) does not."""
    shape = ShapeConfig("serve_decode", 1032, 8, "decode")
    mesh = Mesh(("data", "model"), (1, 1))
    fits = {}
    for arch in ("nemotron-4-15b", "deepseek-67b"):
        d = dryrun.run_cell(get_arch(arch), shape, mesh, "one", verbose=False)
        fits[arch] = d["fits_hbm"]
        assert d["production_collectives"]["total_count"] == 0
    assert fits == {"nemotron-4-15b": True, "deepseek-67b": False}


def test_deepseek_67b_cut_to_16_layers_fits_one_card():
    """deepseek-67b at full width cut to 16 of 95 layers (12,750,954,496
    parameters, 25.5 GB of bf16), the cell ``serve_deepseek`` runs on the
    card and the ``dryrun`` phase holds against its measured peak: the
    prefill of 8 x 1,000 tokens into a cache of 1,032 and the decode step
    at that cache, production steps on a (1, 1) mesh. The predicted peaks
    are pinned (the prefill's the larger: its plain attention's scores and
    the plain unembedding's fp32 copy of the head); both fit one card, as
    the whole 95 layers do not."""
    from repro_torch.models import param_count
    cfg = dataclasses.replace(get_arch("deepseek-67b"), num_layers=16)
    assert param_count(cfg) == 12_750_954_496
    mesh = Mesh(("data", "model"), (1, 1))
    peaks = {}
    for kind, shape, kw in (("prefill", ShapeConfig("serve_prefill", 1000, 8, "prefill"),
                             dict(max_len=1032)),
                            ("decode", ShapeConfig("serve_decode", 1032, 8, "decode"), {})):
        d = dryrun.run_cell(cfg, shape, mesh, "one", verbose=False, production_only=True,
                            **kw)
        mem = d["memory_analysis"]
        assert mem["argument_size_in_bytes"] >= 2 * param_count(cfg)
        assert d["production_collectives"]["total_count"] == 0
        peaks[kind] = dryrun.peak_bytes(mem)
    assert peaks == {"prefill": 33_408_638_464, "decode": 29_402_218_784}
    assert max(peaks.values()) <= hw.HBM_BYTES


@pytest.mark.parametrize("arch, layers, params, want", [
    ("llama3-8b", None, 8_030_261_248, {"prefill": 20_842_397_184, "decode": 19_248_365_856}),
    ("llama2-13b", None, 13_015_864_320,
     {"prefill": 37_378_500_096, "decode": 33_451_755_808}),
    ("llama3-70b", 16, 15_791_824_896, {"prefill": 39_490_379_264, "decode": 36_332_036_384})])
def test_the_paper_llama_serves_fit_one_card(arch, layers, params, want):
    """The paper's LLaMA serves as the card runs them (``serve_llama3_8b``,
    ``serve_llama2_13b``, ``serve_llama3_70b``: llama3-70b at full width cut
    to 16 of 80 layers), the cells the ``dryrun`` phase holds against their
    measured peaks: the prefill of 8 x 1,000 tokens into a cache of 1,032
    and the decode step at that cache, production steps on a (1, 1) mesh.
    The predicted peaks are pinned; each fits one card."""
    from repro_torch.models import param_count
    cfg = get_arch(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    assert param_count(cfg) == params
    mesh = Mesh(("data", "model"), (1, 1))
    peaks = {}
    for kind, shape, kw in (("prefill", ShapeConfig("serve_prefill", 1000, 8, "prefill"),
                             dict(max_len=1032)),
                            ("decode", ShapeConfig("serve_decode", 1032, 8, "decode"), {})):
        d = dryrun.run_cell(cfg, shape, mesh, "one", verbose=False, production_only=True,
                            **kw)
        assert dryrun.peak_bytes(d["memory_analysis"]) >= 2 * params
        peaks[kind] = dryrun.peak_bytes(d["memory_analysis"])
    assert peaks == want
    assert max(peaks.values()) <= hw.HBM_BYTES


def test_llama3_70b_at_full_depth_does_not_fit_one_card():
    """llama3-70b's 80 layers (141.1 GB of bf16 parameters) at the serves'
    decode shape: the predicted peak, pinned, is above the card's 80 GB."""
    d = dryrun.run_cell(get_arch("llama3-70b"), ShapeConfig("serve_decode", 1032, 8, "decode"),
                        Mesh(("data", "model"), (1, 1)), "one", verbose=False,
                        production_only=True)
    assert dryrun.peak_bytes(d["memory_analysis"]) == 148_020_060_448 > hw.HBM_BYTES
