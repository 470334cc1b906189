"""The sharded train step (port of ``repro.train.step``), and the
pure-Python per-step link-traffic accounting and replay-compute cost model,
which the simulated cluster and the recovery policies read.

``build_train_step`` returns the sharded multi-rank step over a mesh of
``torch.distributed`` ranks (``launch.mesh``):

    new_state, metrics, backup = step(state, batch)

with the paper's instant checkpoint fused in: ``backup`` is the ZeRO-unique
optimizer shard sent one hop along the DP ring (``core.instant``). ``backup``
leaves are None when instant checkpointing is disabled or the leaf is
razor-redundant. The one-device step of the simulated cluster is
``SimCluster``'s (``runtime/cluster.py``).

Optional beyond-paper feature: int8 cross-pod gradient compression
(``parallel.compression``) applied before the optimizer update.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.core.instant import neighbor_backup
from repro_torch.core.razor import RazorPlan, razor_plan
from repro_torch.models.modes import FsdpLayout, Shard, fsdp_unshard
from repro_torch.models.transformer import build_model
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.compression import pod_compressed_value_and_grad
from repro_torch.parallel.sharding import is_spec
from repro_torch.train.state import StatePlan, make_state_plan
from repro_torch.tree import (tree_flatten, tree_flatten_with_path, tree_map,
                              tree_unflatten)

PyTree = Any


@dataclass(frozen=True)
class StepArtifacts:
    step_fn: Callable
    plan: StatePlan
    razor: RazorPlan
    input_pspecs: PyTree
    backup_pspecs: PyTree        # None-leaved tree matching the backup output


@dataclass(frozen=True)
class _Leaf:
    """One param leaf of the state: where it lives in the module, its
    global shape and dtype, and the dims that its param and opt specs shard
    over "data" (None where they do not)."""
    names: Tuple[str, ...]       # the module's parameter names, one a layer if stacked
    stacked: bool
    shape: Tuple[int, ...]
    dtype: torch.dtype
    pdim: Optional[int]
    odim: Optional[int]


class _Loss(nn.Module):
    """``model.loss`` as a module's forward, for ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.loss(batch)


class _Spans:
    """Seconds spent in named parts of the last step, by ``clock`` with the
    device synchronised at both ends of each part; nothing without a clock."""

    def __init__(self, clock: Optional[Callable[[], float]]):
        self.clock = clock
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.clock is None:
            yield
            return
        sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
        sync()
        t0 = self.clock()
        try:
            yield
        finally:
            sync()
            self.totals[name] = self.totals.get(name, 0.0) + self.clock() - t0


def build_train_step(
    model: nn.Module,
    mesh,
    hp: AdamWConfig = AdamWConfig(),
    *,
    instant_ckpt: bool = True,
    backup_axis: str = "data",
    compress_pod_grads: bool = False,
    fsdp_params: bool = True,
    microbatches: int = 1,
    donate: bool = True,
    shape=None,
    clock: Optional[Callable[[], float]] = None,
) -> StepArtifacts:
    """The sharded train step of ``model``'s family on ``mesh``.

    ``step_fn(state, batch) -> (new_state, metrics, backup)`` runs on every
    rank over its own blocks: ``state`` as ``train.state.shard_init_state``
    makes it, ``batch`` this rank's rows of the global batch (its block of
    ``input_pspecs``). It computes the local loss and gradient (accumulated
    over ``microbatches``), the mean over the batch axes ("pod", "data")
    (a reduce-scatter onto the ZeRO shards, an all-reduce for leaves left
    replicated; over "pod" int8-compressed when ``compress_pod_grads`` and
    the mesh has pod > 1 and ``shape`` is given, as in the reference), the
    global gradient norm (one all-reduce; a replicated leaf counted once),
    the AdamW update of this rank's master, m and v and the cast back to
    the params (all-gathered, unless FSDP keeps them sharded), and the
    razor-unique post-update optimizer shards sent to the next rank of
    ``backup_axis`` (``backup``, when ``instant_ckpt`` and that axis has
    more than one rank). ``metrics`` holds the global mean loss, xent and
    aux and the rate, as 0-d tensors.

    ``model`` gives the family and structure only: its own parameters are
    never read (the step runs a meta-device twin on the state's tensors).
    ``donate`` is the reference's buffer donation: True updates ``state``
    in place and returns it, False leaves it as it was and returns a new
    one. ``clock`` (e.g. ``time.perf_counter``) times the step's parts into
    ``step_fn.last_timing`` (seconds: "step", "grad_reduce",
    "param_gather", "backup"), synchronising the device around each.

    A "model" axis larger than 1 raises: tensor-parallel execution is not
    ported yet (ROADMAP §1 item 9a); its specs are computed all the same. So
    does an MoE config on more than one batch rank (ROADMAP §1 item 9c):
    under the reference's jit ``moe_apply`` routes the global batch, so its
    groups, capacity (which assignments are dropped) and balance loss follow
    from the global token count, where a rank here would route its own rows.
    """
    if shd.axis_size(mesh, "model") > 1:
        raise NotImplementedError(
            "tensor-parallel execution over the 'model' axis is not ported yet "
            "(ROADMAP §1 item 9a): build the mesh with model=1")
    cfg = model.cfg
    if cfg.is_moe and shd.dp_size(mesh) > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE routing over the global batch of {shd.dp_size(mesh)} "
            "batch ranks is not ported yet (ROADMAP §1 item 9c): a rank would route "
            "its own rows, with other groups, capacity and balance loss than the "
            "reference's; build the mesh with one batch rank")
    plan = make_state_plan(model, mesh, fsdp_params=fsdp_params)
    razor = razor_plan(plan.state_specs["opt"], plan.opt_pspecs,
                       plan.state_specs["params"], mesh, zero_axis=backup_axis)

    # backup = unique opt leaves only (razor) when instant ckpt is on
    if instant_ckpt and mesh.shape.get(backup_axis, 1) > 1:
        backup_pspecs = tree_map(lambda ps, m: ps if m else None, plan.opt_pspecs,
                                 razor.unique_mask, is_leaf=is_spec)
    else:
        backup_pspecs = tree_map(lambda ps: None, plan.opt_pspecs, is_leaf=is_spec)

    input_specs = model.input_specs(shape) if shape else None
    input_pspecs = shd.input_pspecs(cfg, input_specs, mesh) if shape else None
    use_compression = (compress_pod_grads and "pod" in mesh.axis_names
                       and mesh.shape["pod"] > 1 and input_pspecs is not None)
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")
    # as in the reference, the compressed step takes no microbatches
    n_micro = 1 if use_compression else microbatches

    twin = _Loss(build_model(cfg, device="meta"))
    leaves = _leaves(plan, twin)
    data = shd.axis_size(mesh, "data")
    pods = shd.axis_size(mesh, "pod")
    spans = _Spans(clock)

    def local_value_and_grad(params: List[torch.Tensor], batch: Dict):
        """(loss, aux) of this rank's batch and the gradient of each param
        leaf: whole, or this rank's block summed over "data" where FSDP
        stores the leaf sharded (the gather's backward reduce-scatters it)."""
        grads, losses, auxes = None, [], []
        for mb in _microbatches(batch, n_micro):
            layout = FsdpLayout(mesh, "data", spans) if fsdp_params else None
            aliases, names, extra = _bind(params, leaves, layout, mesh)
            with fsdp_unshard(layout) if layout else contextlib.nullcontext():
                loss, aux = torch.func.functional_call(twin, names, (mb,))
            g = torch.autograd.grad(loss, aliases + extra)[:len(aliases)]
            if n_micro > 1:
                g = [x.float() for x in g]
                grads = g if grads is None else [a + x for a, x in zip(grads, g)]
            else:
                grads = list(g)
            losses.append(loss.detach())
            auxes.append({k: v.detach() for k, v in aux.items()})
        if n_micro > 1:
            grads = [g / n_micro for g in grads]
        loss = torch.stack(losses).mean()
        aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
        return (loss, aux), grads

    def data_mean(params, batch):
        """The mean over "data": each gradient onto its ZeRO block."""
        (loss, aux), grads = local_value_and_grad(params, batch)
        out = []
        with spans("grad_reduce"):
            for leaf, g in zip(leaves, grads):
                if not (fsdp_params and leaf.pdim is not None):   # else the gather's
                    g = (mesh.reduce_scatter(g, "data", leaf.odim)  # backward summed it
                         if leaf.odim is not None else mesh.all_reduce(g, "data"))
                out.append(g / data)
        return _mean(mesh, "data", loss, aux), out

    if use_compression:
        value_and_grad = pod_compressed_value_and_grad(data_mean, mesh)
    elif pods > 1:
        def value_and_grad(params, batch):
            (loss, aux), grads = data_mean(params, batch)
            with spans("grad_reduce"):
                grads = [mesh.all_reduce(g, "pod") / pods for g in grads]
            return _mean(mesh, "pod", loss, aux), grads
    else:
        value_and_grad = data_mean

    def train_step(state, batch):
        if input_pspecs is not None:
            _check_batch(batch, input_specs, input_pspecs, mesh)
        params, treedef = tree_flatten(state["params"])
        (loss, aux), grads = value_and_grad(params, batch)

        # the global norm: every rank's blocks once, a replicated leaf once
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for leaf, g in zip(leaves, grads):
            if leaf.odim is not None or mesh.index("data") == 0:
                sq = sq + g.float().square().sum()
        gnorm = torch.sqrt(mesh.all_reduce(sq, "data"))

        lr = cosine_schedule(state["step"], lr=hp.lr, warmup_steps=hp.warmup_steps,
                             total_steps=hp.total_steps)
        adamw_update(tree_unflatten(treedef, grads), state["opt"], state["step"], hp, lr,
                     gnorm=gnorm)
        _cast_params(state, leaves, treedef, fsdp_params, mesh, spans)
        state["step"].add_(1)

        with spans("backup"):
            backup = _mask(state["opt"], backup_pspecs)
            backup = neighbor_backup(backup, backup_pspecs, mesh, axis=backup_axis)

        metrics = {"loss": loss, **aux, "lr": lr}
        return state, metrics, backup

    def step_fn(state, batch):
        spans.totals.clear()
        if not donate:
            state = tree_map(lambda t: t.clone(), state)
        with spans("step"):
            out = train_step(state, batch)
        step_fn.last_timing = dict(spans.totals)
        return out

    step_fn.last_timing = {}
    return StepArtifacts(step_fn, plan, razor, input_pspecs, backup_pspecs)


def _mean(mesh, axis: str, loss: torch.Tensor, aux: Dict) -> Tuple[torch.Tensor, Dict]:
    """(loss, aux) averaged over ``axis``, in one all-reduce."""
    keys = sorted(aux)
    vals = mesh.all_reduce(torch.stack([loss] + [aux[k] for k in keys]), axis)
    vals = vals / mesh.shape[axis]
    return vals[0], dict(zip(keys, vals[1:]))


def _leaves(plan: StatePlan, twin: nn.Module) -> List[_Leaf]:
    """The param leaves in tree order, checked against the module's names."""
    pspecs = dict(tree_flatten_with_path(plan.param_pspecs, is_spec))
    ospecs = dict(tree_flatten_with_path(plan.opt_pspecs["master"], is_spec))
    out = []
    for path, spec in tree_flatten_with_path(plan.state_specs["params"]):
        stacked = path[0] in shd._STACKED_ROOTS
        rest = ".".join(str(k) for k in path[1:])
        names = (tuple(f"{path[0]}.{i}.{rest}" for i in range(spec.shape[0])) if stacked
                 else (".".join(str(k) for k in path),))
        out.append(_Leaf(tuple("model." + n for n in names), stacked, tuple(spec.shape),
                         spec.dtype, shd.sharded_dim(pspecs[path]),
                         shd.sharded_dim(ospecs[path])))
    module_names = {n for n, _ in twin.named_parameters()}
    bound = {n for leaf in out for n in leaf.names}
    if bound != module_names:
        raise ValueError(f"the state's leaves {sorted(bound ^ module_names)} do not "
                         "match the model's parameters")
    return out


def _bind(params: List[torch.Tensor], leaves: List[_Leaf], layout: Optional[FsdpLayout],
          mesh) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The tensors the model computes on: for each stored leaf a fresh
    alias that autograd differentiates (``aliases``), and the module's
    parameter names bound to it or, for a stack, to its layers. Under FSDP
    each sharded tensor is registered with ``layout``; a layer that another
    rank owns gets an empty placeholder (``extra``), which the backward
    must reach so that every rank's gather runs its backward collective."""
    aliases, names, extra = [], {}, []
    for t, leaf in zip(params, leaves):
        a = t.detach().requires_grad_()
        aliases.append(a)
        sharded = layout is not None and leaf.pdim is not None
        if not leaf.stacked:
            names[leaf.names[0]] = (layout.register(a, Shard(leaf.shape, dim=leaf.pdim))
                                    if sharded else a)
            continue
        layers = a.unbind(0)
        if sharded and leaf.pdim == 0:                   # whole layers, one owner each
            per = leaf.shape[0] // mesh.shape["data"]
            first = mesh.index("data") * per
            for i, name in enumerate(leaf.names):
                shard = Shard(leaf.shape[1:], owner=i // per)
                if first <= i < first + per:
                    names[name] = layout.register(layers[i - first], shard)
                else:
                    ph = torch.empty(0, dtype=a.dtype, device=a.device, requires_grad=True)
                    extra.append(ph)
                    names[name] = layout.register(ph, shard)
        else:
            for name, layer in zip(leaf.names, layers):
                names[name] = (layout.register(layer, Shard(leaf.shape[1:], dim=leaf.pdim - 1))
                               if sharded else layer)
    return aliases, names, extra


@torch.no_grad()
def _cast_params(state: Dict, leaves: List[_Leaf], treedef, fsdp: bool, mesh, spans) -> None:
    """The params from the new master: a local cast where the param and
    its master are the same block, else the master's blocks gathered."""
    params = tree_flatten(state["params"])[0]
    master = tree_flatten(state["opt"]["master"])[0]
    for p, m, leaf in zip(params, master, leaves):
        if (fsdp and leaf.pdim is not None) or leaf.odim is None:
            p.copy_(m)
        else:
            with spans("param_gather"):
                p.copy_(mesh.all_gather(m.to(p.dtype), "data", leaf.odim))


def _microbatches(batch: Dict, n: int) -> List[Dict]:
    if n == 1:
        return [batch]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows of the batch do not split into {n} microbatches")
    parts = {k: v.chunk(n, dim=0) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _check_batch(batch: Dict, input_specs: Dict, input_pspecs: Dict, mesh) -> None:
    """This rank's batch must be its block of the global batch."""
    for key, spec in input_pspecs.items():
        want = shd.block_shape(spec, tuple(input_specs[key].shape), mesh)
        if tuple(batch[key].shape) != want:
            raise ValueError(f"batch[{key!r}] has shape {tuple(batch[key].shape)}, "
                             f"this rank's block of {tuple(input_specs[key].shape)} "
                             f"is {want}")


def _mask(tree: PyTree, mask_pspecs: PyTree) -> PyTree:
    return tree_map(lambda ps, x: None if ps is None else x, mask_pspecs, tree,
                    is_leaf=is_spec)


# --------------------------------------------------------------------------- #
# Link-traffic accounting (paper §5.3): what one training iteration puts on
# the wire, per worker (all volumes in bytes). The runtime submits
# `train_bytes` as TRAIN traffic to the StateStream transport — the volume
# that preempts checkpoint chunks — while the instant-ckpt shard rides the
# fabric as STATE. On a hierarchical PodFabric the allreduce is two-level
# (intra-pod ring + inter-pod gateway ring), so the profile carries a
# per-tier wire volume.
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TrafficProfile:
    train_bytes: float   # per-ICI-edge gradient allreduce volume (preempting)
    state_bytes: float   # razor-unique instant-ckpt shard, one DP-ring hop
    dcn_bytes: float = 0.0  # per-DCN-edge inter-pod allreduce volume


def step_traffic(grad_bytes: float, dp: int,
                 razor: Optional[RazorPlan] = None,
                 state_bytes: Optional[float] = None) -> TrafficProfile:
    """Per-iteration wire volumes for one worker (flat DP ring). Ring
    allreduce moves 2(dp-1)/dp of the gradient bytes; the instant checkpoint
    moves the razor-unique optimizer shard one hop along the DP ring."""
    wire = 2.0 * (dp - 1) / dp * grad_bytes if dp > 1 else 0.0
    if state_bytes is None:
        state_bytes = float(razor.unique_bytes_per_device_ring) if razor \
            else 0.0
    return TrafficProfile(wire, state_bytes)


def hierarchical_step_traffic(grad_bytes: float, n_pods: int, pod_size: int,
                              razor: Optional[RazorPlan] = None,
                              state_bytes: Optional[float] = None
                              ) -> TrafficProfile:
    """Per-iteration wire volumes for the two-level allreduce on a
    `PodFabric` (bytes).

    Intra-pod: ring reduce-scatter + allgather over the `pod_size`-node ICI
    ring moves ``2(s-1)/s * grad_bytes`` across every ICI edge
    (`train_bytes`). Inter-pod: after the reduce-scatter each node holds a
    ``grad_bytes / s`` shard; the gateways allreduce those shards around the
    `n_pods`-pod DCN ring, putting ``2(P-1)/P * grad_bytes / s`` on every
    DCN edge (`dcn_bytes`). Degenerates to `step_traffic` shapes when
    P == 1 (no DCN leg) or s == 1 (pure DCN ring of gateways)."""
    s, p = pod_size, n_pods
    ici = 2.0 * (s - 1) / s * grad_bytes if s > 1 else 0.0
    shard = grad_bytes / max(s, 1)
    dcn = 2.0 * (p - 1) / p * shard if p > 1 else 0.0
    if state_bytes is None:
        state_bytes = float(razor.unique_bytes_per_device_ring) if razor \
            else 0.0
    return TrafficProfile(ici, state_bytes, dcn)


def artifacts_traffic(artifacts: StepArtifacts, grad_bytes: float, dp: int
                      ) -> TrafficProfile:
    """TrafficProfile for a built train step (razor plan already resolved)."""
    return step_traffic(grad_bytes, dp, razor=artifacts.razor)


# --------------------------------------------------------------------------- #
# Checkpoint-free replay-compute cost model ("All is Not Lost", PAPERS.md):
# instead of streaming a lost worker's state over the fabric, its pipeline/DP
# neighbors re-execute redundant compute to rebuild the shard from their own
# replicas — recovery then costs worker compute-seconds instead of fabric
# bytes, which is exactly the currency that stays cheap when a storm has
# darkened the cross-pod links.
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ReplayCostModel:
    """Knobs for compute-based (checkpoint-free) recovery.

    `recompute_rate` is how many bytes of lost optimizer/param state one
    replaying worker can rebuild per second of redundant compute (forward
    replay at the training step rate, amortized). `replay_overhead`
    multiplies the state volume: redundant compute interleaves with the
    replayer's own step, so rebuilding B bytes burns more than B worth of
    step time. `setup_seconds` is the fixed cost of re-materializing
    activations and swapping the replay schedule in."""
    recompute_rate: float = 2e9        # bytes of state rebuilt / s / replayer
    replay_overhead: float = 1.25      # redundant-compute amplification
    setup_seconds: float = 0.5         # schedule swap + activation re-mat


@dataclass(frozen=True)
class ReplayCost:
    """One failed worker's replay bill: `wall_seconds` is the elapsed time
    with the replayers working in parallel; `compute_seconds` is the total
    worker compute burned (the resource compute-based recovery spends
    instead of fabric bytes)."""
    wall_seconds: float
    compute_seconds: float
    bytes_rebuilt: float
    n_replayers: int


def replay_compute_cost(state_bytes: float, n_replayers: int = 2,
                        model: ReplayCostModel = ReplayCostModel()
                        ) -> ReplayCost:
    """Cost of rebuilding `state_bytes` of a lost worker's state by replaying
    redundant compute on `n_replayers` healthy neighbors. The replayers
    split the replay evenly, so wall time divides by their count while the
    total compute burned does not. Submits NO fabric traffic."""
    n = max(int(n_replayers), 1)
    burn = state_bytes * model.replay_overhead / model.recompute_rate
    wall = model.setup_seconds + burn / n
    return ReplayCost(wall_seconds=wall, compute_seconds=burn,
                      bytes_rebuilt=float(state_bytes), n_replayers=n)


def submit_step_traffic(transport, profile: TrafficProfile, t: float):
    """Put one iteration's allreduce volume on the fabric, edge by edge.

    A ring allreduce moves 2(n-1) messages of S/n bytes across EVERY ring
    edge, so the per-edge wire volume equals the per-worker volume
    (`profile.train_bytes`) — on a `TopologyTransport` this loads each live
    ring edge with exactly that, and checkpoint STATE chunks then contend
    per-edge; on a single-link transport it degrades to the global
    submission. A profile with a `dcn_bytes` leg (hierarchical allreduce)
    loads each tier with its own volume instead. Returns the submitted
    transfer(s)."""
    if profile.dcn_bytes and hasattr(transport, "submit_train_tiers"):
        from repro_torch.core.lccl import TIER_DCN, TIER_ICI
        return transport.submit_train_tiers(
            {TIER_ICI: profile.train_bytes, TIER_DCN: profile.dcn_bytes}, t)
    return transport.submit_train(profile.train_bytes, t)
