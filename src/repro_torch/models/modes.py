"""FSDP parameter storage: the layer bodies' gather (the FSDP half of
``repro.models.modes``), and the tensor-parallel context of the layer bodies.

Under FSDP a rank stores only its block of each "data"-sharded parameter
(``parallel.sharding.param_pspecs(fsdp=True)``). The reference constrains a
layer's parameters to their TP-only spec at the top of the layer body and
lets XLA insert the all-gather there; eager PyTorch inserts nothing, so
``unshard_layer_params`` is that all-gather, explicitly: a
``torch.autograd.Function`` whose forward gathers the layer's sharded leaves
into full tensors and whose backward reduce-scatters their gradients back
onto the blocks (summed over the "data" ranks).

``fsdp_unshard(layout)`` turns it on for the code it wraps; ``layout``
(an ``FsdpLayout``, built by ``train.step.build_train_step``) says how each
stored tensor becomes a full one. Outside it ``unshard_layer_params`` is the
identity, so serving is unchanged.

A layer whose stored leaves are whole layers of a stack sharded on its
layer axis (L divisible by the data size: qwen3-0.6b's 28 layers over 4
ranks give each rank 7 whole layers) is held by one rank, its *owner*; the
other ranks store an empty placeholder, the gather is a broadcast from the
owner and its backward a reduce onto the owner. A leaf sharded on a weight
dim (a stack whose L does not divide, or an unstacked leaf) is all-gathered
along that dim and reduce-scattered back.

``run_layer`` calls one layer body from a model's layer loop and honours
the config's ``remat_policy`` as the reference's ``_remat`` does around its
scan body, whenever autograd records: "none" keeps the body's activations,
"full" recomputes the body in the backward (``torch.utils.checkpoint``,
saving its inputs alone), "dots" recomputes it but for the outputs of its
2-D matmuls (``aten.mm`` / ``aten.addmm``: the projections), which a
selective-checkpoint policy saves (JAX's ``dots_with_no_batch_dims_saveable``:
a projection has no batch dim in ``dot_general``'s sense, the attention
``bmm``s have one and are recomputed). Under ``fsdp_unshard`` the body (its
gather included) is recomputed whatever the policy, so a layer's full
tensors exist only while its body runs, forward or backward: a deliberate
departure for "none" and "dots", whose saved tensors would hold the
gathered weights of every layer at once. The recompute stops at the last
tensor the backward saves (the checkpoint's early stop), so a body's final
row-parallel all-reduce is not run again.

Analysis mode (``analysis_mode``, the reference's): the layers take their
cost-exact plain forms, which every counter can see (the CUDA kernels are
``ctypes`` calls that no FLOP counter, meta or fake tensor sees into): dense
attention where a sub-block would call the flash kernel
(``models.attention``), the plain decode attention where it would call the
decode kernel, the unchunked cross-entropy (``models.layers``) and the
parallel SSD (``models.mamba2._ssd_parallel``). They do so on CPU tensors
only, real or fake (``analysis_form``): a call site that meets a CUDA
tensor under it raises, since a kernel's wrapper on the card launches its
kernel or fails. The port's layer loops are Python loops already, so there
is nothing to unroll. Only the roofline's cost count (``roofline.probes``,
on fake CPU tensors) enters it; no serve or train path does.

Tensor parallelism (the Megatron layout): the sharded step binds each
rank's blocks of the leaves that its specs split over "model", and the
layer bodies see a split leaf by its width (a local width below the
config's). ``tensor_parallel(tp)`` turns it on, over the "model" axis of
tp's mesh, for the code it wraps; ``parallel_region`` runs a sub-layer on
the local blocks between ``tp_copy`` (Megatron's f) and ``tp_reduce`` (g);
``tp_sum`` is a sum over the axis whose gradient is summed too (a statistic
over a split dim). Outside ``tensor_parallel`` nothing is split and nothing
is reduced.

Sequence parallelism of the residual stream (the reference's
``constrain(x, BATCH, "model", None)`` between sub-layers): under
``sequence_parallel(True)``, which only the train step sets and only where
``splits_sequence`` says the reference's constraint keeps "model", the
residual stream between sub-layers is this rank's block of the positions
(dim 1). The norms and residual adds run on that block; a region is entered
by ``seq_gather`` (an all-gather over "model", whose backward
reduce-scatters) and left by ``seq_scatter`` (a reduce-scatter, whose
backward all-gathers), in place of f and g. A sub-layer whose leaves are
whole is entered and left the same way without the sums: every rank
computes it alike on the gathered positions and keeps its block. The serve
steps never set it: their prefill and decode run as the reference's, whose
bodies have no such constraint.

A KV cache split by sequence: the serve steps on a mesh
(``train.serve.build_prefill_step`` / ``build_decode_step``) hold the
caches as ``parallel.sharding.cache_pspecs`` lays them out, each rank a
block of the positions of every kv head. ``split_cache(ctx, cross)`` (each
a ``SplitCache``: the mesh and the axes the sequence is split over) tells
the attention sub-blocks which block the self cache is and which block an
enc-dec's cross cache is (``models.attention``): the two can split over
different axes, the cross cache's length being the encoder's.

MoE routing over the global batch: under the reference's jit an MoE layer
routes the global batch, whose rows the sharded step splits over the batch
ranks. ``global_routing(ctx)`` (a ``GlobalRouting``: the mesh, its batch
axes and the global token count of the microbatch) tells ``models.moe``
which groups and capacity the global batch has and where to sum its
expert counts; outside it a call routes the tokens it is given.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.tree import tree_flatten, tree_unflatten

_FSDP = contextvars.ContextVar("repro_torch_fsdp_unshard", default=None)
_TP = contextvars.ContextVar("repro_torch_tensor_parallel", default=None)
_ROUTING = contextvars.ContextVar("repro_torch_global_routing", default=None)
_CACHE = contextvars.ContextVar("repro_torch_split_cache", default=None)
_CROSS_CACHE = contextvars.ContextVar("repro_torch_split_cross_cache", default=None)
_SP = contextvars.ContextVar("repro_torch_sequence_parallel", default=False)
_ANALYSIS = contextvars.ContextVar("repro_torch_analysis_mode", default=False)
REMAT_POLICIES = ("none", "full", "dots")
TP_AXIS = "model"        # the axis that ``parallel.sharding``'s specs split the bodies over


@dataclass(frozen=True)
class Shard:
    """How one stored tensor becomes its full tensor of ``shape``: by an
    all-gather of the blocks along ``dim`` (``owner`` None), or as the
    tensor that the rank at index ``owner`` of the axis holds whole."""
    shape: Tuple[int, ...]
    dim: Optional[int] = None
    owner: Optional[int] = None


class FsdpLayout:
    """The stored tensors of one step that are shards (by ``id``), the mesh
    and axis they are sharded over, and ``span(name)``, a context manager
    that times the gathers ("param_gather") and the gradients' reduce
    ("grad_reduce")."""

    def __init__(self, mesh, axis: str = "data", span: Optional[Callable] = None):
        self.mesh, self.axis = mesh, axis
        self.span = span or (lambda name: contextlib.nullcontext())
        self.shards: Dict[int, Shard] = {}
        self._alive: List[torch.Tensor] = []      # keeps each registered id valid

    def register(self, t: torch.Tensor, shard: Shard) -> torch.Tensor:
        self.shards[id(t)] = shard
        self._alive.append(t)
        return t

    # ------------------------------------------------------------------ #
    def gather(self, shards: Sequence[Shard], stored: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """The full tensors: one collective per (owner, dtype) group."""
        out: List[Optional[torch.Tensor]] = [None] * len(stored)
        for idx in _groups(shards, stored):
            owner = shards[idx[0]].owner
            if owner is not None:
                mine = self.mesh.index(self.axis) == owner
                sizes = [math.prod(shards[i].shape) for i in idx]
                flat = (torch.cat([stored[i].reshape(-1) for i in idx]) if mine else
                        stored[idx[0]].new_empty(sum(sizes)))
                flat = self.mesh.broadcast(flat, self.axis, owner)
                for i, piece in zip(idx, flat.split(sizes)):
                    out[i] = piece.view(shards[i].shape)
            else:
                n = self.mesh.shape[self.axis]
                sizes = [stored[i].numel() for i in idx]
                flat = torch.cat([stored[i].reshape(-1) for i in idx])
                every = self.mesh.all_gather(flat[None], self.axis, 0)      # (n, total)
                for i, piece in zip(idx, every.split(sizes, dim=1)):
                    blocks = piece.reshape((n,) + tuple(stored[i].shape)).unbind(0)
                    out[i] = torch.cat(blocks, dim=shards[i].dim)
        return out

    def scatter(self, shards: Sequence[Shard], stored_shapes: Sequence[torch.Size],
                grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of the stored tensors: the full gradients summed
        over the axis's ranks, each rank's block (the owner's whole tensor,
        an empty one elsewhere)."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for idx in _groups(shards, grads):
            owner = shards[idx[0]].owner
            if owner is not None:
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                flat = self.mesh.reduce(flat, self.axis, owner)
                mine = self.mesh.index(self.axis) == owner
                for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                    out[i] = (piece.view(stored_shapes[i]) if mine else
                              piece.new_zeros(stored_shapes[i]))
            else:
                n = self.mesh.shape[self.axis]
                rows = [torch.cat([grads[i].chunk(n, dim=shards[i].dim)[k].reshape(-1)
                                   for i in idx]) for k in range(n)]
                mine = self.mesh.reduce_scatter(torch.stack(rows), self.axis, 0)[0]
                for i, piece in zip(idx, mine.split([math.prod(stored_shapes[i]) for i in idx])):
                    out[i] = piece.view(stored_shapes[i])
        return out


def _groups(shards: Sequence[Shard], tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices grouped by (owner, dtype), in first-seen order: one
    collective each, the same order on every rank."""
    groups: Dict[Tuple, List[int]] = {}
    for i, (s, t) in enumerate(zip(shards, tensors)):
        groups.setdefault((s.owner, t.dtype), []).append(i)
    return list(groups.values())


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layout: FsdpLayout, shards: Tuple[Shard, ...], *stored):
        ctx.layout, ctx.shards = layout, shards
        ctx.stored_shapes = [t.shape for t in stored]
        with layout.span("param_gather"):
            return tuple(layout.gather(shards, stored))

    @staticmethod
    def backward(ctx, *grads):
        with ctx.layout.span("grad_reduce"):
            out = ctx.layout.scatter(ctx.shards, ctx.stored_shapes,
                                     [g.contiguous() for g in grads])
        return (None, None, *out)


@contextlib.contextmanager
def fsdp_unshard(layout: FsdpLayout):
    """Within it, ``unshard_layer_params`` gathers the tensors that
    ``layout`` registers as shards."""
    tok = _FSDP.set(layout)
    try:
        yield layout
    finally:
        _FSDP.reset(tok)


def unshard_layer_params(p: Any, cfg=None) -> Any:
    """Applied at the top of every layer body: the tree ``p`` with each
    registered shard replaced by its full tensor, in one autograd node for
    the whole tree (one collective per owner and dtype; the backward
    reduce-scatters once, after every use of the full tensors has added its
    gradient). The identity outside ``fsdp_unshard``. ``cfg`` is the
    reference's argument, which it needs to recompute the TP-only spec; the
    layout carries what the port needs."""
    layout = _FSDP.get()
    if layout is None:
        return p
    leaves, treedef = tree_flatten(p)
    idx = [i for i, t in enumerate(leaves)
           if isinstance(t, torch.Tensor) and id(t) in layout.shards]
    if not idx:
        return p
    full = _Unshard.apply(layout, tuple(layout.shards[id(leaves[i])] for i in idx),
                          *(leaves[i] for i in idx))
    leaves = list(leaves)
    for i, t in zip(idx, full):
        leaves[i] = t
    return tree_unflatten(treedef, leaves)


def bound_shape(t: torch.Tensor) -> torch.Size:
    """The shape of the tensor a layer body computes on for the bound
    ``t``: under ``fsdp_unshard`` a registered shard's full shape (this
    rank's "model" block of the leaf), else ``t``'s own. A decision taken
    outside the bodies (which have not gathered yet) reads the width here."""
    layout = _FSDP.get()
    if layout is not None and id(t) in layout.shards:
        return torch.Size(layout.shards[id(t)].shape)
    return t.shape


@contextlib.contextmanager
def analysis_mode(on: bool = True):
    """Within it the layers take their cost-exact plain forms (the module
    docstring lists them)."""
    tok = _ANALYSIS.set(on)
    try:
        yield
    finally:
        _ANALYSIS.reset(tok)


def in_analysis_mode() -> bool:
    return _ANALYSIS.get()


def analysis_form(t: torch.Tensor) -> bool:
    """Whether a kernel's call site takes its plain form for ``t``: under
    analysis mode, where ``t`` lies on the CPU (real or fake). Under it a
    CUDA tensor raises: on the card a call site launches its kernel."""
    if not _ANALYSIS.get():
        return False
    if t.is_cuda:
        raise RuntimeError("analysis mode on a CUDA tensor: the plain forms of the kernels "
                           "are taken on the CPU only (the cost count runs on fake CPU "
                           "tensors, roofline.analyze.no_data)")
    return True


_SAVED_BY_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" policy: save a 2-D matmul's output, recompute the rest."""
    if op.overloadpacket in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def run_layer(body: Callable, *args, remat: str = "none"):
    """``body(*args)`` under the recompute policy ``remat`` (the config's
    ``remat_policy``; the module docstring says what each does), whenever
    autograd records; under ``fsdp_unshard`` recomputed whatever ``remat``
    says. An unknown policy raises, as the reference's ``_remat``. The
    recomputation runs in the autograd engine's thread, which does not see
    this thread's context, so the layout, the tensor-parallel axis, the
    sequence parallelism, the MoE's global routing and the analysis mode go
    with it."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat}")
    layout, tp, sp, routing = _FSDP.get(), _TP.get(), _SP.get(), _ROUTING.get()
    analysis = _ANALYSIS.get()
    if not torch.is_grad_enabled() or (layout is None and remat == "none"):
        return body(*args)

    def again(*a):
        with fsdp_unshard(layout), tensor_parallel(tp), sequence_parallel(sp), \
                global_routing(routing), analysis_mode(analysis):
            return body(*a)

    if layout is None and remat == "dots":
        return checkpoint(again, *args, use_reentrant=False, context_fn=_dots_contexts)
    return checkpoint(again, *args, use_reentrant=False)


# --------------------------------------------------------------------------- #
# Tensor parallelism over "model"
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TensorParallel:
    """The mesh whose "model" axis splits the layer bodies, and ``timer()``,
    a context manager around each of its collectives (the step's
    "tp_reduce" span)."""
    mesh: Any
    timer: Callable[[], Any]

    @property
    def size(self) -> int:
        return self.mesh.shape[TP_AXIS]

    @property
    def index(self) -> int:
        return self.mesh.index(TP_AXIS)

    def all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """A plain (not differentiated) all-reduce over "model"."""
        kw = {} if op is None else {"op": op}
        with self.timer():
            return self.mesh.all_reduce(x, TP_AXIS, **kw)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The "model" ranks' blocks (not differentiated) joined along ``dim``."""
        with self.timer():
            return self.mesh.all_gather(x, TP_AXIS, dim)


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Within it, a leaf bound as its block of the "model" axis computes
    with ``tp``'s collectives; ``None`` is no tensor parallelism."""
    tok = _TP.set(tp)
    try:
        yield tp
    finally:
        _TP.reset(tok)


def current_tp() -> TensorParallel:
    """The active ``TensorParallel``: a split leaf outside one is a wrong
    binding, not a case to compute."""
    tp = _TP.get()
    if tp is None:
        raise RuntimeError("a leaf split over 'model' outside tensor_parallel(...)")
    return tp


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    tp = current_tp()
    return tp.mesh.copy_to(x, TP_AXIS, tp.timer)


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    tp = current_tp()
    return tp.mesh.reduce_from(x, TP_AXIS, tp.timer)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the axis, each rank's gradient the sum of all
    of theirs: g then f, for a statistic that every rank's block reads."""
    return tp_copy(tp_reduce(x))


def parallel_region(split: bool, fn: Callable[[torch.Tensor], Any], x: torch.Tensor) -> Any:
    """``fn(x)`` for a sub-layer whose leaves are column- then row-parallel
    blocks (``split``): x enters through f and the partial output leaves
    through g, or, under sequence parallelism, x (this rank's block of the
    positions) enters through ``seq_gather`` and the output leaves through
    ``seq_scatter``. ``fn`` returns the output, or a tuple of the output and
    what else the sub-layer keeps (a serve step's decode state, the MoE's
    balance loss), which passes as it is. A sub-layer with whole leaves runs
    as at model 1, on the gathered positions under sequence parallelism."""
    if _SP.get():
        out, leave = fn(seq_gather(x, split)), lambda t: seq_scatter(t, split)
    elif split:
        out, leave = fn(tp_copy(x)), tp_reduce
    else:
        return fn(x)
    if isinstance(out, tuple):
        return (leave(out[0]),) + out[1:]
    return leave(out)


# --------------------------------------------------------------------------- #
# Sequence parallelism of the residual stream over "model"
# --------------------------------------------------------------------------- #
def splits_sequence(tp: int, seq: int) -> bool:
    """Whether the reference's ``constrain(x, BATCH, "model", None)`` keeps
    "model" on a residual stream of ``seq`` positions: a "model" axis of
    ``tp`` > 1 that divides it (``parallel.constraints`` drops an axis that
    does not divide its dim)."""
    return tp > 1 and seq % tp == 0


@contextlib.contextmanager
def sequence_parallel(on: bool):
    """Within it (``on``, and under ``tensor_parallel``), the residual
    stream between sub-layers is this rank's block of the positions."""
    tok = _SP.set(bool(on))
    try:
        yield on
    finally:
        _SP.reset(tok)


def sequence_split() -> bool:
    """True where the residual stream is this rank's block of positions."""
    return _SP.get()


def seq_gather(x: torch.Tensor, split: bool) -> torch.Tensor:
    """Every position of ``x`` (B, S/tp, ...), gathered from the "model"
    ranks' blocks; the gradient reduce-scattered back where the reader's
    leaves are split (``split``: each rank's gradient a part), else this
    rank's block of it."""
    tp = current_tp()
    return tp.mesh.gather_to(x, TP_AXIS, 1, tp.timer, summed=split)


def seq_scatter(x: torch.Tensor, split: bool) -> torch.Tensor:
    """This rank's block of the positions of ``x`` (B, S, ...): of the sum
    over the "model" ranks where ``split`` (their partial outputs), else of
    ``x`` as every rank computed it; the gradient all-gathered."""
    tp = current_tp()
    return tp.mesh.scatter_from(x, TP_AXIS, 1, tp.timer, summed=split)


# --------------------------------------------------------------------------- #
# A KV cache split by sequence (the serve steps on a mesh)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class SplitCache:
    """The KV caches' sequence split over ``axes`` of ``mesh`` (none: the
    cache is whole on every rank): the rank at ``index`` among ``ranks``
    holds positions [index·T/ranks, (index+1)·T/ranks) of a T-long cache."""
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def ranks(self) -> int:
        return self.mesh.axes_size(self.axes)

    @property
    def index(self) -> int:
        return self.mesh.index(self.axes)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` joined along dim 0 in rank order: the blocks'
        partial attention states, for the merge."""
        return self.mesh.all_gather(x, self.axes, 0)


@contextlib.contextmanager
def split_cache(ctx: Optional[SplitCache], cross: Optional[SplitCache] = None):
    """Within it, a layer's KV cache is this rank's block of ``ctx``'s
    split and an enc-dec's cross cache its block of ``cross``'s; ``None``
    is a whole cache."""
    tok, cross_tok = _CACHE.set(ctx), _CROSS_CACHE.set(cross)
    try:
        yield ctx
    finally:
        _CROSS_CACHE.reset(cross_tok)
        _CACHE.reset(tok)


def current_split_cache(cross: bool = False) -> Optional[SplitCache]:
    """The active split of the self cache (of the cross cache where
    ``cross``), or None where that cache is whole (one rank's)."""
    ctx = (_CROSS_CACHE if cross else _CACHE).get()
    return ctx if ctx is not None and ctx.ranks > 1 else None


def cache_block_len(max_len: int, cross: bool = False) -> int:
    """The positions of a ``max_len``-long cache (the cross cache where
    ``cross``) that this rank holds."""
    ctx = current_split_cache(cross)
    if ctx is None:
        return max_len
    if max_len % ctx.ranks:
        raise ValueError(f"a cache of {max_len} positions does not split over "
                         f"{ctx.ranks} ranks of {ctx.axes}")
    return max_len // ctx.ranks


# --------------------------------------------------------------------------- #
# MoE routing over the global batch
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class GlobalRouting:
    """The batch of which this rank's rows are a block: ``tokens`` tokens in
    all (a microbatch's), split in contiguous row blocks over ``axes`` (the
    batch axes) of ``mesh``."""
    mesh: Any
    axes: Tuple[str, ...]
    tokens: int

    @property
    def ranks(self) -> int:
        return self.mesh.axes_size(self.axes)

    @property
    def index(self) -> int:
        """This rank's index among the batch ranks: the block of rows it holds."""
        return self.mesh.index(self.axes)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A plain (not differentiated) sum over the batch ranks."""
        return self.mesh.all_reduce(x, self.axes)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The batch ranks' ``x`` (not differentiated) joined along dim 0 in
        rank order: the global batch's rows."""
        return self.mesh.all_gather(x, self.axes, 0)


@contextlib.contextmanager
def global_routing(ctx: Optional[GlobalRouting]):
    """Within it, an MoE layer routes as a part of ``ctx``'s batch; ``None``
    routes the tokens of each call alone."""
    tok = _ROUTING.set(ctx)
    try:
        yield ctx
    finally:
        _ROUTING.reset(tok)


def current_routing() -> Optional[GlobalRouting]:
    return _ROUTING.get()
