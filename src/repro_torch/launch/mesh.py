"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A ``Mesh`` names its axes (``"pod"``, ``"data"``, ``"model"``), gives their
sizes, this rank's coordinates and one process group per axis (and one over
the batch axes ``("pod", "data")`` when both are there, and one over the
whole mesh). Ranks are laid out
row-major over the axes, as ``jax.make_mesh`` lays out host devices: rank =
((pod * data) + d) * model + m.

The factories build the mesh over the default process group, which the
caller initialises with the backend of its choice
(``torch.distributed.init_process_group("nccl" | "gloo", ...)``): nothing
here picks a backend. Every collective of the port's multi-rank path goes
through the mesh's methods, which is where one decision lives: a gloo group
given CUDA tensors is handed pinned host copies. gloo moves CUDA tensors
through the host in any case and refuses some collectives on them (point to
point and reduce-scatter among them), so the copy costs what gloo would and
works for every collective. An NCCL group takes the CUDA tensors as they
are.

A mesh built without a process group (``make_single_device_mesh()`` before
``init_process_group``, or ``Mesh(...)`` with no rank) still serves the
sharding rules; its collectives over axes of size 1 return their input.

``copy_to`` and ``reduce_from`` are Megatron's f and g over an axis, as
autograd functions: the identity forward with an all-reduce of the gradient
backward, and an all-reduce forward with the identity backward. ``counts``
holds, for each (collective, axes), the calls that moved data and the bytes
this rank handed them; ``reset_counts`` clears it.
"""
from __future__ import annotations

import math
from typing import Callable, ContextManager, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Axis names and sizes, and, once built over a process group, this
    rank's coordinates and the groups along its axes. ``shape`` is a dict of
    axis sizes, as ``jax.sharding.Mesh.shape`` is."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], *,
                 rank: Optional[int] = None):
        if len(axis_names) != len(sizes) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axes {axis_names} and sizes {sizes} do not match")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords: Optional[Dict[str, int]] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.counts: Dict[Tuple[str, Tuple[str, ...]], List[int]] = {}
        if rank is not None:
            self.coords = self.coords_of(rank)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    # ------------------------------------------------------------------ #
    def _build_groups(self) -> None:
        """One group per axis, one over the batch axes and one over
        ("data", "model") where both are present. ``dist.new_group`` is
        collective: every rank creates every group, in the same order, and
        keeps the ones it belongs to."""
        keys: List[Tuple[str, ...]] = [(a,) for a in self.axis_names]
        for pair in (("pod", "data"), ("data", "model")):
            if all(a in self.axis_names for a in pair):
                keys.append(pair)
        if len(self.axis_names) > 1:
            keys.append(self.axis_names)            # the whole mesh
        keys = list(dict.fromkeys(keys))
        sizes = list(self.shape.values())
        for key in keys:
            for members in _groups_along(self.axis_names, sizes, key):
                group = dist.new_group(members)
                if self.rank in members:
                    self._groups[key] = group

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` on the mesh."""
        return dict(zip(self.axis_names, _unravel(rank, self.shape.values())))

    def group(self, axes: Axes):
        """The process group of this rank along ``axes`` (None where the
        mesh has no process group)."""
        key = _axes(axes)
        if key not in self._groups and self.rank is not None:
            raise KeyError(f"the mesh has no group along {key}")
        return self._groups.get(key)

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (mixed radix, first axis major):
        its rank within ``group(axes)``."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + (self.coords[a] if self.coords else 0)
        return i

    def axes_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def _peer(self, axes: Axes, index: int) -> int:
        """The global rank at ``index`` along ``axes`` from this rank."""
        return dist.get_global_rank(self.group(axes), index)

    # ------------------------------------------------------------------ #
    # collectives; each returns its result and leaves its inputs as they are
    # ------------------------------------------------------------------ #
    def _staged(self, group, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective should see it: a pinned host copy for a
        gloo group and a CUDA tensor (see the module docstring), else ``t``."""
        if t.is_cuda and self._gloo(group):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t)
        return t

    def _scratch(self, group, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` that the collective may overwrite."""
        staged = self._staged(group, t)
        return staged.clone() if staged is t else staged

    @staticmethod
    def _gloo(group) -> bool:
        return dist.get_backend(group) == "gloo"

    @staticmethod
    def _empty(like: torch.Tensor, *shape) -> torch.Tensor:
        """An output buffer beside ``like``: pinned where ``like`` is."""
        return like.new_empty(shape, pin_memory=like.is_pinned())

    def _local(self, axes: Axes) -> bool:
        """True where the collective is the identity: no group and size 1."""
        if self.group(axes) is None:
            if self.axes_size(axes) != 1:
                raise RuntimeError(f"no process group along {_axes(axes)} of size "
                                   f"{self.axes_size(axes)}: build the mesh with "
                                   "make_host_mesh over an initialised default group")
            return True
        return False

    def _count(self, op: str, axes: Axes, nbytes: int) -> None:
        entry = self.counts.setdefault((op, _axes(axes)), [0, 0])
        entry[0] += 1
        entry[1] += nbytes

    def reset_counts(self) -> None:
        self.counts.clear()

    def all_reduce(self, x: torch.Tensor, axes: Axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self._local(axes):
            return x.clone()
        self._count("all_reduce", axes, _nbytes(x))
        g = self.group(axes)
        buf = self._scratch(g, x.contiguous())
        dist.all_reduce(buf, op=op, group=g)
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The blocks of ``axes``'s ranks joined along ``dim``, in rank order."""
        if self._local(axes):
            return x.clone()
        self._count("all_gather", axes, _nbytes(x))
        g, n = self.group(axes), self.axes_size(axes)
        src = self._staged(g, x.reshape(-1))
        out = self._empty(src, n * x.numel())       # flat: gloo joins along dim 0
        dist.all_gather_into_tensor(out, src, group=g)
        blocks = out.to(x.device).view((n,) + tuple(x.shape)).unbind(0)
        return torch.cat(blocks, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The sum over ``axes``'s ranks of ``x``, cut along ``dim`` into
        equal blocks; this rank's block."""
        if self._local(axes):
            return x.clone()
        g, n = self.group(axes), self.axes_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        self._count("reduce_scatter", axes, _nbytes(x))
        blocks = torch.stack(x.chunk(n, dim=dim))               # (n, *block)
        src = self._staged(g, blocks.view(-1))     # flat: gloo cuts along dim 0
        out = self._empty(src, blocks[0].numel())
        dist.reduce_scatter_tensor(out, src, group=g)
        return out.to(x.device).view(blocks.shape[1:])

    def broadcast(self, x: torch.Tensor, axes: Axes, src: int) -> torch.Tensor:
        """``x`` of the rank at index ``src`` along ``axes``, on every rank
        (``x`` gives the shape and dtype on the others)."""
        if self._local(axes):
            return x.clone()
        self._count("broadcast", axes, _nbytes(x))
        g = self.group(axes)
        if self.index(axes) == src:
            buf = self._scratch(g, x)
        elif x.is_cuda and self._gloo(g):       # what x holds is not read
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        else:
            buf = torch.empty_like(x)
        dist.broadcast(buf, src=self._peer(axes, src), group=g)
        return buf.to(x.device)

    def reduce(self, x: torch.Tensor, axes: Axes, dst: int) -> torch.Tensor:
        """The sum over ``axes``'s ranks of ``x``, valid on the rank at index
        ``dst`` (other ranks get a tensor of the same shape, not the sum)."""
        if self._local(axes):
            return x.clone()
        self._count("reduce", axes, _nbytes(x))
        g = self.group(axes)
        buf = self._scratch(g, x)
        dist.reduce(buf, dst=self._peer(axes, dst), group=g)
        return buf.to(x.device)

    def ring_exchange(self, tensors: Sequence[torch.Tensor], axis: str,
                      shift: int = 1) -> List[torch.Tensor]:
        """Send every tensor to the rank ``shift`` steps on along ``axis``
        and receive the same shapes from the rank ``shift`` steps back, one
        tensor at a time (a ``batch_isend_irecv`` of one send and one
        receive each), so that a gloo group's host copies hold one tensor's
        bytes at once, not the whole list's."""
        if self._local(axis):
            return [t.clone() for t in tensors]
        self._count("ring_exchange", axis, sum(_nbytes(t) for t in tensors))
        g, n, me = self.group(axis), self.shape[axis], self.index(axis)
        dst, src = self._peer(axis, (me + shift) % n), self._peer(axis, (me - shift) % n)
        out = []
        for t in tensors:
            send = self._staged(g, t.contiguous())
            recv = self._empty(send, *send.shape)
            for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, g),
                                                dist.P2POp(dist.irecv, recv, src, g)]):
                work.wait()
            out.append(recv.to(t.device))
        return out

    # ------------------------------------------------------------------ #
    # Megatron's f and g, differentiable; ``timer()`` (a context manager)
    # wraps each all-reduce, forward or backward
    # ------------------------------------------------------------------ #
    def copy_to(self, x: torch.Tensor, axes: Axes,
                timer: Callable[[], ContextManager]) -> torch.Tensor:
        """``x`` as it is; its gradient all-reduced over ``axes``: where a
        replicated activation enters a region that each rank of ``axes``
        computes on its own block."""
        return _CopyTo.apply(x, self, _axes(axes), timer)

    def reduce_from(self, x: torch.Tensor, axes: Axes,
                    timer: Callable[[], ContextManager]) -> torch.Tensor:
        """The sum of ``x`` over ``axes``; its gradient as it is: where the
        ranks' partial results of such a region become one replicated
        activation again."""
        return _ReduceFrom.apply(x, self, _axes(axes), timer)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes: Tuple[str, ...], timer):
        ctx.mesh, ctx.axes, ctx.timer = mesh, axes, timer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with ctx.timer():
            return ctx.mesh.all_reduce(g, ctx.axes), None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes: Tuple[str, ...], timer):
        with timer():
            return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def _unravel(rank: int, sizes) -> Tuple[int, ...]:
    sizes = list(sizes)
    if not 0 <= rank < math.prod(sizes):
        raise ValueError(f"rank {rank} outside a mesh of {sizes}")
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _groups_along(names: Sequence[str], sizes: Sequence[int],
                  axes: Tuple[str, ...]) -> List[List[int]]:
    """The rank sets that differ only in their coordinates along ``axes``,
    each in rank order."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for rank in range(math.prod(sizes)):
        coords = _unravel(rank, sizes)
        key = tuple(c for n, c in zip(names, coords) if n not in axes)
        groups.setdefault(key, []).append(rank)
    return [groups[k] for k in sorted(groups)]


def _host_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group(backend, init_method, world_size, rank) "
                           "first; the backend is the caller's choice")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {dict(zip(axes, shape))} needs {math.prod(shape)} "
                         f"ranks, the default group has {world}")
    mesh = Mesh(axes, shape, rank=dist.get_rank())
    mesh._build_groups()
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 ranks ("data", "model"); multi-pod: 2x16x16 =
    512 ranks ("pod", "data", "model"), over the default group, which must
    have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(f"production mesh needs {n} ranks, the default process group "
                           f"has {world}")
    return _host_mesh(shape, axes)


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 1) -> Mesh:
    """A small mesh over the default group, for tests and smoke runs: axes
    ("pod", "data", "model") when pod > 1, else ("data", "model")."""
    shape = (pod, data, model) if pod > 1 else (data, model)
    axes = ("pod", "data", "model") if pod > 1 else ("data", "model")
    return _host_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of any axes over the default group (e.g. ``(("pipe",), (4,))``
    for a pipeline), which must have exactly that many ranks."""
    return _host_mesh(tuple(shape), tuple(axes))


def make_single_device_mesh() -> Mesh:
    """A (1, 1) ("data", "model") mesh: over the default group where one of
    a single rank is initialised, else with no process group."""
    if dist.is_available() and dist.is_initialized():
        return _host_mesh((1, 1), ("data", "model"))
    return Mesh(("data", "model"), (1, 1))
