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

Tensor parallelism over "model" (the Megatron layout): ``wq``, ``wk``,
``wv``, ``w_gate``, ``w_up`` and Mamba2's head-split leaves are
column-parallel blocks, ``wo``, ``w_down`` and Mamba2's ``out`` row-parallel
ones; the embedding and the head are vocab-parallel with a distributed
cross-entropy. Which leaf is split comes from the specs
(``parallel.sharding``), the collectives from ``models.modes``.

Sequence parallelism of the residual stream (the reference's
``constrain(x, BATCH, "model", None)``): where "model" divides the
sequence (``models.modes.splits_sequence``) the residual stream between
sub-layers is a rank's block of S/tp positions. The norms and residual adds
run on it, each split sub-layer is entered by an all-gather over "model" and
left by a reduce-scatter, and the norms' gradients (``ln1``, ``ln2``,
``final_norm``) are each rank's part of the sum. Elsewhere (a sequence that
"model" does not divide) activations are replicated over "model", each
split sub-layer is entered by f (Megatron's identity, all-reduce backward)
and left by g (an all-reduce). There is no switch: this is the reference's
own rule.

The collectives over "model" of one step on a rank (``model_collectives``
counts them), with microbatches of b rows of S positions, A = b·S·D
activation bytes in the model dtype, a = A/tp, st = 4bS (one fp32 value a
position), AG / RS / AR an all-gather / reduce-scatter / all-reduce of the
bytes this rank hands it, and F = 1 where the layer bodies are recomputed
in the backward (FSDP, or a ``remat_policy`` other than "none"; else 0):

  each microbatch              sequence split           replicated (Megatron)
    the vocab-parallel         RS A; backward AG a      AR A
      embedding (a whole
      table: backward AG a)
    each split attention,      AG a, RS A; backward     AR A; backward AR A
      MLP or MoE sub-layer      AG a, RS A
    each split Mamba2 mixer    AG a, AR st, RS A;       AR st, AR A; backward
      (AR st: the mean of       backward the same       the same
      squares of its gated
      norm, every position)
    a sub-layer with whole     AG a; backward AG a      nothing
      leaves
    the recompute              F x the body's forward collectives, but a
                               body's last RS / AR where it ends in a split
                               sub-layer
    the vocab-parallel head    AG a, AR st, AR 2st;     AR st, AR 2st;
      (a whole head: AG a)      backward RS A           backward AR A
  each step
    the ``summed`` leaves'     AR, one a dtype: the     AR, one a dtype: the
      gradients (``data_mean``)  partial leaves and      partial leaves
                                the norms

F counts the recompute of each layer body in the backward, which runs
the body's forward collectives again up to the last tensor the body saves:
a body that ends in a split sub-layer does not run that sub-layer's exit
again. The AR st, AR 2st of the head are the MAX of the log-sum-exps and
the SUM of their exponentials with the label logits.

A VLM's S counts its patch positions in front of the tokens, where A and a
are the residual stream's: under sequence parallelism the embedding's RS is
of the whole [patches | tokens] sequence, the patches given by the rank at
"model" index 0 and zeros by the others. The Megatron embedding's AR A, the
head's AR st, AR 2st and its AR A count the text positions alone (the
patches are not looked up, and the loss scores the text).

An enc-dec's S is its decoder positions, and its rows are the Megatron
ones whatever S: each encoder body has two split sub-layers (attention,
MLP) whose A counts ``encoder_seq`` positions, each decoder body three
(self-attention, cross-attention, MLP) at S, and the encoder's output
enters the cross-attention regions through one f, whose backward is one AR
of the encoder's A a microbatch.

An MoE config routes the global batch (``models.moe``): the step sets
``models.modes.global_routing`` to the microbatch's global token count, and
each MoE call sums its expert counts over the batch axes (one all-reduce of
E fp32 values, again in the recompute). At model > 1 each rank holds E/tp
experts and the shared expert's blocks (expert parallelism without an
all-to-all: the layer's input is replicated over "model", gathered from the
ranks' blocks of positions under sequence parallelism), the MoE layer is
one split sub-layer above, and the router and ``shared_gate`` are
``partial`` leaves (replicated beside split ones).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.core.instant import neighbor_backup
from repro_torch.core.razor import RazorPlan, razor_plan
from repro_torch.models.modes import (FsdpLayout, GlobalRouting, Shard, TensorParallel,
                                      fsdp_unshard, global_routing, sequence_parallel,
                                      splits_sequence, tensor_parallel)
from repro_torch.models.transformer import build_model, is_decoder_stack, torch_dtype
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.compression import pod_compressed_value_and_grad
from repro_torch.parallel.sharding import is_spec
from repro_torch.train.state import StatePlan, make_state_plan
from repro_torch.tree import (STACKED_ROOTS, tree_flatten, tree_flatten_with_path,
                              tree_map, tree_unflatten)

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
    global shape and dtype, its shape after the "model" split (``local``),
    the dims that its param and opt specs shard over "data" (None where they
    do not) and the dim its specs shard over "model" (``mdim``); ``partial``
    where it is replicated over "model" in a sub-layer whose other leaves
    are split (qk-norm scales shared by every head, Mamba2's single SSD
    group read by every head), so that each rank's gradient is a part of
    the sum. ``norm`` marks a norm of the residual stream (``ln1``,
    ``ln2``, ``final_norm``) at model > 1: under sequence parallelism each
    rank applies it to its block of positions, so its gradient there is a
    part of the sum too (``summed``)."""
    names: Tuple[str, ...]       # the module's parameter names, one a layer if stacked
    stacked: bool
    shape: Tuple[int, ...]
    local: Tuple[int, ...]
    dtype: torch.dtype
    pdim: Optional[int]
    odim: Optional[int]
    mdim: Optional[int]
    partial: bool
    norm: bool

    def summed(self, sp: bool) -> bool:
        """Whether the step sums this leaf's gradient over "model", with the
        sequence split over it (``sp``) or not."""
        return self.partial or (sp and self.norm)


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


def splits_residual(cfg, tp: int, seq: int) -> bool:
    """Whether the step splits the residual stream of ``seq`` positions by
    sequence over "model": the reference's rule (``splits_sequence``) for
    the bodies that ``constrain`` it, never for an enc-dec, whose bodies
    (``_build_encdec``) have no such constraint and keep the Megatron
    layout."""
    return not cfg.encoder_layers and splits_sequence(tp, seq)


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

    On a "model" axis larger than 1 the layer bodies compute on this rank's
    blocks, with the residual stream split by sequence where "model"
    divides it (the module docstring has the layout and the collectives it
    runs), the gradients of the ``summed`` leaves (replicated in a split
    sub-layer, and the norms under sequence parallelism) are summed over
    "model" in ``data_mean``, and the global norm counts a leaf split over
    "model" on every model rank and a replicated one once.

    ``model`` gives the family and structure only: its own parameters are
    never read (the step runs a meta-device twin on the state's tensors).
    ``donate`` is the reference's buffer donation: True updates ``state``
    in place and returns it, False leaves it as it was and returns a new
    one. ``clock`` (e.g. ``time.perf_counter``) times the step's parts into
    ``step_fn.last_timing`` (seconds: "step", "grad_reduce",
    "param_gather", "tp_reduce", "backup"), synchronising the device around
    each. ``step_fn.last_grad_norm`` is the last step's global gradient
    norm (before clipping).

    Microbatch i is, as in the reference, the global rows [i·B/n,
    (i+1)·B/n), split over the batch ranks as the batch is: with more than
    one batch rank every leaf of the batch is gathered over the batch axes
    (the token ids, a few KB; a VLM's patch embeddings, num_patch_tokens·D
    values a row: 12.6 MB a row of internvl2-26b's in bf16) and each rank
    takes its block of each microbatch.

    An MoE config routes the global batch, as under the reference's jit:
    each rank routes its rows as their part of the groups of the global
    batch (the groups and the capacity from the global token count; the
    ranks that share a group gather its expert choices, ``models.moe``) and
    sums the balance loss's expert counts over the batch axes; its mean gate
    stays the rank's own, which the mean over the batch ranks makes global
    (the design ``models.moe``'s docstring states). On a "model" axis larger
    than 1 its experts are split over "model" (expert parallelism).

    An attention whose q heads split over "model" while its kv heads do not
    (``_leaf_spec`` leaves ``wk`` / ``wv`` replicated where the kv heads do
    not divide the axis) computes on each rank the kv heads of its own q
    heads (``models.attention``); ``wk``, ``wv`` and ``k_norm`` are then
    ``partial`` leaves.

    A VLM config takes ``batch["patch_embeds"]`` (this rank's rows), in
    front of the tokens: the sequence is then num_patch_tokens + S
    positions, which decide the sequence split, and under it the embedding
    reduce-scatters the whole [patches | tokens] sequence
    (``models.layers.embed_lookup``); the loss scores the S text positions.

    An enc-dec config takes ``batch["frames"]`` (this rank's rows, cut by
    rows into microbatches as the tokens are). Its residual streams stay
    whole over "model" (the Megatron layout, the reference's
    ``_build_encdec``): every sub-layer of the encoder and the decoder is a
    parallel region where its leaves are split, and the encoder's output
    enters the decoder's cross-attention regions through one f
    (``models.transformer.EncDecLM``).
    """
    cfg = model.cfg
    tp = shd.axis_size(mesh, "model")
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
    leaves = _leaves(plan, twin, mesh)
    data = shd.axis_size(mesh, "data")
    pods = shd.axis_size(mesh, "pod")
    spans = _Spans(clock)
    tp_ctx = TensorParallel(mesh, lambda: spans("tp_reduce")) if tp > 1 else None

    def local_value_and_grad(params: List[torch.Tensor], batch: Dict, sp: bool):
        """(loss, aux) of this rank's batch and the gradient of each param
        leaf: whole, or this rank's block summed over "data" where FSDP
        stores the leaf sharded (the gather's backward reduce-scatters it).
        ``sp``: the residual stream is split by sequence over "model"."""
        grads, losses, auxes = None, [], []
        for mb in _microbatches(batch, n_micro, mesh):
            layout = FsdpLayout(mesh, "data", spans) if fsdp_params else None
            aliases, names, extra = _bind(params, leaves, layout, mesh)
            with fsdp_unshard(layout) if layout else contextlib.nullcontext(), \
                    tensor_parallel(tp_ctx), sequence_parallel(sp), \
                    global_routing(_routing(cfg, mesh, mb)):
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
        """The mean over "data": each gradient onto its ZeRO block. With
        model > 1 each rank's gradient of a leaf is then the whole one for
        its "model" block, summed over "model" where:

        - a split leaf (column-, row- or vocab-parallel): nowhere, its block
          is read by this rank alone (the tied head's rows get both uses);
        - a sub-layer's leaves that are all replicated: in the backward of
          its entry (f's all-reduce, or under sequence parallelism the
          gather's reduce-scatter: every rank computes it whole);
        - ``ln1``, ``ln2`` and the final norm (the Mamba2 blocks' and the
          shared block's among them): under sequence parallelism each rank
          applies them to its positions, so they are ``summed`` here with
          the ``partial`` leaves; without it, in f's backward, which
          all-reduces the gradient of the normed input before the norm's
          backward, so each rank computes the whole gradient;
        - Mamba2's split ``norm``: its own block; the mean of squares that
          it divides by is summed forward and backward (``tp_sum``), over
          every position;
        - ``q_norm``, ``k_norm`` (each rank's heads) and Mamba2's ``w_b``,
          ``w_c``, ``conv_b``, ``conv_c`` (each rank's heads read the one
          SSD group), the ``partial`` leaves: here, one all-reduce over
          "model" per dtype, after the reduction over "data"."""
        sp = splits_residual(cfg, tp, cfg.num_patch_tokens + batch["tokens"].shape[1] - 1)
        (loss, aux), grads = local_value_and_grad(params, batch, sp)
        out = []
        with spans("grad_reduce"):
            for leaf, g in zip(leaves, grads):
                if not (fsdp_params and leaf.pdim is not None):   # else the gather's
                    g = (mesh.reduce_scatter(g, "data", leaf.odim)  # backward summed it
                         if leaf.odim is not None else mesh.all_reduce(g, "data"))
                out.append(g / data)
        if tp_ctx is not None:
            out = _sum_partial(tp_ctx, leaves, out, sp)
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

        # the global norm: every rank's blocks once, a leaf replicated over
        # "data" or "model" once (at index 0 of that axis)
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        first_model = tp == 1 or mesh.index("model") == 0
        for leaf, g in zip(leaves, grads):
            if ((leaf.odim is not None or mesh.index("data") == 0)
                    and (leaf.mdim is not None or first_model)):
                sq = sq + g.float().square().sum()
        gnorm = torch.sqrt(mesh.all_reduce(sq, ("data", "model") if tp > 1 else "data"))
        step_fn.last_grad_norm = gnorm

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
    step_fn.last_grad_norm = None
    return StepArtifacts(step_fn, plan, razor, input_pspecs, backup_pspecs)


def model_collectives(model: nn.Module, mesh, rows: int, seq: int, *,
                      fsdp_params: bool = True, microbatches: int = 1
                      ) -> Dict[Tuple[str, Tuple[str, ...]], List[int]]:
    """The collectives over "model" that one step of
    ``build_train_step(model, mesh, fsdp_params=..., microbatches=...)``
    runs on a rank whose batch is ``rows`` rows of ``seq`` positions, as
    ``Mesh.counts`` holds them: {(collective, ("model",)): [calls, bytes]}.
    The module docstring's table, with the splits of the step's specs: the
    sequence-parallel rows where ``splits_residual`` holds, else the
    Megatron rows (all-reduces only); empty at model 1. A VLM's ``seq``
    counts its patches (num_patch_tokens + S positions): the residual
    stream's A and a count them all, while the Megatron embedding's AR and
    the head's statistics (and its AR A without SP) count the S text
    positions, which alone are looked up and scored. An enc-dec's ``seq``
    is its S decoder positions: its encoder bodies' regions move
    activations of ``encoder_seq`` positions, and the f that the encoder's
    output passes before the decoder's cross-attention all-reduces such an
    activation in the backward, once a microbatch."""
    cfg = model.cfg
    tp = shd.axis_size(mesh, "model")
    if tp == 1:
        return {}
    sp = splits_residual(cfg, tp, seq)
    plan = make_state_plan(model, mesh, fsdp_params=fsdp_params)
    mdim = {path: shd.sharded_dim(spec, "model")
            for path, spec in tree_flatten_with_path(plan.param_pspecs, is_spec)}
    split = lambda *path: mdim.get(path) is not None                    # noqa: E731
    b = rows // microbatches
    width = cfg.d_model * torch_dtype(cfg).itemsize
    text = seq - cfg.num_patch_tokens                    # the positions looked up and scored
    act, act_text = b * seq * width, b * text * width
    enc_act = b * cfg.encoder_seq * width                # an enc-dec's encoder stream
    stat, stat_text = b * seq * 4, b * text * 4          # one fp32 value a position
    ag, rs, ar = ("all_gather", act // tp), ("reduce_scatter", act), "all_reduce"

    def region(mamba: bool, is_split: bool, nbytes: int):
        """A sub-layer's (forward, backward) collectives, each in order, on
        a stream of ``nbytes`` activation bytes."""
        norm = [(ar, stat)] if mamba and is_split else []     # the gated norm's tp_sum
        if sp:
            return ([ag] + norm + [rs], [ag] + norm + [rs]) if is_split else ([ag], [ag])
        return (norm + [(ar, nbytes)],) * 2 if is_split else ([], [])

    ffn = ("moe", "w_gate") if cfg.is_moe else ("mlp", "w_up")
    dense = lambda root, n=act: [(False, split(root, "attn", "wq"), n),   # noqa: E731
                                 (False, split(root, *ffn), n)]
    mamba = (True, split("blocks", "mamba", "w_x"), act)
    if is_decoder_stack(cfg):
        bodies = [dense("blocks")] * cfg.num_layers
    elif cfg.encoder_layers:
        cross = split("decoder", "cross", "wq")
        decoder = dense("decoder")
        bodies = ([dense("encoder", enc_act)] * cfg.encoder_layers
                  + [decoder[:1] + [(False, cross, act)] + decoder[1:]] * cfg.num_layers)
    else:
        bodies = [[mamba] + (dense("shared_attn") if kind == "mamba_attn" else [])
                  for kind in cfg.layer_kinds()]
    head = ("lm_head", "w") if "lm_head" in plan.param_pspecs else ("embed", "w")
    calls: List[Tuple[str, int]] = []                    # (collective, bytes) a call
    if sp:           # the embedding's sum (or a whole table's cut) and its backward
        calls += ([rs] if split("embed", "w") else []) + [ag]
    elif split("embed", "w"):
        calls.append((ar, act_text))
    for body in bodies:
        fwd: List[Tuple[str, int]] = []
        for kind, is_split, nbytes in body:
            f, bwd = region(kind, is_split, nbytes)
            fwd += f
            calls += f + bwd
        if fsdp_params or cfg.remat_policy != "none":   # the recompute stops at the
            # last tensor the body saves
            calls += fwd[:-1] if body[-1][1] else fwd
    if cfg.encoder_layers and cross:   # f's backward on the encoder's output
        calls.append((ar, enc_act))
    if sp:               # the head's gather and its backward
        calls += [ag] + ([rs] if split(*head) else [])
    if split(*head):     # the cross-entropy's statistics and, without SP, f's backward
        calls += [(ar, stat_text), (ar, 2 * stat_text)] + ([] if sp else [(ar, act_text)])
    calls *= microbatches
    per_dtype: Dict[torch.dtype, int] = {}
    data = shd.axis_size(mesh, "data")
    for leaf in _leaves(plan, _Loss(model), mesh):
        if leaf.summed(sp):
            dtype = torch.float32 if microbatches > 1 else leaf.dtype
            numel = math.prod(leaf.local) // (data if leaf.odim is not None else 1)
            per_dtype[dtype] = per_dtype.get(dtype, 0) + numel * dtype.itemsize
    calls += [(ar, n) for n in per_dtype.values()]
    out: Dict[Tuple[str, Tuple[str, ...]], List[int]] = {}
    for op, nbytes in calls:
        entry = out.setdefault((op, ("model",)), [0, 0])
        entry[0] += 1
        entry[1] += nbytes
    return out


def _routing(cfg, mesh, batch: Dict) -> Optional[GlobalRouting]:
    """An MoE's routing context for this rank's ``batch``: the global
    batch's token count (the rank's rows times the batch ranks, S = the
    S+1 tokens a row less one) over the mesh's batch axes."""
    if not cfg.is_moe:
        return None
    rows, cols = batch["tokens"].shape
    axes = shd.batch_axes(mesh)
    return GlobalRouting(mesh, axes, rows * (cols - 1) * mesh.axes_size(axes))


def _mean(mesh, axis: str, loss: torch.Tensor, aux: Dict) -> Tuple[torch.Tensor, Dict]:
    """(loss, aux) averaged over ``axis``, in one all-reduce."""
    keys = sorted(aux)
    vals = mesh.all_reduce(torch.stack([loss] + [aux[k] for k in keys]), axis)
    vals = vals / mesh.shape[axis]
    return vals[0], dict(zip(keys, vals[1:]))


_RESIDUAL_NORMS = ("ln1", "ln2", "final_norm")      # applied to the residual stream


def _leaves(plan: StatePlan, twin: nn.Module, mesh) -> List[_Leaf]:
    """The param leaves in tree order, checked against the module's names;
    a leaf is ``partial`` where its specs replicate it over "model" while a
    leaf beside it (the same path but its last key) is split: ``wk`` and
    ``wv`` beside a split ``wq`` among them, whose kv heads each rank reads
    for its own q heads only. A norm of the residual stream is ``norm``."""
    pspecs = dict(tree_flatten_with_path(plan.param_pspecs, is_spec))
    ospecs = dict(tree_flatten_with_path(plan.opt_pspecs["master"], is_spec))
    mdims = {path: shd.sharded_dim(spec, "model") for path, spec in pspecs.items()}
    tp = shd.axis_size(mesh, "model")
    out = []
    for path, spec in tree_flatten_with_path(plan.state_specs["params"]):
        stacked = path[0] in STACKED_ROOTS
        rest = ".".join(str(k) for k in path[1:])
        names = (tuple(f"{path[0]}.{i}.{rest}" for i in range(spec.shape[0])) if stacked
                 else (".".join(str(k) for k in path),))
        mdim = mdims[path]
        local = tuple(n // tp if d == mdim else n for d, n in enumerate(spec.shape))
        # replicated in a sub-layer whose other leaves are split: this rank's
        # blocks read it, so its gradient here is a part of the sum
        partial = tp > 1 and mdim is None and any(d is not None for p, d in mdims.items()
                                                  if p[:-1] == path[:-1])
        out.append(_Leaf(tuple("model." + n for n in names), stacked, tuple(spec.shape),
                         local, spec.dtype, shd.sharded_dim(pspecs[path]),
                         shd.sharded_dim(ospecs[path]), mdim, partial,
                         tp > 1 and path[-1] in _RESIDUAL_NORMS))
    module_names = {n for n, _ in twin.named_parameters()}
    bound = {n for leaf in out for n in leaf.names}
    if bound != module_names:
        raise ValueError(f"the state's leaves {sorted(bound ^ module_names)} do not "
                         "match the model's parameters")
    return out


def _sum_partial(tp: TensorParallel, leaves: List[_Leaf], grads: List[torch.Tensor],
                 sp: bool) -> List[torch.Tensor]:
    """The gradients of the leaves that each rank computes in part
    (``_Leaf.summed``, with the sequence split or not) summed over "model":
    one all-reduce per dtype, in leaf order."""
    out = list(grads)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, (leaf, g) in enumerate(zip(leaves, grads)):
        if leaf.summed(sp):
            groups.setdefault(g.dtype, []).append(i)
    for idx in groups.values():
        flat = tp.all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]))
        for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = piece.view(grads[i].shape)
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
            names[leaf.names[0]] = (layout.register(a, Shard(leaf.local, dim=leaf.pdim))
                                    if sharded else a)
            continue
        layers = a.unbind(0)
        if sharded and leaf.pdim == 0:                   # whole layers, one owner each
            per = leaf.shape[0] // mesh.shape["data"]
            first = mesh.index("data") * per
            for i, name in enumerate(leaf.names):
                shard = Shard(leaf.local[1:], owner=i // per)
                if first <= i < first + per:
                    names[name] = layout.register(layers[i - first], shard)
                else:
                    ph = torch.empty(0, dtype=a.dtype, device=a.device, requires_grad=True)
                    extra.append(ph)
                    names[name] = layout.register(ph, shard)
        else:
            for name, layer in zip(leaf.names, layers):
                names[name] = (layout.register(layer, Shard(leaf.local[1:], dim=leaf.pdim - 1))
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


def _microbatches(batch: Dict, n: int, mesh) -> List[Dict]:
    """This rank's block of each of the ``n`` microbatches of the global
    batch, whose rows the batch ranks hold in contiguous blocks: microbatch
    i is the global rows [i·B/n, (i+1)·B/n), as the reference's reshape
    makes it, and its block here the rows of this rank's index among the
    batch ranks. Every leaf (the tokens, a VLM's patch embeddings) is cut
    by its rows alike."""
    if n == 1:
        return [batch]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows of the batch do not split into {n} microbatches")
    axes = shd.batch_axes(mesh)
    b = rows // n                                  # this rank's rows of a microbatch
    per = b * mesh.axes_size(axes)                 # a microbatch's global rows
    first = mesh.index(axes) * b
    whole = {k: mesh.all_gather(v, axes, 0) for k, v in batch.items()}
    return [{k: v[i * per + first:i * per + first + b] for k, v in whole.items()}
            for i in range(n)]


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
