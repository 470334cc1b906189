"""Serving step builders (port of ``repro.train.serve``): prefill and cached
decode, on one device or over a mesh, for any model with the serving
interface below (``DecoderLM`` with its KV cache, ``MambaLM`` with its
recurrent state, ``HybridLM`` with both, ``EncDecLM`` with its self and
cross caches).

PyTorch runs eagerly, so a step is the model's method under
``torch.inference_mode()``; there is no jit.

One device: ``build_prefill_step(model)`` and ``build_decode_step(model)``
return the step itself.

On a mesh: ``build_prefill_step(model, mesh, shape)`` and
``build_decode_step(model, mesh, shape)`` return ``(fn, plan,
input_pspecs)``, as the reference's do. ``plan`` is
``make_state_plan(model, mesh)`` (no FSDP, the reference's default), and
every rank runs ``fn`` on its blocks: the params as ``plan.param_pspecs``
splits them, its rows of the batch as ``input_pspecs`` does and its blocks
of the cache as ``parallel.sharding.cache_pspecs`` lays it out. ``model``
gives the family and structure only: the steps run a meta-device twin on
the blocks they are given. The layer bodies are the training step's
tensor-parallel regions (``models.modes``; the Megatron split, activations
replicated over "model"); the KV cache is split by sequence over "model"
(over the batch axes and "model" where the batch does not split), each rank
holding a block of positions of every kv head, and decode merges the
blocks' attention across ranks (``models.attention``); the Mamba2 state
holds this rank's heads. An enc-dec's cross cache (``encoder_seq``
positions) is split by its own rule of the same kind (its axes can differ
from the self cache's), the encoder runs the same regions as the decoder,
and its frames are split by rows as the tokens are. An MoE routes the
global batch, as under the reference's jit (``models.modes.global_routing``).
The logits come back whole: the head's vocab blocks are gathered over
"model".

The collectives of one step on a rank (``serve_collectives`` counts them),
with b rows of n positions a row (n = S in prefill, a VLM's patches
included, 1 in decode), A = b·n·D·itemsize activation bytes, H (K) q (kv)
heads, tp the "model" size, hd the head_dim, V the padded vocabulary, and
for an enc-dec Senc = encoder_seq, Aenc = b·Senc·D·itemsize:

  all_reduce over "model"                               calls    bytes
    the vocab-parallel embedding (g; a VLM's            1        A
      patches join after it: A of its tokens)
    each split attention, MLP or MoE sub-layer (g)      1        A
    each split Mamba2 mixer: g, and the mean of         2        A + 4bn
      squares of its gated norm (fp32)
    prefill: each split encoder attention or MLP (g)    1        Aenc
  all_gather over "model"
    the head's vocab blocks of the logits (fp32)        1        4b·V/tp
    each split attention's kv heads, where wk and wv    1        2b·n·(K/tp)·hd·itemsize
      are blocks (a cache holds every kv head)
    prefill: each split cross-attention's kv heads      1        2b·Senc·(K/tp)·hd·itemsize
    decode: each split attention's (a decoder layer's   1        b·(H/tp)·hd·itemsize
      self- and cross-attention's) q heads
  all_gather over the cache's sequence axes
    decode: each attention's (o, lse) in fp32, over     1        4b·H·(hd + 1)
      the self cache's axes (a cross-attention's: the
      cross cache's)
  MoE routing, where the batch splits over more than one rank
    all_reduce over the batch axes: the expert counts   1        4E
    all_gather over the batch axes: the expert          1        8b·n·top_k
      choices, where a routing group straddles ranks
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Protocol, Tuple

import torch
import torch.nn as nn

from repro_torch.models.modes import (GlobalRouting, SplitCache, TensorParallel,
                                      global_routing, split_cache, tensor_parallel)
from repro_torch.models.moe import moe_groups
from repro_torch.models.transformer import build_model, is_decoder_stack, torch_dtype
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import is_spec
from repro_torch.train.state import StatePlan, make_state_plan
from repro_torch.train.step import _leaves
from repro_torch.tree import tree_flatten, tree_flatten_with_path

Counts = Dict[Tuple[str, Tuple[str, ...]], list]


class ServingModel(Protocol):
    """What the serve steps call on a model. ``patch_embeds`` (B,
    num_patch_tokens, D) go in front of a VLM's prompt, and ``frames`` (B,
    encoder_seq, D) into an enc-dec's encoder; any other model raises if
    given them."""

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]: ...

    def decode_step(self, cache: Dict, token: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]: ...


def build_prefill_step(model: ServingModel, mesh=None, shape=None):
    """One device: prefill(tokens (B, S), max_len, patch_embeds, frames) ->
    (fp32 logits (B, V), cache); a VLM's ``patch_embeds`` (B,
    num_patch_tokens, D) go in front of the tokens, an enc-dec's ``frames``
    (B, encoder_seq, D) into its encoder. On ``mesh``: (fn, plan, input_pspecs)
    with fn(params, batch) -> (fp32 logits (b, V) of this rank's rows, this
    rank's cache blocks); batch {"tokens": this rank's rows of ``shape``'s
    prompts, "patch_embeds": a VLM's, this rank's rows, "max_len": the
    cache's length, the prompt's positions (a VLM's patches and tokens)
    where absent (the reference's ``batch.get("max_len", ...)``), "frames":
    an enc-dec's, this rank's rows}."""
    if mesh is None:
        @torch.inference_mode()
        def prefill(tokens: torch.Tensor, max_len: Optional[int] = None,
                    patch_embeds: Optional[torch.Tensor] = None,
                    frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
            return model.prefill(tokens, max_len, patch_embeds, frames)

        return prefill

    on_mesh = _OnMesh(model, mesh, "prefill")
    input_pspecs = shd.input_pspecs(model.cfg, model.input_specs(shape), mesh)
    twin = on_mesh.twin.model        # the step keeps no reference to ``model``'s weights
    npatch = model.cfg.num_patch_tokens

    @torch.inference_mode()
    def prefill_fn(params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        tokens = batch["tokens"]
        positions = npatch + tokens.shape[1]
        max_len = int(batch.get("max_len", positions))
        t_axes = _cache_axes(twin, mesh, shape.global_batch, max_len)
        return on_mesh(params, tokens.shape[0] * positions, input_pspecs["tokens"], t_axes,
                       tokens, max_len, batch.get("patch_embeds"), batch.get("frames"))

    return prefill_fn, on_mesh.plan, input_pspecs


def build_decode_step(model: ServingModel, mesh=None, shape=None):
    """One device: decode(cache, token (B,)) -> (fp32 logits (B, V), cache).
    On ``mesh``: (fn, plan, input_pspecs) with fn(params, cache, token) ->
    (fp32 logits (b, V), cache): this rank's blocks of the cache of
    ``shape`` (its length ``shape.seq_len``) and its rows of the tokens. The
    cache is updated in place and returned: the counterpart of the
    reference's ``donate_argnums=(1,)``, which lets XLA reuse the cache
    buffers; its ``index`` is a host int."""
    if mesh is None:
        @torch.inference_mode()
        def decode(cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
            return model.decode_step(cache, token)

        return decode

    on_mesh = _OnMesh(model, mesh, "decode_step")
    input_pspecs = shd.input_pspecs(model.cfg, model.input_specs(shape), mesh)
    t_axes = _cache_axes(model, mesh, shape.global_batch, shape.seq_len)

    @torch.inference_mode()
    def decode_fn(params, cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return on_mesh(params, token.shape[0], input_pspecs["token"], t_axes, cache, token)

    return decode_fn, on_mesh.plan, input_pspecs


class _Method(nn.Module):
    """A model's serving method as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model, self.name = model, name

    def forward(self, *args):
        return getattr(self.model, self.name)(*args)


class _OnMesh:
    """A serving method run on this rank's blocks: the params bound to a
    meta twin, inside the contexts of the mesh (tensor parallelism over
    "model", the cache's split, the MoE's global routing), the logits'
    vocab blocks gathered after."""

    def __init__(self, model: nn.Module, mesh, method: str):
        self.cfg, self.mesh = model.cfg, mesh
        self.plan: StatePlan = make_state_plan(model, mesh)
        self.twin = _Method(build_model(self.cfg, device="meta"), method)
        self.leaves = _leaves(self.plan, self.twin, mesh)
        tp = shd.axis_size(mesh, "model")
        self.tp = TensorParallel(mesh, contextlib.nullcontext) if tp > 1 else None

    def _routing(self, tokens: int, rows_spec) -> Optional[GlobalRouting]:
        """The MoE's routing over the global batch where the rows are
        blocks of it (else each rank routes its whole batch, as every
        rank of the reference's does)."""
        if not self.cfg.is_moe or rows_spec[0] is None:
            return None
        axes = shd.batch_axes(self.mesh)
        return GlobalRouting(self.mesh, axes, tokens * self.mesh.axes_size(axes))

    def __call__(self, params, tokens: int, rows_spec, t_axes, *args):
        """The method on ``args`` with ``params`` bound, its caches split
        over ``t_axes`` (the self cache's axes, the cross cache's)."""
        names = {}
        for t, leaf in zip(tree_flatten(params)[0], self.leaves):
            names.update(zip(leaf.names, t.unbind(0)) if leaf.stacked
                         else [(leaf.names[0], t)])
        with tensor_parallel(self.tp), split_cache(SplitCache(self.mesh, t_axes[0]),
                                                   SplitCache(self.mesh, t_axes[1])), \
                global_routing(self._routing(tokens, rows_spec)):
            logits, cache = torch.func.functional_call(self.twin, names, args)
        if logits.shape[-1] != self.cfg.padded_vocab:
            logits = self.mesh.all_gather(logits, "model", logits.dim() - 1)
        return logits, cache


def _axis_names(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _cache_axes(model, mesh, batch: int, max_len: int
                ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The axes that ``cache_pspecs`` splits the KV caches' sequence over:
    the self cache's and an enc-dec's cross cache's (none for a model
    without such a cache)."""
    specs = shd.cache_pspecs(model.cfg, model.cache_specs(batch, max_len), mesh)
    return tuple(_axis_names(specs[k][2]) if k in specs else () for k in ("k", "cross_k"))


def serve_collectives(model: nn.Module, mesh, batch: int, seq: int,
                      max_len: Optional[int] = None) -> Dict[str, Counts]:
    """The collectives one step of the mesh's serve steps runs on a rank,
    for a global batch of ``batch`` prompts of ``seq`` tokens (behind a
    VLM's num_patch_tokens patches) and a cache of ``max_len`` (the
    prompt's positions by default) positions: {"prefill": ..., "decode":
    ...}, each {(collective, axes): [calls, bytes]} as ``Mesh.counts``
    holds them, by the module docstring's table."""
    cfg = model.cfg
    npatch = cfg.num_patch_tokens
    max_len = npatch + seq if max_len is None else max_len
    tp = shd.axis_size(mesh, "model")
    plan = make_state_plan(model, mesh)
    mdim = {path: shd.sharded_dim(spec, "model")
            for path, spec in tree_flatten_with_path(plan.param_pspecs, is_spec)}
    split = lambda *path: mdim.get(path) is not None                    # noqa: E731
    tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    spec = shd.input_pspecs(cfg, {"tokens": tokens}, mesh)["tokens"]
    rows = shd.block_shape(spec, (batch, seq), mesh)[0]
    t_axes, cross_axes = _cache_axes(model, mesh, batch, max_len)
    itemsize = torch_dtype(cfg).itemsize
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    batch_axes = shd.batch_axes(mesh)
    routed_ranks = mesh.axes_size(batch_axes) if spec[0] is not None else 1
    model_axis = ("model",)

    def step(n: int, decode: bool) -> Counts:
        out: Counts = {}

        def add(op, axes, nbytes):
            entry = out.setdefault((op, tuple(axes)), [0, 0])
            entry[0] += 1
            entry[1] += nbytes

        act = rows * n * cfg.d_model * itemsize

        def attention(root, sub="attn", cached=n, axes=t_axes):
            """A cached attention sub-layer: its kv heads for the cache (the
            cross-attention's of the ``cached`` encoder positions, in prefill
            alone), decode's q heads and (o, lse), g."""
            if cached and split(root, sub, "wk"):
                add("all_gather", model_axis, 2 * rows * cached * (kh // tp) * hd * itemsize)
            if decode and split(root, sub, "wq"):
                add("all_gather", model_axis, rows * (h // tp) * hd * itemsize)
            if decode and mesh.axes_size(axes) > 1:
                add("all_gather", axes, 4 * rows * h * (hd + 1))
            if split(root, sub, "wq"):
                add("all_reduce", model_axis, act)

        def ffn(root):
            if (root, "moe", "w_gate") not in mdim:
                if split(root, "mlp", "w_up"):
                    add("all_reduce", model_axis, act)
                return
            if split(root, "moe", "w_gate"):
                add("all_reduce", model_axis, act)
            if routed_ranks > 1:
                add("all_reduce", batch_axes, 4 * cfg.padded_experts)
                total = rows * n * routed_ranks
                if (rows * n) % (total // moe_groups(total)):       # a group straddles ranks
                    add("all_gather", batch_axes, 8 * rows * n * cfg.top_k)

        if split("embed", "w"):       # the tokens' rows: a VLM's patches join after
            add("all_reduce", model_axis, rows * (1 if decode else seq) * cfg.d_model * itemsize)
        if is_decoder_stack(cfg):
            for _ in range(cfg.num_layers):
                attention("blocks")
                ffn("blocks")
        elif cfg.encoder_layers:
            if not decode:          # the encoder: the regions of its uncached attention, MLP
                enc = rows * cfg.encoder_seq * cfg.d_model * itemsize
                for path in [("encoder", "attn", "wq"), ("encoder", "mlp", "w_up")] \
                        * cfg.encoder_layers:
                    if split(*path):
                        add("all_reduce", model_axis, enc)
            for _ in range(cfg.num_layers):
                attention("decoder")
                attention("decoder", "cross", 0 if decode else cfg.encoder_seq, cross_axes)
                ffn("decoder")
        else:
            for kind in cfg.layer_kinds():
                if split("blocks", "mamba", "w_x"):
                    add("all_reduce", model_axis, 4 * rows * n)
                    add("all_reduce", model_axis, act)
                if kind == "mamba_attn":
                    attention("shared_attn")
                    ffn("shared_attn")
        head = ("lm_head", "w") if "lm_head" in plan.param_pspecs else ("embed", "w")
        if split(*head):
            add("all_gather", model_axis, 4 * rows * cfg.padded_vocab // tp)
        return out

    return {"prefill": step(npatch + seq, False), "decode": step(1, True)}
