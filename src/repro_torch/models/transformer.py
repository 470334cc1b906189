"""The decoder-only LM (dense, MoE or VLM), the pure SSM (Mamba2) LM, the
hybrid (Zamba2) LM and the encoder-decoder (Whisper) LM (ports of
``_build_decoder_lm``, ``_build_ssm_lm``, ``_build_hybrid_lm`` and
``_build_encdec`` in ``repro.models.transformer``): ``init``, ``forward``,
``loss``, ``prefill``, ``decode_step`` and ``cache_specs``.
An MoE config's layers hold ``moe`` (``models.moe``) where a dense one's
hold ``mlp``, and its loss adds the layers' summed balance loss. A VLM
config (``num_patch_tokens`` > 0) is the dense decoder with precomputed
patch embeddings (B, num_patch_tokens, D) in front of the prompt's token
embeddings (the ViT frontend is a stub, as in the reference): ``forward``,
``loss`` (``batch["patch_embeds"]``) and ``prefill`` take them, the loss
scores the text positions only, and the cache counts the patch positions.
The enc-dec (``EncDecLM``) takes precomputed frame embeddings (B,
encoder_seq, D) (the conv frontend is a stub, as in the reference) through
``frames`` where a VLM takes its patches.

Parameters are built frozen (``requires_grad=False``), which serving needs;
``model.requires_grad_(True)`` makes them trainable (``train.state.init_state``
does so) and changes nothing that serving computes under
``torch.inference_mode``.

Parameters mirror the reference's tree (``embed.w``, ``blocks[i].ln1``,
``blocks[i].attn.wq``, ..., ``final_norm``) with one module per layer
instead of arrays stacked on a leading layer axis. The reference's
``scan_layers`` (and the hybrid's ``lax.scan`` with ``lax.cond``) is a
Python loop over ``self.blocks`` here. Each layer body starts, as the
reference's does, with ``models.modes.unshard_layer_params``: the FSDP
gather of the sharded training step (``train.step.build_train_step``), the
identity outside it; ``constrain`` has no eager counterpart and is left out
(``parallel.constraints``). The hybrid's shared block is gathered once per
pass, before the layer loop, so its gradient is reduce-scattered once, after
all its applications have added theirs.

Under tensor parallelism (``models.modes.tensor_parallel``, the sharded
step at model > 1) the bodies compute on the blocks bound to them, in the
Megatron layout: the attention and MLP sub-layers and the Mamba2 mixer run
as ``parallel_region``s (their normed input through f, their row-parallel
output through g) where their leaves are split, an MoE layer whose experts
are split over "model" as a region of its own (``Block._moe_region``), and
the embedding and the head are vocab-parallel (``embed_lookup`` and
``chunked_xent`` given the padded vocabulary). Under the train step's
sequence parallelism (``models.modes.sequence_parallel``, where the
reference's ``constrain(x, BATCH, "model", None)`` keeps "model") the
residual stream between sub-layers is this rank's block of positions: the
embedding arrives as a block, the norms and residual adds run on it, each
region gathers its normed input and reduce-scatters its output (the MoE
layer's included, so that routing sees every position, as the reference's
``moe.py`` constrains its input back to replicated), and the final norm runs
on the block before the head gathers it (``_to_head``). ``prefill`` and
``decode_step`` run the same regions without it, for the serve steps on a
mesh (``train.serve``): there the head's logits are this rank's vocab block,
which the step gathers, and the KV caches this rank's blocks of positions
(``models.modes.split_cache``); the Mamba2 states hold this rank's heads.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import (chunked_xent, embed_init, embed_lookup,
                                       mlp_apply, mlp_init, rms_norm, sinusoidal_positions,
                                       unembed)
from repro_torch.models.modes import (bound_shape, cache_block_len, parallel_region, run_layer,
                                      seq_gather, sequence_split, tp_copy,
                                      unshard_layer_params)


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def resolve_device(device=None) -> torch.device:
    """Entry points run on CUDA unless the caller names another device; with
    no device and no GPU they raise instead of falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def _to_head(x: torch.Tensor, w: torch.Tensor, vocab: int) -> torch.Tensor:
    """The final-normed ``x`` as the head ``w`` reads it: under sequence
    parallelism every position, gathered from the ranks' blocks (the
    gradient reduce-scattered where ``w`` is this rank's vocab block, whose
    ``dx`` is a part of the sum); else ``x``."""
    return seq_gather(x, w.shape[0] != vocab) if sequence_split() else x


def _embed_inputs(embed: torch.Tensor, cfg: ArchConfig, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor] = None,
                  frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings of ``tokens`` (B, S), behind the patch
    embeddings (B, num_patch_tokens, D) cast to the model's dtype for a VLM
    config (the reference's ``_embed_inputs``): (B, num_patch_tokens + S,
    D), or under sequence parallelism this rank's block of those positions
    (``embed_lookup``'s prefix). A VLM call without them or with another
    shape, and any other config's call with them, raises ``ValueError``; so
    does a call of a model without an encoder that is given ``frames``."""
    if frames is not None and not cfg.encoder_layers:
        raise ValueError(f"{cfg.name} takes no frames (encoder_layers is 0)")
    npatch = cfg.num_patch_tokens
    if not npatch:
        if patch_embeds is not None:
            raise ValueError(f"{cfg.name} takes no patch_embeds (num_patch_tokens is 0)")
        return embed_lookup(embed, tokens, cfg.padded_vocab)
    want = (tokens.shape[0], npatch, cfg.d_model)
    if patch_embeds is None or tuple(patch_embeds.shape) != want:
        got = None if patch_embeds is None else tuple(patch_embeds.shape)
        raise ValueError(f"{cfg.name} needs patch_embeds of shape {want}, got {got}")
    return embed_lookup(embed, tokens, cfg.padded_vocab, prefix=patch_embeds)


def _attn_region(cfg: ArchConfig, a: Dict, ln: torch.Tensor, x: torch.Tensor,
                 fn) -> torch.Tensor:
    """x plus the attention sub-layer ``fn(a, normed x)`` on its leaves
    ``a``: a parallel region where ``a``'s q heads are this rank's block."""
    split = a["wq"].shape[-1] != cfg.num_heads * cfg.resolved_head_dim
    return x + parallel_region(split, lambda h: fn(a, h), rms_norm(x, ln))


def _mlp_region(cfg: ArchConfig, mlp: Dict, ln: torch.Tensor, x: torch.Tensor
                ) -> torch.Tensor:
    """x plus the dense MLP on its leaves ``mlp``: a parallel region where
    they are this rank's blocks."""
    split = mlp["w_up"].shape[-1] != cfg.d_ff
    return x + parallel_region(split, lambda h: mlp_apply(mlp, h, cfg.mlp_type),
                               rms_norm(x, ln))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _mlp_params(cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    """The MLP's leaves: ``w_up``, ``w_down`` and, for a gated MLP, ``w_gate``."""
    d = cfg.d_model
    mlp = {"w_up": _param((d, cfg.d_ff), dtype, device),
           "w_down": _param((cfg.d_ff, d), dtype, device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp["w_gate"] = _param((d, cfg.d_ff), dtype, device)
    return nn.ParameterDict(mlp)


class Block(nn.Module):
    """RMSNorm -> GQA self-attention -> residual -> RMSNorm -> MLP (the MoE
    layer for an MoE config) -> residual."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = _param((d,), dtype, device)
        self.attn = attn.attn_init(cfg, dtype, device)
        self.ln2 = _param((d,), dtype, device)
        if cfg.is_moe:
            self.moe = moe.MoEParams(cfg, dtype, device)
        else:
            self.mlp = _mlp_params(cfg, dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        attn.init_attn(self.attn, self.cfg, generator)
        if self.cfg.is_moe:
            moe.moe_init(self.moe, self.cfg, generator)
        else:
            mlp_init(generator, self.mlp, self.cfg.d_model, self.cfg.d_ff)

    def layer_params(self) -> Dict:
        """The layer's parameters as the reference's tree."""
        p = {"ln1": self.ln1, "attn": dict(self.attn.items()), "ln2": self.ln2}
        if self.cfg.is_moe:
            p["moe"] = self.moe.tree()
        else:
            p["mlp"] = dict(self.mlp.items())
        return p

    def _attn_region(self, p: Dict, x: torch.Tensor, fn) -> torch.Tensor:
        """x plus the attention sub-layer ``fn(attn leaves, normed x)``."""
        return _attn_region(self.cfg, p["attn"], p["ln1"], x, fn)

    def _ffn_region(self, p: Dict, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x plus the MLP (or MoE) sub-layer, and the MoE balance loss or None."""
        if "moe" not in p:
            return _mlp_region(self.cfg, p["mlp"], p["ln2"], x), None
        out, aux = self._moe_region(p["moe"], rms_norm(x, p["ln2"]))
        return x + out, aux

    def body(self, p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The layer on the parameters ``p`` (full tensors, or this rank's
        "model" blocks): (output, the MoE balance loss or None), as the
        reference's ``_attn_block`` returns its carry."""
        x = self._attn_region(p, x, lambda a, h: attn.self_attention(a, self.cfg, h))
        return self._ffn_region(p, x)

    def _moe_region(self, m: Dict, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The MoE layer on ``m``: with this rank's block of the experts
        (and of the shared expert's columns and rows) a region of its own,
        entered by the normed input and left by the summed routed and shared
        output (``parallel_region``); with whole leaves as at model 1. Under
        sequence parallelism it routes the gathered positions, as many
        tokens as without it."""
        cfg = self.cfg
        split = m["w_gate"].shape[0] != cfg.padded_experts
        if "shared" in m and split != (m["shared"]["w_up"].shape[-1]
                                       != cfg.shared_expert_d_ff):
            raise NotImplementedError(
                f"{cfg.name}: the routed experts and the shared expert split differently "
                "over 'model'; use a 'model' axis that divides both")
        return parallel_region(split, lambda t: moe.moe_apply(m, cfg, t), h)

    def apply_layer(self, p: Dict, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The reference's ``_attn_block``: the FSDP gather, then the layer."""
        return self.body(unshard_layer_params(p, self.cfg), x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return run_layer(self.apply_layer, self.layer_params(), x)

    def prefill(self, x, k_cache, v_cache) -> torch.Tensor:
        p = self.layer_params()
        x = self._attn_region(p, x, lambda a, h: attn.self_attention_prefill(
            a, self.cfg, h, k_cache, v_cache))
        return self._ffn_region(p, x)[0]

    def decode(self, x, k_cache, v_cache, index: int) -> torch.Tensor:
        p = self.layer_params()
        x = self._attn_region(p, x, lambda a, h: attn.self_attention_decode(
            a, self.cfg, h, k_cache, v_cache, index))
        return self._ffn_region(p, x)[0]


def _input_specs(model, shape) -> Dict:
    """The batch of a ``ShapeConfig`` as meta tensors (the reference's
    ``input_specs``): train takes S+1 tokens, prefill S, decode one token
    and the cache of ``cache_specs(B, S)``. A VLM's S counts its patches:
    train and prefill take S - num_patch_tokens (+1) tokens and the patch
    embeddings (B, num_patch_tokens, D) in the model's dtype. An enc-dec's
    train and prefill also take the frames (B, encoder_seq, D) in the
    model's dtype."""
    b, s = shape.global_batch, shape.seq_len
    npatch = model.cfg.num_patch_tokens

    def tokens(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "decode":
        return {"token": tokens(b), "cache": model.cache_specs(b, s)}
    text = s - npatch
    specs = {"tokens": tokens(b, text + 1 if shape.kind == "train" else text)}
    if npatch:
        specs["patch_embeds"] = torch.empty((b, npatch, model.cfg.d_model),
                                            dtype=model.dtype, device="meta")
    if model.cfg.encoder_layers:
        specs["frames"] = torch.empty((b, model.cfg.encoder_seq, model.cfg.d_model),
                                      dtype=model.dtype, device="meta")
    return specs


class DecoderLM(nn.Module):
    """Dense, MoE or VLM decoder LM over the padded vocabulary, tied or
    untied head."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = torch.device(device) if device is not None else resolve_device()
        dtype = dtype or torch_dtype(cfg)
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.ParameterDict({"w": _param((v, d), dtype, device)})
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _param((d,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.ParameterDict({"w": _param((v, d), dtype, device)})

    @property
    def device(self) -> torch.device:
        return self.embed["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed["w"].dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights from ``generator`` with the reference's
        distributions (N(0, 0.02) embeddings, fan-in scaled projections,
        zero norms). Returns self."""
        cfg = self.cfg
        self.embed["w"].copy_(embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                         torch.float32))
        for blk in self.blocks:
            blk.init(generator)
        self.final_norm.zero_()
        if not cfg.tie_embeddings:
            self.lm_head["w"].copy_(embed_init(generator, cfg.padded_vocab,
                                               cfg.d_model, torch.float32))
        return self

    def _head(self) -> torch.Tensor:
        return self.embed["w"] if self.cfg.tie_embeddings else self.lm_head["w"]

    def _hidden(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states of ``tokens`` (behind a VLM's
        ``patch_embeds``) as the head reads them (``_to_head``) and the
        layers' summed MoE balance loss (0 for a dense model)."""
        x = _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, lb = blk(x)
            if lb is not None:
                aux = aux + lb
        x = rms_norm(x, unshard_layer_params(self.final_norm))
        return _to_head(x, self._head(), self.cfg.padded_vocab), aux

    def forward(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tokens (B, S) -> fp32 logits (B, S, padded_vocab), causal; a
        VLM's (B, num_patch_tokens + S, padded_vocab), the patches first."""
        return unembed(self._head(), self._hidden(tokens, patch_embeds)[0])

    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Next-token loss of ``batch["tokens"]`` (B, S+1): the first S
        tokens in (a VLM's behind ``batch["patch_embeds"]``), the last S as
        labels, the tied (or untied) head through ``chunked_xent`` on the
        text positions. Returns (total, {"xent", "aux"}) with total = xent +
        0.01 * aux, as the reference; aux is the layers' summed MoE balance
        loss, 0 for a dense model."""
        tokens = batch["tokens"].long()
        x, aux = self._hidden(tokens[:, :-1], batch.get("patch_embeds"))
        # every position here, gathered under sequence parallelism: the text
        # positions are the last S of the whole sequence, not of a rank's block
        x = x[:, self.cfg.num_patch_tokens:]
        xent = chunked_xent(self._head(), x, tokens[:, 1:], vocab=self.cfg.padded_vocab)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}

    def input_specs(self, shape) -> Dict:
        return _input_specs(self, shape)

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """Shapes and dtypes of the decode cache, as meta tensors; ``index``
        is a host int."""
        kv = torch.empty((self.cfg.num_layers, batch, max_len, self.cfg.num_kv_heads,
                          self.cfg.resolved_head_dim), dtype=self.dtype, device="meta")
        return {"k": kv, "v": kv, "index": 0}

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """Causal pass over the prompts (a VLM's behind its
        ``patch_embeds``, which the positions count: S = num_patch_tokens +
        the tokens). Returns the last position's fp32 logits (B, V) and a
        cache {"k", "v": (L, B, max_len, K, hd), "index": S} whose positions
        >= S are zero; ``max_len`` is S by default. ``frames`` must be None
        (``_embed_inputs``)."""
        x = _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds, frames)
        b, s = x.shape[:2]
        max_len = s if max_len is None else max_len
        if s > max_len:
            raise ValueError(f"prompt of {s} positions exceeds max_len {max_len}")
        shape = self.cache_specs(b, cache_block_len(max_len))["k"].shape
        cache = {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}
        for i, blk in enumerate(self.blocks):
            x = blk.prefill(x, cache["k"][i], cache["v"][i])
        logits = unembed(self._head(), rms_norm(x[:, -1], self.final_norm))
        cache["index"] = s
        return logits, cache

    def decode_step(self, cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One greedy step: token (B,) at position cache["index"]. Updates
        the cache in place and returns (fp32 logits (B, V), cache)."""
        index = int(cache["index"])
        x = embed_lookup(self.embed["w"], token[:, None], self.cfg.padded_vocab)  # (B, 1, D)
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cache["k"][i], cache["v"][i], index)
        logits = unembed(self._head(), rms_norm(x[:, 0], self.final_norm))
        cache["index"] = index + 1
        return logits, cache


class MambaBlock(nn.Module):
    """RMSNorm -> Mamba2 mixer -> residual (no MLP). ``a_log``, ``d_skip``
    and ``dt_bias`` are fp32 whatever the model dtype, as in the reference."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.mamba = nn.ParameterDict({
            name: _param(shape, torch.float32 if name in mamba2.FP32_LEAVES else dtype,
                         device)
            for name, shape in mamba2.mamba_shapes(cfg).items()})

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        mamba2.mamba_init(self.mamba, self.cfg, generator)

    def layer_params(self) -> Dict:
        """The layer's parameters as the reference's tree."""
        return {"ln1": self.ln1, "mamba": dict(self.mamba.items())}

    def apply_layer(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``_mamba_block``: the FSDP gather, then the layer."""
        p = unshard_layer_params(p, self.cfg)
        return x + self._mixer_region(p, lambda m, h: mamba2.mamba_apply(m, self.cfg, h), x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_layer(self.apply_layer, self.layer_params(), x)

    def _mixer_region(self, p: Dict, fn, x: torch.Tensor):
        """``fn(mamba leaves, normed x)`` on the layer's parameters ``p``, a
        parallel region where the leaves hold this rank's heads; not yet
        added to x."""
        m = p["mamba"]
        return parallel_region(m["w_x"].shape[-1] != self.cfg.ssm_inner,
                               lambda h: fn(m, h), rms_norm(x, p["ln1"]))

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        out, state = self._mixer_region(
            self.layer_params(), lambda m, h: mamba2.mamba_prefill(m, self.cfg, h), x)
        return x + out, state

    def decode(self, x: torch.Tensor, state: Dict) -> torch.Tensor:
        out, _ = self._mixer_region(
            self.layer_params(), lambda m, h: mamba2.mamba_decode(m, self.cfg, h, state), x)
        return x + out


class MambaLM(nn.Module):
    """Pure SSM (Mamba2) LM. The head is the embedding table whatever
    ``tie_embeddings`` says, as in the reference (``_build_ssm_lm``), so
    there is no ``lm_head``. The decode cache is the per-layer conv windows
    and SSD state; ``max_len`` is accepted and ignored."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = torch.device(device) if device is not None else resolve_device()
        dtype = dtype or torch_dtype(cfg)
        self.cfg = cfg
        self.embed = nn.ParameterDict({"w": _param((cfg.padded_vocab, cfg.d_model),
                                                   dtype, device)})
        self.blocks = nn.ModuleList(MambaBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _param((cfg.d_model,), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed["w"].dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MambaLM":
        """Random weights from ``generator`` with the reference's
        distributions. Returns self."""
        cfg = self.cfg
        self.embed["w"].copy_(embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                         torch.float32))
        for blk in self.blocks:
            blk.init(generator)
        self.final_norm.zero_()
        return self

    def _normed(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` final-normed, as the head reads it (``_to_head``)."""
        x = rms_norm(x, unshard_layer_params(self.final_norm))
        return _to_head(x, self.embed["w"], self.cfg.padded_vocab)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.embed["w"], self._normed(x))

    def _hidden(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds)
        for blk in self.blocks:
            x = blk(x)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> fp32 logits (B, S, padded_vocab), causal."""
        return self._logits(self._hidden(tokens))

    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Next-token loss of ``batch["tokens"]`` (B, S+1): the first S
        tokens in, the last S as labels, the embedding as the head through
        ``chunked_xent``. Returns (total, {"xent", "aux"}) as
        ``DecoderLM.loss``; aux is 0."""
        tokens = batch["tokens"].long()
        x = self._normed(self._hidden(tokens[:, :-1], batch.get("patch_embeds")))
        xent = chunked_xent(self.embed["w"], x, tokens[:, 1:], vocab=self.cfg.padded_vocab)
        return xent, {"xent": xent,
                      "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    def input_specs(self, shape) -> Dict:
        return _input_specs(self, shape)

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """Shapes and dtypes of the decode cache, as meta tensors stacked on
        a leading layer axis; ``index`` is a host int. The state does not
        grow with ``max_len``."""
        per_layer = mamba2.mamba_state_specs(self.cfg, batch)
        return {"mamba": {name: torch.empty((self.cfg.num_layers,) + t.shape,
                                            dtype=t.dtype, device="meta")
                          for name, t in per_layer.items()},
                "index": 0}

    def _prefill_states(self, x: torch.Tensor, on_layer=None) -> Tuple[torch.Tensor, Dict]:
        """The Mamba2 stack over the prompt's embeddings: (the last layer's
        output, the per-layer decode states stacked (L, ...) as each layer
        returns them: the conv windows in the activation dtype, the SSD
        state fp32, this rank's heads on a mesh). ``on_layer(i, x)`` runs
        after layer i and returns the new x."""
        states: Optional[Dict[str, torch.Tensor]] = None
        for i, blk in enumerate(self.blocks):
            x, state = blk.prefill(x)
            if states is None:
                states = {name: t.new_empty((len(self.blocks),) + t.shape)
                          for name, t in state.items()}
            for name, t in state.items():
                states[name][i].copy_(t)
            if on_layer is not None:
                x = on_layer(i, x)
        return x, states

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """Causal pass over the prompts. Returns the last position's fp32
        logits (B, V) and the cache {"mamba": {"conv_x", "conv_b", "conv_c":
        (L, B, k-1, C) in the activation dtype, "ssm": (L, B, H, N, P) fp32},
        "index": S}. ``patch_embeds`` and ``frames`` must be None
        (``_embed_inputs``)."""
        s = tokens.shape[1]
        x, states = self._prefill_states(_embed_inputs(self.embed["w"], self.cfg, tokens,
                                                       patch_embeds, frames))
        return self._logits(x[:, -1]), {"mamba": states, "index": s}

    def decode_step(self, cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One greedy step: token (B,). Updates the cache in place and
        returns (fp32 logits (B, V), cache)."""
        x = embed_lookup(self.embed["w"], token[:, None], self.cfg.padded_vocab)
        states = cache["mamba"]
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, {name: t[i] for name, t in states.items()})
        cache["index"] = int(cache["index"]) + 1
        return self._logits(x[:, 0]), cache


class SharedAttnBlock(Block):
    """Zamba2's weight-shared attention + MLP block (``_shared_attn_block``):
    the dense ``Block`` (RMSNorm, self-attention, RMSNorm, MLP, each with its
    residual), one set of weights applied after every ``mamba_attn`` layer."""


class HybridLM(MambaLM):
    """Hybrid (Zamba2) LM: the Mamba2 stack of ``MambaLM`` with one
    ``SharedAttnBlock`` (``shared_attn``) applied after each layer that
    ``cfg.layer_kinds()`` marks ``mamba_attn``; its gradient accumulates over
    those applications. The head is the embedding whatever
    ``tie_embeddings`` says, as in the reference. The decode cache is
    {"mamba": per-layer states (L, ...), "k", "v": (n_attn, B, max_len, K,
    hd), "index"}."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__(cfg, device=device, dtype=dtype)
        self.shared_attn = SharedAttnBlock(cfg, self.dtype, self.device)
        self.attn_layers = tuple(i for i, k in enumerate(cfg.layer_kinds())
                                 if k == "mamba_attn")

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "HybridLM":
        super().init(generator)
        self.shared_attn.init(generator)
        return self

    def _mamba_attn_layer(self, blk: MambaBlock, shared: Dict, p: Dict,
                          x: torch.Tensor) -> torch.Tensor:
        """A ``mamba_attn`` layer: the Mamba2 layer, then the shared block on
        its gathered parameters ``shared``."""
        return self.shared_attn.body(shared, blk.apply_layer(p, x))[0]

    def _hidden(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds)
        shared = unshard_layer_params(self.shared_attn.layer_params(), self.cfg)
        for i, blk in enumerate(self.blocks):
            if i in self.attn_layers:
                x = run_layer(functools.partial(self._mamba_attn_layer, blk, shared),
                              blk.layer_params(), x)
            else:
                x = blk(x)
        return x

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """The Mamba2 states of ``MambaLM.cache_specs`` plus the shared
        block's KV cache, one slot per application."""
        kv = torch.empty((len(self.attn_layers), batch, max_len, self.cfg.num_kv_heads,
                          self.cfg.resolved_head_dim), dtype=self.dtype, device="meta")
        return {**super().cache_specs(batch, max_len), "k": kv, "v": kv}

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """Causal pass over the prompts. Returns the last position's fp32
        logits (B, V) and the cache of ``cache_specs``, whose KV positions
        >= S are zero, with "index": S. ``patch_embeds`` and ``frames`` must
        be None."""
        b, s = tokens.shape
        max_len = s if max_len is None else max_len
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
        shape = self.cache_specs(b, cache_block_len(max_len))["k"].shape
        kv = {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
              "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

        def shared(i: int, x: torch.Tensor) -> torch.Tensor:
            if i not in self.attn_layers:
                return x
            a = self.attn_layers.index(i)
            return self.shared_attn.prefill(x, kv["k"][a], kv["v"][a])

        x, states = self._prefill_states(
            _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds, frames), shared)
        return self._logits(x[:, -1]), {"mamba": states, **kv, "index": s}

    def decode_step(self, cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One greedy step: token (B,) at position cache["index"]. Updates
        the cache in place and returns (fp32 logits (B, V), cache)."""
        index = int(cache["index"])
        x = embed_lookup(self.embed["w"], token[:, None], self.cfg.padded_vocab)
        states = cache["mamba"]
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, {name: t[i] for name, t in states.items()})
            if i in self.attn_layers:
                a = self.attn_layers.index(i)
                x = self.shared_attn.decode(x, cache["k"][a], cache["v"][a], index)
        cache["index"] = index + 1
        return self._logits(x[:, 0]), cache


class EncDecBlock(nn.Module):
    """A layer of the enc-dec (the reference's ``_encdec_block_init`` and the
    bodies of ``_build_encdec``): RMSNorm -> self-attention -> residual ->
    [RMSNorm -> cross-attention -> residual] -> RMSNorm -> MLP -> residual.
    An encoder layer (``cross=False``) has no ``ln_cross`` / ``cross`` and
    attends non-causally without RoPE; a decoder layer's self-attention is
    causal with RoPE, as the reference's (Whisper's own decoder adds learned
    positions instead), and its cross-attention reads the encoder's k and v."""

    def __init__(self, cfg: ArchConfig, dtype, device, *, cross: bool):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = _param((d,), dtype, device)
        self.attn = attn.attn_init(cfg, dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self.mlp = _mlp_params(cfg, dtype, device)
        if cross:
            self.ln_cross = _param((d,), dtype, device)
            self.cross = attn.cross_attn_init(cfg, dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        attn.init_attn(self.attn, self.cfg, generator)
        mlp_init(generator, self.mlp, self.cfg.d_model, self.cfg.d_ff)
        if hasattr(self, "cross"):
            self.ln_cross.zero_()
            attn.init_attn(self.cross, self.cfg, generator)

    def layer_params(self) -> Dict:
        """The layer's parameters as the reference's tree."""
        p = {"ln1": self.ln1, "attn": dict(self.attn.items()), "ln2": self.ln2,
             "mlp": dict(self.mlp.items())}
        if hasattr(self, "cross"):
            p.update(ln_cross=self.ln_cross, cross=dict(self.cross.items()))
        return p

    def _attn(self, p: Dict, x: torch.Tensor, fn) -> torch.Tensor:
        return _attn_region(self.cfg, p["attn"], p["ln1"], x, fn)

    def _cross(self, p: Dict, x: torch.Tensor, fn) -> torch.Tensor:
        return _attn_region(self.cfg, p["cross"], p["ln_cross"], x, fn)

    def _mlp(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        return _mlp_region(self.cfg, p["mlp"], p["ln2"], x)

    def encode(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        """An encoder layer on the parameters ``p``."""
        cfg = self.cfg
        p = unshard_layer_params(p, cfg)
        x = self._attn(p, x, lambda a, h: attn.self_attention(a, cfg, h, causal=False,
                                                              rope=False))
        return self._mlp(p, x)

    def decode_train(self, p: Dict, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """A decoder layer on the parameters ``p`` over every position of
        ``x``, attending to the encoder's output ``enc_out`` (which enters
        the cross sub-layer's region as it is: ``EncDecLM._hidden`` puts it
        through f once for every layer)."""
        cfg = self.cfg
        p = unshard_layer_params(p, cfg)
        x = self._attn(p, x, lambda a, h: attn.self_attention(a, cfg, h, causal=True))
        x = self._cross(p, x, lambda a, h: attn.cross_attention(
            a, cfg, h, attn.cross_kv(a, cfg, enc_out)))
        return self._mlp(p, x)

    def prefill(self, x: torch.Tensor, enc_out: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor
                ) -> torch.Tensor:
        """``decode_train`` that also writes the prompt's k and v into
        ``k_cache`` / ``v_cache`` and the encoder's into ``cross_k`` /
        ``cross_v`` (each this layer's slice of the cache, or of this rank's
        blocks on a mesh), in place."""
        cfg, p = self.cfg, self.layer_params()
        x = self._attn(p, x, lambda a, h: attn.self_attention_prefill(a, cfg, h, k_cache,
                                                                      v_cache))
        x = self._cross(p, x, lambda a, h: attn.cross_prefill(a, cfg, h, enc_out, cross_k,
                                                              cross_v))
        return self._mlp(p, x)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               cross_k: torch.Tensor, cross_v: torch.Tensor, index: int) -> torch.Tensor:
        """One token at ``index``: the self cache written there, the cross
        cache only read."""
        cfg, p = self.cfg, self.layer_params()
        x = self._attn(p, x, lambda a, h: attn.self_attention_decode(a, cfg, h, k_cache,
                                                                     v_cache, index))
        x = self._cross(p, x, lambda a, h: attn.cross_attention_decode(a, cfg, h, cross_k,
                                                                       cross_v))
        return self._mlp(p, x)


class EncDecLM(nn.Module):
    """Encoder-decoder (Whisper) LM: an ``encoder`` stack over the frame
    embeddings (B, Senc, D) plus sinusoidal positions, ``enc_norm``, and a
    ``decoder`` stack over the tokens with cross-attention to the encoder's
    output, ``final_norm``. The head is the embedding table (tied, no
    ``lm_head``) whatever ``tie_embeddings`` says, as in the reference. The
    decode cache is {"k", "v": (L, B, max_len, K, hd), "cross_k",
    "cross_v": (L, B, Senc, K, hd), "index"}: the cross cache is written
    once, by the prefill, and only read after.

    Under tensor parallelism every sub-layer (the encoder's attention and
    MLP, the decoder's self-attention, cross-attention and MLP) is a
    parallel region where its leaves are split, and the residual streams
    stay whole over "model": the reference's ``_build_encdec`` bodies have
    no ``constrain``, so the train step never splits them by sequence. On a
    mesh the serve steps hold the self and cross caches as blocks of their
    own splits (``models.modes.split_cache``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = torch.device(device) if device is not None else resolve_device()
        dtype = dtype or torch_dtype(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.ParameterDict({"w": _param((cfg.padded_vocab, d), dtype, device)})
        self.encoder = nn.ModuleList(EncDecBlock(cfg, dtype, device, cross=False)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = _param((d,), dtype, device)
        self.decoder = nn.ModuleList(EncDecBlock(cfg, dtype, device, cross=True)
                                     for _ in range(cfg.num_layers))
        self.final_norm = _param((d,), dtype, device)
        # the frames' positions in the model's dtype, kept with the model (a
        # shorter clip takes the first rows: a row depends on its position only)
        self.register_buffer("positions", torch.from_numpy(sinusoidal_positions(
            cfg.encoder_seq, d)).to(device=device, dtype=dtype), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed["w"].dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights from ``generator`` with the reference's
        distributions. Returns self."""
        cfg = self.cfg
        self.embed["w"].copy_(embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                         torch.float32))
        for blk in (*self.encoder, *self.decoder):
            blk.init(generator)
        self.enc_norm.zero_()
        self.final_norm.zero_()
        return self

    def _encode(self, frames: Optional[torch.Tensor], batch: int) -> torch.Tensor:
        """The encoder over ``frames`` (batch, Senc, D): the frames and the
        positions each cast to the model's dtype, then added (the
        reference's order), the layers, ``enc_norm``. Frames missing, not of
        batch rows of width D, or of more than ``encoder_seq`` frames raise
        ``ValueError``."""
        cfg = self.cfg
        if frames is None or frames.dim() != 3 or frames.shape[0] != batch \
                or frames.shape[2] != cfg.d_model \
                or not 1 <= frames.shape[1] <= cfg.encoder_seq:
            got = None if frames is None else tuple(frames.shape)
            raise ValueError(f"{cfg.name} needs frames of shape ({batch}, Senc <= "
                             f"{cfg.encoder_seq}, {cfg.d_model}), got {got}")
        pos = self.positions
        if pos.is_meta:          # a meta twin's: the steps on a mesh bind the params only
            pos = torch.from_numpy(sinusoidal_positions(cfg.encoder_seq, cfg.d_model)).to(
                device=frames.device, dtype=self.dtype)
        x = frames.to(self.dtype) + pos[None, :frames.shape[1]]
        for blk in self.encoder:
            x = run_layer(blk.encode, blk.layer_params(), x)
        return rms_norm(x, unshard_layer_params(self.enc_norm))

    def _hidden(self, tokens: torch.Tensor, frames: Optional[torch.Tensor],
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final-normed decoder states of ``tokens`` (B, S) against the
        encoded ``frames``. Where the cross-attention's leaves are this
        rank's blocks, the encoder's output enters every decoder layer's
        region through one f: each rank's k/v blocks give its gradient a
        part of the sum, which f's backward all-reduces once for the
        decoder's every layer."""
        x = _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds)
        enc_out = self._encode(frames, tokens.shape[0])
        if self.decoder and bound_shape(self.decoder[0].cross["wq"])[-1] != \
                self.cfg.num_heads * self.cfg.resolved_head_dim:
            enc_out = tp_copy(enc_out)
        for blk in self.decoder:
            x = run_layer(blk.decode_train, blk.layer_params(), x, enc_out)
        return rms_norm(x, unshard_layer_params(self.final_norm))

    def forward(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tokens (B, S) and frames (B, Senc, D) -> fp32 logits (B, S,
        padded_vocab), causal over the tokens."""
        return unembed(self.embed["w"], self._hidden(tokens, frames))

    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Next-token loss of ``batch["tokens"]`` (B, S+1) against
        ``batch["frames"]``: the first S tokens in, the last S as labels,
        the tied head through ``chunked_xent``. Returns (xent, {"xent",
        "aux"}) with aux 0, as the reference."""
        tokens = batch["tokens"].long()
        x = self._hidden(tokens[:, :-1], batch.get("frames"), batch.get("patch_embeds"))
        xent = chunked_xent(self.embed["w"], x, tokens[:, 1:], vocab=self.cfg.padded_vocab)
        return xent, {"xent": xent,
                      "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    def input_specs(self, shape) -> Dict:
        return _input_specs(self, shape)

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """Shapes and dtypes of the decode cache, as meta tensors; the cross
        cache holds ``encoder_seq`` positions; ``index`` is a host int."""
        cfg = self.cfg
        kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim

        def kv(t: int) -> torch.Tensor:
            return torch.empty((cfg.num_layers, batch, t, kh, hd), dtype=self.dtype,
                               device="meta")

        return {"k": kv(max_len), "v": kv(max_len), "cross_k": kv(cfg.encoder_seq),
                "cross_v": kv(cfg.encoder_seq), "index": 0}

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """The encoder over ``frames`` (B, Senc, D), then the causal decoder
        pass over the prompts. Returns the last position's fp32 logits (B,
        V) and the cache of ``cache_specs`` (with Senc cross positions),
        whose self positions >= S are zero, with "index": S; ``max_len`` is
        S by default; on a mesh this rank's blocks of both caches.
        ``patch_embeds`` must be None."""
        x = _embed_inputs(self.embed["w"], self.cfg, tokens, patch_embeds)
        b, s = tokens.shape
        max_len = s if max_len is None else max_len
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
        enc_out = self._encode(frames, b)
        specs = self.cache_specs(b, cache_block_len(max_len))
        cache = {"k": torch.zeros(specs["k"].shape, dtype=self.dtype, device=self.device),
                 "v": torch.zeros(specs["v"].shape, dtype=self.dtype, device=self.device)}
        cross = ((self.cfg.num_layers, b, cache_block_len(enc_out.shape[1], cross=True))
                 + specs["cross_k"].shape[3:])
        cache.update(cross_k=torch.empty(cross, dtype=self.dtype, device=self.device),
                     cross_v=torch.empty(cross, dtype=self.dtype, device=self.device))
        for i, blk in enumerate(self.decoder):
            x = blk.prefill(x, enc_out, cache["k"][i], cache["v"][i], cache["cross_k"][i],
                            cache["cross_v"][i])
        logits = unembed(self.embed["w"], rms_norm(x[:, -1], self.final_norm))
        cache["index"] = s
        return logits, cache

    def decode_step(self, cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One greedy step: token (B,) at position cache["index"]. Updates
        the self cache in place and returns (fp32 logits (B, V), cache)."""
        index = int(cache["index"])
        x = embed_lookup(self.embed["w"], token[:, None], self.cfg.padded_vocab)
        for i, blk in enumerate(self.decoder):
            x = blk.decode(x, cache["k"][i], cache["v"][i], cache["cross_k"][i],
                           cache["cross_v"][i], index)
        logits = unembed(self.embed["w"], rms_norm(x[:, 0], self.final_norm))
        cache["index"] = index + 1
        return logits, cache


_MODELS = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM, "ssm": MambaLM,
           "hybrid": HybridLM, "encdec": EncDecLM}


def is_decoder_stack(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` builds a ``DecoderLM``: a stack of ``num_layers``
    attention + FFN blocks (dense, MoE and the VLM), as the sharded steps'
    collective counts see it."""
    return _MODELS.get(cfg.family) is DecoderLM


def build_model(cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
    """An uninitialised model of ``cfg.family`` on ``device`` (CUDA by
    default; raises when there is none), in ``dtype`` (the config's by
    default). Call ``.init(generator)`` or load weights with
    ``repro_torch.bridge.params_from_numpy``. An unknown family raises."""
    if cfg.family not in _MODELS:
        raise NotImplementedError(f"unknown family {cfg.family!r}; known: {sorted(_MODELS)}")
    return _MODELS[cfg.family](cfg, device=device, dtype=dtype)


def param_count(cfg: ArchConfig) -> int:
    model = build_model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token: for an MoE, every parameter but the
    routed experts', plus top_k routed experts a layer (the padded experts
    counted among those not touched, as the reference counts them)."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    return (total - cfg.num_layers * cfg.padded_experts * per_expert
            + cfg.num_layers * cfg.top_k * per_expert)
