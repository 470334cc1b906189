"""Mixture-of-Experts: top-k router with capacity-bounded index dispatch
(port of ``repro.models.moe``).

Tokens are split into G groups; within a group each token's top-k experts
get positions from a stable sort, an (G, E, C) token-index table is built
with a scatter, the tokens are gathered into a (G, E, C, D) buffer, the
expert SwiGLU runs as batched matrix products over the experts, and a
weighted gather combines the outputs back to the tokens. Assignments past
an expert's capacity C are dropped (GShard semantics, capacity_factor 1.25
by default). Padded experts (Qwen2-MoE's 60 -> 64) get router logits of
-1e30 and receive only padding slots. The reference computes all of it as
XLA gathers, scatters and einsums outside any Pallas kernel; so does this
port, with PyTorch's. ``constrain`` is the identity in eager PyTorch
(``parallel.constraints``) and is left out.

Where routing happens. Alone, a call routes the B*S tokens it is given.
Under the sharded train step (``train.step.build_train_step``) a rank holds
a block of rows of the global batch, which the reference's jit routes as
one: the step sets ``models.modes.global_routing`` to the global token
count of the microbatch, and the groups and the capacity follow from it
(``moe_groups(T)``, groups of T/G tokens, contiguous in row-major (B, S)
order). The rows are split over the batch ranks in contiguous blocks, so
where G divides over the ranks a rank holds G/ranks whole groups and routes
them exactly as the reference does; where it does not, the call raises
(ROADMAP §1 item 9g) rather than route other groups.

The balance loss ``E * sum_e frac_e * mean_gate_e`` takes both factors over
the global batch. Here ``frac`` (the argmax counts, integers with no
gradient) is all-reduced over the batch ranks before the product, and the
mean gate stays this rank's mean: the step's mean of the loss and of every
gradient over the batch ranks then gives the global balance loss and its
gradient (the mean over ranks of ``E * sum frac_global * localmean_r`` is
``E * sum frac_global * globalmean``).

Expert parallelism: under ``models.modes.tensor_parallel`` the routed
experts' leaves may hold this rank's block of E/tp experts (split over
"model" by ``parallel.sharding``) and the shared expert's its column and
row blocks. The input is replicated over "model", so every rank routes
every token and builds the whole (G, E, C) table, keeps its experts'
columns, and adds 0 for an assignment to an expert it does not hold: the
output is this rank's part of the sum, which the caller's g
(``models.modes.tp_reduce``) completes (no all-to-all). Every model rank
computes the router and the balance loss whole, and the caller's f sums
the input's gradient over "model", as the step sums the router's; so the
balance loss's gradient is weighted 1/tp on each rank, which makes the sum
the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.modes import current_routing, current_tp

_ROUTING = contextvars.ContextVar("repro_torch_moe_routing", default=None)


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(np.ceil(top_k * num_tokens * capacity_factor / num_experts))
    return max(8, ((cap + 7) // 8) * 8)  # padded to 8, as the reference


def moe_groups(num_tokens: int) -> int:
    """Dispatch groups (GShard-style): the largest of 16, 8, 4, 2 that
    divides the tokens into groups of at least 8, else 1."""
    for g in (16, 8, 4, 2):
        if num_tokens % g == 0 and num_tokens // g >= 8:
            return g
    return 1


class MoEParams(nn.Module):
    """One layer's MoE parameters, named as the reference's tree: the
    ``router`` (D, E) and, with a shared expert, ``shared_gate`` (D,), both
    fp32 whatever the model's dtype (as the reference keeps them); the
    routed experts' ``w_gate``, ``w_up`` (E, D, F) and ``w_down`` (E, F, D)
    and the ``shared`` MLP in the model's dtype. E is the padded count."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.padded_experts, cfg.d_model, cfg.moe_d_ff

        def param(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param((d, e), torch.float32)
        self.w_gate, self.w_up, self.w_down = param((e, d, f)), param((e, d, f)), param((e, f, d))
        if cfg.num_shared_experts:
            fs = cfg.shared_expert_d_ff
            self.shared = nn.ParameterDict({"w_gate": param((d, fs)), "w_up": param((d, fs)),
                                            "w_down": param((fs, d))})
            self.shared_gate = param((d,), torch.float32)

    def tree(self) -> Dict:
        """The parameters as the reference's subtree (no copies)."""
        out: Dict = dict(self.named_parameters(recurse=False))
        if self.cfg.num_shared_experts:
            out["shared"] = dict(self.shared.items())
        return out


@torch.no_grad()
def moe_init(p: MoEParams, cfg, generator: torch.Generator) -> None:
    """Fill one layer's MoE parameters in place with the reference's
    distributions: fan-in scaled normals (1/sqrt(D) for the router and the
    gate and up projections, 1/sqrt(F) for the down projections) and a
    zero ``shared_gate``."""
    d = cfg.d_model

    def fill(w: torch.Tensor, scale: float) -> None:
        w.copy_(torch.randn(w.shape, generator=generator, device=generator.device) * scale)

    fill(p.router, 1.0 / np.sqrt(d))
    fill(p.w_gate, 1.0 / np.sqrt(d))
    fill(p.w_up, 1.0 / np.sqrt(d))
    fill(p.w_down, 1.0 / np.sqrt(cfg.moe_d_ff))
    if cfg.num_shared_experts:
        fill(p.shared["w_gate"], 1.0 / np.sqrt(d))
        fill(p.shared["w_up"], 1.0 / np.sqrt(d))
        fill(p.shared["w_down"], 1.0 / np.sqrt(cfg.shared_expert_d_ff))
        p.shared_gate.zero_()


@contextlib.contextmanager
def record_routing() -> Iterator[List[Dict[str, torch.Tensor]]]:
    """Within it, each ``moe_apply`` call appends its routing to the
    yielded list, detached: ``gate_probs`` (G, Tg, E) fp32, ``top_e`` (G,
    Tg, k), ``pos`` and ``valid`` (G, Tg*k) (an assignment's position in its
    expert's slots, and whether it is under the capacity) and ``capacity``."""
    log: List[Dict[str, torch.Tensor]] = []
    tok = _ROUTING.set(log)
    try:
        yield log
    finally:
        _ROUTING.reset(tok)


def _expert_mlp(p: Dict, xs: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU on (E, N, D) rows: three batched
    products over the experts (the reference's einsums)."""
    g = torch.bmm(xs, p["w_gate"])
    u = torch.bmm(xs, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


class _GradScale(torch.autograd.Function):
    """``x`` as it is; its gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _groups(t: int, ctx) -> Tuple[int, int]:
    """(groups this call routes, tokens a group) for a call of ``t``
    tokens: its own, or under ``ctx`` (a ``GlobalRouting``) its share of the
    global batch's (module docstring)."""
    if ctx is None:
        grp = moe_groups(t)
        return grp, t // grp
    ranks = ctx.ranks
    if t * ranks != ctx.tokens:
        raise ValueError(f"{t} tokens on each of {ranks} batch ranks are not the "
                         f"{ctx.tokens} of the global batch")
    grp = moe_groups(ctx.tokens)
    if grp % ranks:
        raise NotImplementedError(
            f"the {ctx.tokens} tokens of the global batch route as {grp} groups, which do "
            f"not divide over {ranks} batch ranks: routing groups that straddle ranks is "
            "not ported yet (ROADMAP §1 item 9g)")
    return grp // ranks, ctx.tokens // grp


def moe_apply(p: Dict, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, the Switch balance loss
    (0-d fp32)). Routing, positions, the dispatch table and the combine are
    group-local; the groups and the capacity follow from the B*S tokens of
    this call, or from the global batch under ``global_routing``. With this
    rank's block of the experts (the module docstring), ``out`` is this
    rank's part of the sum."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.padded_experts, cfg.top_k
    ctx = current_routing()
    grp, tg = _groups(t, ctx)
    cap = moe_capacity(tg, e, k, cfg.capacity_factor)
    xf = x.reshape(grp, tg, d)
    dev = x.device
    el = p["w_gate"].shape[0]                                      # the experts held here
    e0 = current_tp().index * el if el != e else 0

    # --- routing (fp32) ---
    logits = xf.float() @ p["router"]                              # (G, Tg, E)
    if e != cfg.num_experts:                                       # mask padded experts
        logits = logits.masked_fill(torch.arange(e, device=dev) >= cfg.num_experts, -1e30)
    gate_probs = torch.softmax(logits, dim=-1)
    # the k largest, an exact tie to the lower expert as lax.top_k orders
    # it (torch.topk leaves the order of ties unspecified)
    top_w, top_e = torch.sort(gate_probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]                  # (G, Tg, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style balance loss: the argmax counts carry no gradient
    hard = gate_probs.argmax(-1).reshape(-1)
    # index_add_ where bincount would wait on the device for its output size
    counts = torch.zeros(e, device=dev).index_add_(0, hard, torch.ones(t, device=dev))
    if ctx is not None and ctx.ranks > 1:
        counts = ctx.all_reduce(counts)
    frac = counts / (t if ctx is None else ctx.tokens)
    aux = cfg.num_experts * (frac * gate_probs.reshape(t, e).mean(0)).sum()
    if el != e:                    # every model rank computes it whole
        aux = _GradScale.apply(aux, el / e)

    # --- group-local capacity positions via a stable sort ---
    flat_e = top_e.reshape(grp, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    first = torch.searchsorted(sorted_e, torch.arange(e, device=dev).repeat(grp, 1))
    pos_sorted = torch.arange(tg * k, device=dev) - first.gather(1, sorted_e)
    pos = torch.empty_like(flat_e).scatter_(1, order, pos_sorted)
    valid = pos < cap
    log = _ROUTING.get()
    if log is not None:
        log.append({"gate_probs": gate_probs.detach(), "top_e": top_e, "pos": pos,
                    "valid": valid, "capacity": cap})

    # --- dispatch: the (G, E, C) token-index table (tg = "none"), then gather ---
    tok_ids = (torch.arange(tg * k, device=dev) // k).expand(grp, tg * k)   # each token k times
    gidx = torch.arange(grp, device=dev)[:, None].expand(grp, tg * k)
    # dropped assignments all write the spare column ``cap``, with one value
    table = torch.full((grp, e, cap + 1), tg, dtype=torch.long, device=dev)
    table.index_put_((gidx, flat_e, torch.where(valid, pos, cap)),
                     torch.where(valid, tok_ids, tg))
    table = table[:, e0:e0 + el, :cap]                             # this rank's experts
    xpad = torch.cat([xf, xf.new_zeros(grp, 1, d)], dim=1)
    dispatched = xpad[torch.arange(grp, device=dev)[:, None, None], table]   # (G, El, C, D)

    # --- expert compute, the groups' slots of one expert in one product ---
    rows = dispatched.permute(1, 0, 2, 3).reshape(el, grp * cap, d)
    y = _expert_mlp(p, rows).reshape(el, grp, cap, d).permute(1, 0, 2, 3)  # (G, El, C, D)

    # --- combine: group-local weighted gather back to the tokens; an
    # assignment to an expert held elsewhere reads slot 0 and weighs 0 ---
    flat_pos = pos.clamp_max(cap - 1).reshape(grp, tg, k)
    local_e = top_e - e0
    held = (local_e >= 0) & (local_e < el)
    gathered = y[torch.arange(grp, device=dev)[:, None, None],
                 local_e.clamp(0, el - 1), flat_pos]                # (G, Tg, k, D)
    w = top_w * (valid.reshape(grp, tg, k) & held)
    out = (gathered.float() * w[..., None]).sum(dim=2)

    # --- shared expert (Qwen2-MoE): a dense MLP times a sigmoid gate ---
    if "shared" in p:
        sp = p["shared"]
        shared_out = (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
        gate = torch.sigmoid(xf.float() @ p["shared_gate"][:, None])
        out = out + shared_out.float() * gate

    return out.reshape(b, s, d).to(x.dtype), aux
