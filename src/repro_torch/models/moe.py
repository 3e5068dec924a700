"""Mixture-of-Experts layer: top-k routing with grouped dispatch.

Counterpart of ``repro.models.moe`` (XLA in the reference, no Pallas
kernel; plain torch here). GShard-style static-capacity dispatch:

* tokens are split into groups of ``group_size`` (shrunk until it
  divides the token count), so the one-hot dispatch and combine tensors
  are (G, Tg, E, Cg) with Tg small;
* the experts run as one stacked einsum over the expert axis;
* capacity C_g = int(Tg · k · capacity_factor / E) + 1, or Tg · k with
  ``capacity_factor`` ≤ 0 (no drop, decode); overflow tokens are dropped
  (only their residual passes);
* the router computes in f32 and returns the Switch-style load-balance
  auxiliary loss.

Two dispatches compute the same function: ``"einsum"`` (one-hot
dispatch and combine matmuls) and ``"gather"`` (slot gathers). The top
k is taken from a stable descending sort, so among equal router
probabilities the lower expert index comes first, as ``lax.top_k``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.sharding_api import NO_SHARD, ShardPolicy


def _capacity(tg: int, k: int, e: int, cf: float) -> int:
    if cf <= 0:                        # no-drop mode (decode): worst case
        return tg * k
    return max(int(tg * k * cf / e) + 1, 1)


def _route(xt_2d: torch.Tensor, router: torch.Tensor, topk: int):
    """Shared routing: top-k gates and the Switch aux loss. xt_2d: (T, D).
    Returns (gate values (T, K) f32, expert ids (T, K), aux)."""
    E = router.shape[1]
    logits = torch.einsum("td,de->te", xt_2d.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[:, :topk]
    gate_idx = order.indices[:, :topk]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    me = probs.mean(dim=0)
    fe = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    aux = E * (me * fe).sum()
    return gate_vals, gate_idx, aux


def router_gaps(x: torch.Tensor, router: torch.Tensor,
                topk: int) -> torch.Tensor:
    """(T,) gap between the k-th and (k+1)-th router probabilities of each
    token of ``x`` (…, D): where it is tiny, a rounding elsewhere can
    swap a whole expert. ``inf`` when every expert is chosen."""
    if topk >= router.shape[1]:
        return torch.full(x.shape[:-1], float("inf"), device=x.device)
    probs = torch.softmax(torch.einsum("...d,de->...e", x.float(),
                                       router.float()), dim=-1)
    top = probs.topk(topk + 1, dim=-1).values
    return top[..., topk - 1] - top[..., topk]


def _positions_in_expert(gate_idx: torch.Tensor, E: int, cap: int):
    """Capacity assignment, sequential over the K choices.
    gate_idx: (…, T, K) → (position in its expert (…, T, K), keep)."""
    counts = None
    poss, keeps = [], []
    for k in range(gate_idx.shape[-1]):
        mask_k = F.one_hot(gate_idx[..., k], E)             # (…, T, E)
        base = torch.cumsum(mask_k, dim=-2) - mask_k
        if counts is not None:
            base = base + counts[..., None, :]
        pos_k = (base * mask_k).sum(-1)                     # (…, T)
        poss.append(pos_k)
        keeps.append(pos_k < cap)
        counts = (0 if counts is None else counts) + mask_k.sum(-2)
    return torch.stack(poss, -1), torch.stack(keeps, -1)


def _groups(T: int, group_size: int) -> tuple[int, int]:
    g = min(group_size, T)
    while T % g:                       # the group size must divide T
        g -= 1
    return T // g, g


def _experts(xe: torch.Tensor, we_gate, we_up, we_down,
             eq_in: str, eq_out: str) -> torch.Tensor:
    dt = xe.dtype
    h = F.silu(torch.einsum(eq_in, xe, we_gate.to(dt)))
    h = h * torch.einsum(eq_in, xe, we_up.to(dt))
    return torch.einsum(eq_out, h, we_down.to(dt))


def _moe_einsum(x, router, we_gate, we_up, we_down, topk, capacity_factor,
                group_size, shard):
    """Grouped one-hot dispatch (the GShard baseline)."""
    B, S, D = x.shape
    E = router.shape[1]
    G, Tg = _groups(B * S, group_size)
    Cg = _capacity(Tg, topk, E, capacity_factor)
    xt = x.reshape(G, Tg, D)
    gate_vals, gate_idx, aux = _route(x.reshape(-1, D), router, topk)
    gate_vals = gate_vals.reshape(G, Tg, -1)
    gate_idx = gate_idx.reshape(G, Tg, -1)
    pos, keep = _positions_in_expert(gate_idx, E, Cg)       # (G, Tg, K)

    dispatch = torch.zeros((G, Tg, E, Cg), dtype=x.dtype, device=x.device)
    combine = torch.zeros((G, Tg, E, Cg), dtype=torch.float32,
                          device=x.device)
    for k in range(gate_idx.shape[-1]):
        mask_k = F.one_hot(gate_idx[..., k], E).to(x.dtype)
        # a dropped choice points at the one-past-the-end slot, whose
        # one-hot row is all zero (as jax.nn.one_hot of an out-of-range id)
        oh_pos = F.one_hot(torch.where(keep[..., k], pos[..., k], Cg),
                           Cg + 1)[..., :Cg].to(x.dtype)
        sel = mask_k[..., None] * oh_pos[..., None, :]
        dispatch = dispatch + sel
        combine = combine + sel.float() * \
            (gate_vals[..., k] * keep[..., k])[..., None, None]

    xe = torch.einsum("gtec,gtd->egcd", dispatch, xt)       # (E, G, Cg, D)
    axes = ("experts", "moe_group", None, "embed")
    ye = shard(_experts(shard(xe, axes), we_gate, we_up, we_down,
                        "egcd,edf->egcf", "egcf,efd->egcd"), axes)
    y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), ye)
    return y.reshape(B, S, D), aux


def _moe_gather(x, router, we_gate, we_up, we_down, topk, capacity_factor,
                group_size, shard):
    """Grouped gather/scatter dispatch: the same capacity and drops as
    the einsum path, with slot gathers in place of the one-hot
    matmuls."""
    B, S, D = x.shape
    E = router.shape[1]
    G, Tg = _groups(B * S, group_size)
    Cg = _capacity(Tg, topk, E, capacity_factor)
    xt = x.reshape(G, Tg, D)
    gate_vals, gate_idx, aux = _route(x.reshape(-1, D), router, topk)
    gate_vals = gate_vals.reshape(G, Tg, -1)                # (G, Tg, K)
    gate_idx = gate_idx.reshape(G, Tg, -1)
    pos, keep = _positions_in_expert(gate_idx, E, Cg)

    slot = torch.where(keep, gate_idx * Cg + pos, E * Cg)   # overflow slot
    tok_ids = torch.arange(Tg, device=x.device)[None, :, None] \
        .expand(slot.shape)
    # one spare column takes every overflow write (the reference's
    # scatter drops them); kept slots are unique, so no write collides
    token_of_slot = torch.zeros((G, E * Cg + 1), dtype=torch.long,
                                device=x.device)
    token_of_slot.scatter_(1, slot.reshape(G, -1), tok_ids.reshape(G, -1))
    token_of_slot = token_of_slot[:, :E * Cg]

    xe = torch.gather(xt, 1, token_of_slot[..., None].expand(-1, -1, D))
    axes = ("moe_group", "experts", None, "embed")
    ye = shard(_experts(shard(xe.reshape(G, E, Cg, D), axes), we_gate,
                        we_up, we_down, "gecd,edf->gecf", "gecf,efd->gecd"),
               axes)
    ye_flat = ye.reshape(G, E * Cg, D)
    idx = slot.reshape(G, -1).clamp_max(E * Cg - 1)
    picked = torch.gather(ye_flat, 1, idx[..., None].expand(-1, -1, D)) \
        .reshape(G, Tg, -1, D)
    picked = torch.where(keep[..., None], picked, 0.0)
    y = (picked * gate_vals[..., None].to(x.dtype)).sum(dim=2)
    return y.reshape(B, S, D), aux


def moe_mlp(x: torch.Tensor, router: torch.Tensor, we_gate: torch.Tensor,
            we_up: torch.Tensor, we_down: torch.Tensor, topk: int,
            capacity_factor: float = 1.25, group_size: int = 512,
            dispatch: str = "einsum", shard: ShardPolicy = NO_SHARD
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss). Expert weights: (E, D, F)/(E, F, D).
    ``shard`` constrains the dispatched tokens and the experts' outputs
    to the expert and group axes."""
    if dispatch not in ("einsum", "gather"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    fn = _moe_gather if dispatch == "gather" else _moe_einsum
    return fn(x, router, we_gate, we_up, we_down, topk, capacity_factor,
              group_size, shard)
