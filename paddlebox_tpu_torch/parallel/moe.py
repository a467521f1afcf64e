"""Mixture-of-Experts with expert parallelism — counterpart of
``paddlebox_tpu/parallel/moe.py``.

Reference: ``NaiveGate`` (plain top-k), ``SwitchGate`` (top-1 +
capacity), ``GShardGate`` (top-2 + capacity + load-balance aux loss), and
a MoELayer that all-to-alls tokens to the rank owning each expert.

The GShard einsum formulation: gating produces dense one-hot
**dispatch** [T, E, C] and weighted **combine** tensors, expert inputs are
one einsum, and the token exchange is one ``all_to_all`` over the ``ep``
axis. Shapes are static: capacity drops overflow tokens as the reference's
capacity gates do (ties in the argmax go to the first maximum).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.parallel.collectives import Axis, all_to_all, pmean


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(idx.long(), n).float()


def _take(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(probs, 1, idx[:, None])[:, 0]


def top1_gating(logits: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Dict[str, Any]]:
    """Switch-style top-1 routing.

    Returns (dispatch [T,E,C], combine [T,E,C], aux_loss, metrics).
    Tokens beyond an expert's capacity are dropped (zero rows), matching
    the reference SwitchGate's capacity clamp.
    """
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                     # [T]
    gate = _take(probs, expert)

    mask = _one_hot(expert, e)                               # [T, E]
    pos = torch.cumsum(mask, dim=0) * mask - 1.0             # [T, E]
    pos_in_e = torch.sum(pos * mask, dim=1)                  # [T]
    keep = pos_in_e < capacity
    gate = gate * keep

    # load-balance aux loss (Switch eq.4): E * Σ_e fraction_e * prob_e
    me = torch.mean(probs, dim=0)
    ce = torch.mean(mask, dim=0)
    aux = e * torch.sum(me * ce)

    disp = mask[:, :, None] * _one_hot(
        pos_in_e.clamp(0, capacity - 1), capacity
    )[:, None, :] * keep[:, None, None]                      # [T, E, C]
    comb = disp * gate[:, None, None]
    metrics = {"dropped": torch.sum(1.0 - keep.float()), "load": ce}
    return disp, comb, aux, metrics


def top2_gating(logits: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Dict[str, Any]]:
    """GShard-style top-2 routing with renormalized weights."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)

    e1 = torch.argmax(probs, dim=-1)
    p1 = _take(probs, e1)
    probs2 = probs * (1.0 - _one_hot(e1, e))
    e2 = torch.argmax(probs2, dim=-1)
    p2 = _take(probs2, e2)

    denom = torch.clamp(p1 + p2, min=1e-9)
    w1, w2 = p1 / denom, p2 / denom

    m1 = _one_hot(e1, e)
    m2 = _one_hot(e2, e)
    pos1 = torch.sum((torch.cumsum(m1, 0) - 1.0) * m1, dim=1)
    # second choices queue after every first choice of the same expert
    count1 = torch.sum(m1, dim=0)                            # [E]
    pos2 = torch.sum((torch.cumsum(m2, 0) - 1.0) * m2, dim=1) \
        + torch.sum(m2 * count1[None, :], dim=1)
    keep1 = pos1 < capacity
    keep2 = pos2 < capacity

    me = torch.mean(probs, dim=0)
    ce = torch.mean(m1, dim=0)
    aux = e * torch.sum(me * ce)

    def build(mask, pos, keep, w):
        d = mask[:, :, None] * _one_hot(
            pos.clamp(0, capacity - 1), capacity
        )[:, None, :] * keep[:, None, None]
        return d, d * w[:, None, None]

    d1, c1 = build(m1, pos1, keep1, w1)
    d2, c2 = build(m2, pos2, keep2, w2)
    disp = torch.maximum(d1, d2)
    comb = c1 + c2
    metrics = {"dropped": torch.sum(2.0 - keep1.float() - keep2.float()),
               "load": ce}
    return disp, comb, aux, metrics


def naive_gating(logits: torch.Tensor, capacity: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            Dict[str, Any]]:
    """NaiveGate: top-2 without capacity pressure (capacity = T, nothing
    dropped) and no aux loss — the reference's baseline gate."""
    t = logits.shape[0]
    disp, comb, _, metrics = top2_gating(logits, capacity or t)
    return disp, comb, logits.new_zeros(()), metrics


GATES: Dict[str, Callable] = {
    "naive": naive_gating,
    "switch": top1_gating,
    "gshard": top2_gating,
}


def moe_forward_local(x: torch.Tensor, gate_w: torch.Tensor,
                      expert_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                      expert_params: Any, capacity: int,
                      gate: str = "switch"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE forward: all experts local.

    expert_params leaves carry a leading E axis; expert_fn runs under
    ``torch.vmap`` over it. Returns (y [T, D], aux_loss).
    """
    logits = x @ gate_w                                      # [T, E]
    disp, comb, aux, _ = GATES[gate](logits, capacity)
    xin = torch.einsum("tec,td->ecd", disp, x)               # [E, C, D]
    yout = torch.vmap(expert_fn)(xin, expert_params)         # [E, C, D']
    y = torch.einsum("tec,ecd->td", comb, yout)
    return y, aux


def moe_forward_sharded(axis: Axis,
                        expert_fn: Callable[[torch.Tensor, Any],
                                            torch.Tensor],
                        capacity: int, gate: str = "switch"):
    """An expert-parallel MoE forward over ``axis``: returns a callable
    ``(x, gate_w, expert_params) -> (y, aux)`` that every rank calls on
    its own tokens ``x`` [t, D], the replicated ``gate_w`` [D, E_tot] and
    its own experts' params (leading axis E_tot / size, rank r owning
    experts r*E_loc .. r*E_loc + E_loc - 1).

    The dispatch einsum runs on the token owner, one all-to-all moves
    each expert's token slice to the expert's owner, the experts run, a
    second all-to-all brings the results home, the combine einsum runs,
    and the aux loss is averaged over the axis."""

    def body(x, gate_w, expert_params):
        logits = x @ gate_w                                   # [t, E_tot]
        disp, comb, aux, _ = GATES[gate](logits, capacity)
        xin = torch.einsum("tec,td->ecd", disp, x)            # [E_tot, C, D]
        # → [E_loc, n*C, D]: every rank contributes its slice of each
        # expert's capacity buffer to the expert's owner
        xin = all_to_all(xin, axis, 0, 1)
        # [E_loc, n*C, D']
        yout = torch.vmap(expert_fn)(xin, expert_params)
        yout = all_to_all(yout, axis, 1, 0)                   # [E_tot, C, D']
        y = torch.einsum("tec,ecd->td", comb, yout)
        return y, pmean(aux, axis)

    return body
