"""Unfused CVM transform op (counterpart of ``paddlebox_tpu/ops/cvm.py``).

Reference: paddle/fluid/operators/cvm_op.{h,cc,cu} — ``CvmComputeKernel``
(cvm_op.h:25-40): with use_cvm, y0=log(x0+1), y1=log(x1+1)-y0, rest copied
(same width); without, the two cvm columns are stripped. Backward
``CvmGradComputeKernel`` (:43-58): dx[0:2] = CVM batch values, embed dims
pass the upstream grad straight through (the log is NOT differentiated:
the show/clk columns are statistics channels for the PS, not trained
weights). Elementwise torch: no kernel.
"""

from __future__ import annotations

import torch


class _CVM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, batch_cvm, use_cvm):
        ctx.use_cvm, ctx.dtype = use_cvm, x.dtype
        ctx.save_for_backward(batch_cvm)
        if not use_cvm:
            return x[:, 2:].clone()
        show = torch.log1p(x[:, 0:1])
        return torch.cat([show, torch.log1p(x[:, 1:2]) - show, x[:, 2:]],
                         dim=1)

    @staticmethod
    def backward(ctx, g):
        batch_cvm, = ctx.saved_tensors
        g_embed = g[:, 2:] if ctx.use_cvm else g
        dx = torch.cat([batch_cvm.to(g_embed.dtype), g_embed], dim=1)
        return dx.to(ctx.dtype), None, None


def cvm(x: torch.Tensor, batch_cvm: torch.Tensor,
        use_cvm: bool = True) -> torch.Tensor:
    """x [B, D] with x[:, 0] = show, x[:, 1] = clk; batch_cvm [B, 2].
    Returns [B, D] (use_cvm) or [B, D-2]."""
    return _CVM.apply(x, batch_cvm, use_cvm)


def cvm_grad_passthrough(x: torch.Tensor) -> torch.Tensor:
    """Identity whose gradient skips the first two (show/clk) columns —
    for models wiring raw pulled values into non-CVM heads."""
    zero2 = torch.cat([torch.zeros_like(x[:, :2]),
                       torch.ones_like(x[:, 2:])], dim=1)
    return x * zero2 + (x * (1 - zero2)).detach()
