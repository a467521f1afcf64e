"""scaled_fc / scaled_int8fc — reduced-precision FC with scale factors;
counterpart of ``paddlebox_tpu/ops/scaled_fc.py``.

Reference: paddle/fluid/operators/scaled_fc_op.{cc,cu}: X and the bias
are scaled (input_scale_factor / bias_scale_factor), cast to fp16, the
GEMM runs, and the output is unscaled by 1 / input_scale_factor
(scaled_fc_op.cu:211-222 ⇒ out = x@w + (sb/si)·b, in the reference's
own wiring kept here). bf16 shares fp32's exponent range, so the port,
like the JAX package, keeps the scales for the math and multiplies the
bf16-rounded operands with float32 accumulation. ``scaled_int8fc``
quantizes both operands to int8 with per-tensor scales and accumulates
exactly (the products of int8 values sum exactly in float64).
"""

from __future__ import annotations

import torch


def scaled_fc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              input_scale_factor: float = 1.0, bias_scale_factor: float = 1.0,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, I] @ w [I, O] + bias [O] through ``compute_dtype`` operands."""
    mm = (x.to(compute_dtype).float() @ w.to(compute_dtype).float()
          ) * input_scale_factor
    out = mm + (bias * bias_scale_factor).float()[None, :]
    return out / input_scale_factor


def _q8(t: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(t * scale), -127, 127).to(torch.int8)


def scaled_int8fc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  input_scale: float, weight_scale: float) -> torch.Tensor:
    """x @ w + bias with both operands quantized to int8 (round half to
    even, clipped to ±127) and the products accumulated exactly."""
    acc = _q8(x, input_scale).double() @ _q8(w, weight_scale).double()
    return acc.float() / (input_scale * weight_scale) + bias[None, :]
