"""The reference's policy and critic, built from the benchmark's
flax-layout weights by the configuration's nets module
(``bench_port/nets/``), computing in float32 with TF32 off (the
reference) or with the operands of the layers that see the image rounded
to fp8 e4m3 under one scale per tensor (the control: the next precision
below the configuration's bfloat16)."""
from __future__ import annotations

import torch

from bench_port.nets import of

FP8_MAX = 448.0


def strict_float32() -> None:
    """Float32 products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under the scale that maps its largest
    magnitude to the format's largest value, back in float32. Gradients
    pass the rounding unchanged, and the backward works on the rounded
    operands, as an fp8 forward with a higher-precision backward does."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q / scale - x).detach()


def make_nets(model: dict, obs_shape, policy_params, critic_params, device,
              precision: str = "float32"):
    """(policy, critic or None) on ``device``, of ``model``'s nets module."""
    return of(model).reference_nets(model, obs_shape, policy_params,
                                    critic_params, device, precision)
