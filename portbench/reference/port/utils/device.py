"""Device and precision policy of the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    ``device=None`` means ``cuda``, and raises when there is no GPU rather
    than carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def scalar_like(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a number or a tensor) as a tensor of ``like``'s dtype and
    device. A Python number is written on the device by a fill kernel:
    ``torch.as_tensor(number, device="cuda")`` copies it from the host and
    waits for the stream, a host sync."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=like.dtype, device=like.device)
    return like.new_full((), value)


def full_f32_matmuls() -> None:
    """Keep float32 products in full float32 on the card. TF32 keeps about
    three decimal digits, which second-order solves at µ ≤ 1e-6 cannot
    afford (the JAX package pins "highest" matmul precision for the same
    reason). Both switches are set explicitly, whatever their defaults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
