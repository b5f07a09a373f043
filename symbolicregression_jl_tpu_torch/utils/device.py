"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. A default
call on a machine without a card raises instead of quietly running on the
CPU; the CPU path is taken only when the caller asks for it.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@functools.lru_cache(maxsize=None)
def table(values: tuple, device: torch.device,
          dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``values`` as a tensor on ``device``, built once per (values,
    device, dtype): copying a host list to the card waits for the card,
    and a captured graph may not copy from host memory at all. Callers
    never write into the tensor."""
    return torch.tensor(values, dtype=dtype, device=device)
