"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card, and raises if there is none; pass
    ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To the card it goes through pinned memory
    with a non-blocking copy: a pageable copy would wait for the stream, and
    work that only enqueues device work must not wait for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
