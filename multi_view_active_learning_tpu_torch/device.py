"""Device selection: the card by default, the CPU only when asked."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA device and raises when there is none: a run
    that was meant for the card must not quietly measure the CPU.  Pass
    ``"cpu"`` (as the tests do) to run the plain versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as a tensor on `device`, without
    stalling the host on the card: a plain copy from pageable memory
    synchronizes the stream, so on CUDA the array is staged in pinned memory
    and copied with ``non_blocking=True``.  PyTorch's pinned allocator keeps
    the staging buffer from reuse until that copy has run."""
    t = torch.as_tensor(array)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
