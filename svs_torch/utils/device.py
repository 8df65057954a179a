"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  With no GPU
and no explicit ``"cpu"`` they raise: a run meant for the card never carries
on quietly on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the host")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype name ('float32' | 'bfloat16') -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        name or "float32"]
