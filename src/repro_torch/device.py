"""Device resolution for the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the CUDA card; raises when none is present.

    The port never carries on quietly on the CPU: the CPU is used only when
    the caller asks for it (``device="cpu"``), as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device and none is available; "
            'pass device="cpu" to run the plain PyTorch versions'
        )
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> contiguous float32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()
