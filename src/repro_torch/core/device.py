"""Device resolution for the port's entry points.

Entry points (model builders, ``InferenceEngine``, the serve launcher) run
on the card unless the caller asks for the CPU: ``device`` defaults to
"cuda" and a machine without CUDA raises instead of falling back."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
