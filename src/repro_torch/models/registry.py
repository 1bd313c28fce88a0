"""Model registry: arch id -> config module, family -> model class.

The dense family (``DenseLM``) and the ssm family (``MambaLM``) are ported;
the other families of the JAX package raise (ROADMAP Queue A, item A3)."""
from __future__ import annotations

import importlib

import torch

from ..configs.base import ArchConfig, ModelConfig, RunConfig
from ..core.api import ParallelContext
from ..core.device import resolve_device

ARCH_MODULES = {
    "nemotron-4-340b": "nemotron_4_340b",
    "smollm-360m": "smollm_360m",
    "llama3-405b": "llama3_405b",
    "mamba2-1.3b": "mamba2_13b",
    "yi-6b": "yi_6b",
}


def _module(name: str):
    if name not in ARCH_MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; ported archs: "
            f"{sorted(ARCH_MODULES)} (ROADMAP Queue A, item A3)")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")


def get_arch(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def build_model(cfg: ModelConfig, ctx: ParallelContext, run: RunConfig, *,
                device="cuda", seed: int = 0, mesh=None):
    """Model with random weights from ``torch.Generator(device).manual_seed
    (seed)``, on ``device`` (the card unless the caller asks for the CPU).
    Across ranks pass the ``core.mesh.Mesh`` of ``ctx``, built once on
    every rank; each rank then holds its blocks of the same global
    weights."""
    if cfg.family == "dense":
        from .transformer import DenseLM as cls
    elif cfg.family == "ssm":
        from .ssm import MambaLM as cls
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A, "
            f"item A3)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cls(cfg, ctx, run, device=dev, generator=gen, mesh=mesh)
