"""Attention data-path selection and the kernels' launch counters.

``attn_impl`` (RunConfig / ParallelContext) keeps the reference's three
values, so a config reads the same in both packages (counterpart of
``repro/kernels/ops.py::effective_attn_impl``):

    "jnp"    — the plain PyTorch versions beside each kernel (full fp32
               score matrix; the reference's pure-jnp paths)
    "pallas" — the hand-written Hopper kernels (csrc/*.cu).  Their wrappers
               launch the kernel for a CUDA tensor and take the plain
               version only for a tensor that lies on the CPU, so CPU tests
               drive the same dispatch
    "auto"   — the kernels when the tensors are on a CUDA device, the plain
               versions on the CPU

The ssm mixer's SSD kernel is chosen by ``RunConfig.use_pallas``, the
reference's knob for it (``models/ssm.py``).  The SUMMA contraction has no
knob: every ``tesseract_matmul`` on the card runs kernel #1 or #2
(``core/summa.py``), as ``matmul_schedule`` picks.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where
it launches its kernel, and nowhere else.
"""
from __future__ import annotations

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "paged_attention": 0, "ssd_intra": 0, "tesseract_mm": 0,
            "tesseract_mm_stream": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def effective_attn_impl(impl: str, device) -> str:
    """Resolve an ``attn_impl`` knob to the executing data path on ``device``
    ("jnp" = plain versions, "pallas" = kernel wrappers)."""
    if impl == "auto":
        return "pallas" if device.type == "cuda" else "jnp"
    if impl not in ("jnp", "pallas"):
        raise ValueError(f"attn_impl must be 'jnp', 'pallas' or 'auto', "
                         f"got {impl!r}")
    return impl
