"""The Tesseract SUMMA contraction: the Hopper kernels' wrappers and their
plain versions.

Counterpart of ``repro/kernels/tesseract_mm.py``:

- ``tesseract_mm(a, b, out_dtype)``: a [T, E, F], b [T, F, G] -> C [E, G]
  with C[e, g] = sum_t sum_f a[t, e, f] b[t, f, g] summed in float32 (the
  TPU kernel ``tesseract_mm``, body ``_kernel``): the local product of the
  fused SUMMA schedule after the gathers of A over col and of W over row.
  C is float32, or with ``out_dtype=torch.bfloat16`` the float32 sums
  rounded once to bf16 in the kernel's epilogue (the SUMMA matmul's result
  in A's dtype, with no separate cast);
- ``tesseract_mm_stream(a, b, c)``: a [E, F], b [F, G], c [E, G] float32;
  c <- c + a b in place (the TPU kernel ``tesseract_mm_stream``, body
  ``_stream_kernel``, whose accumulator is donated): one step of the ring
  schedule.

Both launch ``csrc/tesseract_mm.cu`` for CUDA tensors or raise, and take
the plain versions only for CPU tensors.  The kernel's route follows the
shape: bf16 with E > 16, F and G multiples of 8 and 16-byte-aligned bases
(every prefill and train projection) on ``wgmma`` fed by TMA; bf16 with
E <= 16 (decode) on the skinny ``mma.sync`` tile; any other bf16 shape on
``mma.sync`` with element-wise loads; fp32 by FMA.  The plain versions are
the reference's ``ref.py::tesseract_mm_ref`` in torch, an einsum, but
summed in float64
and rounded once to float32: the exact oracle that every float32
accumulation order (the kernels' tiles, XLA's dot) approximates.  An
fp32 einsum would add one more order of its own, and one such order
rounded a bf16 near-tie of a mamba2 projection differently from XLA's
bf16 dot (``tests/test_torch_ssm.py``'s bf16 case depends on this; ROADMAP
Queue C).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .flash_attention import DTYPES
from .ops import LAUNCHES

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
OUT_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The kernels' C entry, built and resolved at the first launch."""
    return build.function("repro_tesseract_mm", _ARGTYPES)


def tesseract_mm_plain(a, b, out_dtype=torch.float32):
    """Plain version of kernel #1: sum_t a[t] @ b[t] -> [E, G] (a [E, F]
    and b [F, G] are T = 1), summed in float64 and rounded once to
    float32, so it stands for the exact sum that any fp32 accumulation
    order approximates (the reference's oracle ``ref.py::tesseract_mm_ref``
    sums in fp32, in XLA's order); then cast to ``out_dtype``."""
    if a.ndim == 2:
        a, b = a[None], b[None]
    c = torch.einsum("tef,tfg->eg", a.double(), b.double()).float()
    return c.to(out_dtype)


def tesseract_mm_stream_plain(a, b, c):
    """Plain version of kernel #2: c + a @ b, the product summed in float64
    and the result rounded once to float32 (a new tensor)."""
    return (c.double() + a.double() @ b.double()).float()


def _dims(what, a, b, c=None):
    """(T, E, F, G) of a [T, E, F] and b [T, F, G], or of a [E, F] and
    b [F, G] (T = 1), once the tensors are what the kernel reads."""
    if a.device != b.device or (c is not None and c.device != a.device):
        raise ValueError(f"{what}: tensors on different devices")
    if a.dtype not in DTYPES or a.dtype != b.dtype:
        raise TypeError(f"{what}: needs a and b of one dtype among "
                        f"{list(DTYPES)}, got {a.dtype}, {b.dtype}")
    if a.ndim == b.ndim == 2:
        (E, F), (Fb, G), T, Tb = a.shape, b.shape, 1, 1
    elif a.ndim == b.ndim == 3:
        (T, E, F), (Tb, Fb, G) = a.shape, b.shape
    else:
        T = Tb = 0
    if T == 0 or (Tb, Fb) != (T, F) or E == 0 or G == 0:
        raise ValueError(f"{what}: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    if c is not None and (c.dtype != torch.float32 or c.shape != (E, G)
                          or not c.is_contiguous()):
        raise ValueError(f"{what}: c must be a contiguous float32 "
                         f"[{E}, {G}] tensor")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: a and b must be contiguous")
    return T, E, F, G


def _launch(what, a, b, c, dims, accumulate):
    # Every projection launches here (224 per yi-6b decode step), so the
    # host path is kept short: the raw handle of the device's current
    # stream (``torch.cuda.current_stream(...).cuda_stream`` builds a
    # Stream object, ~7 us on an H100 host against 0.2), and a device
    # context only when the tensors are off the current device.
    dev = a.get_device()
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), *dims,
            DTYPES[a.dtype], DTYPES[c.dtype], int(accumulate),
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        rc = _entry()(*args)
    else:
        with torch.cuda.device(dev):
            rc = _entry()(*args)
    build.check(rc, what)
    LAUNCHES[what] += 1


def _on_cuda(what, a):
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {a.device}")
    return True


def tesseract_mm(a, b, out_dtype=torch.float32):
    """Kernel #1: C [E, G] = sum_t a[t] @ b[t] for a [T, E, F] and
    b [T, F, G] (or a [E, F] and b [F, G]: T = 1), summed in fp32 and
    stored as ``out_dtype`` (float32, or bfloat16 rounded once).  A CUDA
    tensor launches ``csrc/tesseract_mm.cu`` (or raises); a CPU tensor
    takes ``tesseract_mm_plain``."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"tesseract_mm: out_dtype must be one of "
                        f"{list(OUT_DTYPES)}, got {out_dtype}")
    if not _on_cuda("tesseract_mm", a):
        return tesseract_mm_plain(a, b, out_dtype)
    dims = _dims("tesseract_mm", a, b)
    c = torch.empty(dims[1], dims[3], dtype=out_dtype, device=a.device)
    _launch("tesseract_mm", a, b, c, dims, accumulate=False)
    return c


def tesseract_mm_stream(a, b, c):
    """Kernel #2: c += a @ b in place for a [E, F], b [F, G] and the fp32
    accumulator c [E, G]; returns c.  A CUDA tensor launches
    ``csrc/tesseract_mm.cu`` with the accumulator loaded first (or raises);
    a CPU tensor takes ``tesseract_mm_stream_plain``."""
    if not _on_cuda("tesseract_mm_stream", a):
        return c.copy_(tesseract_mm_stream_plain(a, b, c))
    dims = _dims("tesseract_mm_stream", a, b, c)
    _launch("tesseract_mm_stream", a, b, c, dims, accumulate=True)
    return c
