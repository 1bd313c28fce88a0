"""PyTorch / CUDA port of the Tesseract reproduction, for one NVIDIA H100.

The JAX package (``repro``) stays the reference; this package imports
nothing of it.  Subpackages mirror the reference's layout: ``configs``,
``core``, ``kernels`` (hand-written Hopper kernels in ``csrc``), ``models``,
``optim``, ``data``, ``checkpoint``, ``runtime``, ``serve``, ``launch`` and
``testing``.  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
