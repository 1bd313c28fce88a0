"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

Every ``*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an object
file (one ``nvcc`` per source, all started together), and the objects are
linked into one shared library with a plain C interface, loaded through
``ctypes``.  The build runs at first use, in ``repro_torch/_build/`` (listed
in ``.gitignore``), and is keyed by a hash of the sources and flags, so a
fresh checkout builds on its first kernel launch and an edited source
rebuilds.  There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build(path: pathlib.Path) -> str:
    """Compile every source in parallel and link ``path``; returns the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            report.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(report))
        tmp_so = pathlib.Path(tmp) / path.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so),
             *[str(obj) for _, obj, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, path)          # atomic: readers never see half
    text = "\n".join(report)
    path.with_suffix(".log").write_text(text)
    return text


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet (the compiler's report is kept beside it as ``.log``)."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def function(name: str, argtypes: list):
    """C entry ``name`` of the kernel library with its argument types set
    (``c_void_p`` for pointers and streams; results are cudaError_t)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise unless a kernel entry returned cudaSuccess."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           f"({msg})")
