"""Boundary of the PyTorch port: it imports nothing of JAX or of the JAX
package, runs on the GPU unless asked for the CPU, and its kernel wrappers
take the plain versions only for CPU tensors."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.core.api import ParallelContext
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import (flash_dkv, flash_dkv_plain,
                                                 flash_dq, flash_dq_plain,
                                                 flash_fwd, flash_fwd_plain)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)
from repro_torch.kernels.tesseract_mm import (tesseract_mm,
                                              tesseract_mm_plain,
                                              tesseract_mm_stream,
                                              tesseract_mm_stream_plain)
from repro_torch.models.registry import build_model, get_reduced
from repro_torch.runtime.steps import build_train_step
from repro_torch.serve import EngineConfig, InferenceEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    assert len(PORT_FILES) > 20
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p)
                                            & {"jax", "jaxlib", "repro"})
           for p in PORT_FILES}
    assert not {p: r for p, r in bad.items() if r}


def test_engine_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.runtime.train_loop, repro_torch.launch.train, "
            "repro_torch.models.ssm, repro_torch.kernels.ssd, "
            "repro_torch.testing.mdchecks, repro_torch.checkpoint.ckpt, "
            "repro_torch.runtime.elastic, repro_torch.runtime.faults; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda():
    """Without a device argument the entry points ask for CUDA; on a
    machine without it they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    cfg = get_reduced("yi-6b").model
    ctx, run = ParallelContext(), RunConfig(param_dtype="float32",
                                            compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, ctx, run)
    model = build_model(cfg, ctx, run, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(model, EngineConfig())
    from repro_torch.launch.train import main as train_main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--arch", "yi-6b", "--reduced", "--steps", "1"])


def test_multi_device_layouts_raise():
    """Layouts the port does not run raise naming their ROADMAP item: a seq
    axis and the gspmd op set; a mesh of several ranks without
    torch.distributed asks for torchrun, for the dense and the ssm family
    alike."""
    cfg = get_reduced("yi-6b").model
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    for ctx in (ParallelContext(seq=2), ParallelContext(mode="gspmd")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(cfg, ctx, run, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        build_model(get_reduced("mamba2-1.3b").model,
                    ParallelContext(rows=2, cols=2), run, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        build_model(cfg, ParallelContext(rows=2, cols=2), run, device="cpu")


def test_importing_mesh_starts_no_process_group():
    code = ("import torch.distributed as dist; "
            "import repro_torch.core.mesh, repro_torch.core.collectives, "
            "repro_torch.core.summa, repro_torch.testing.mdchecks; "
            "print(dist.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_wrappers_take_plain_version_for_cpu_tensors():
    """A kernel wrapper handed CPU tensors returns the plain version's
    result and launches nothing."""
    kops.reset_launches()
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v = t(1, 4, 24, 64), t(1, 2, 24, 64), t(1, 2, 24, 64)
    got = flash_fwd(q, k, v, q_start=None, local_window=8)
    want = flash_fwd_plain(q, k, v, q_start=None, local_window=8)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pk, pv = t(6, 4, 2, 64), t(6, 4, 2, 64)
    table = torch.tensor([[1, 2, 3], [0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([9, 0], dtype=torch.int32)
    kv_map = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    qd = t(2, 4, 64)
    torch.testing.assert_close(
        paged_attention(qd, pk, pv, table, pos, kv_map),
        paged_attention_plain(qd, pk, pv, table, pos, kv_map), rtol=0, atol=0)
    dout, lse, delta = t(1, 4, 24, 64), want[1], t(1, 4, 24)
    torch.testing.assert_close(
        flash_dq(q, k, v, dout, lse, delta, q_start=None),
        flash_dq_plain(q, k, v, dout, lse, delta, q_start=None),
        rtol=0, atol=0)
    for a, b in zip(flash_dkv(q, k, v, dout, lse, delta, local_window=8),
                    flash_dkv_plain(q, k, v, dout, lse, delta,
                                    local_window=8)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    a, b = t(2, 3, 8), t(2, 8, 5)
    torch.testing.assert_close(tesseract_mm(a, b), tesseract_mm_plain(a, b),
                               rtol=0, atol=0)
    c = t(3, 5)
    want = tesseract_mm_stream_plain(a[0], b[0], c)
    torch.testing.assert_close(tesseract_mm_stream(a[0], b[0], c), want,
                               rtol=0, atol=0)
    assert kops.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                             "paged_attention": 0, "ssd_intra": 0,
                             "tesseract_mm": 0, "tesseract_mm_stream": 0}


def test_attn_impl_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert kops.effective_attn_impl("auto", cpu) == "jnp"
    assert kops.effective_attn_impl("auto", cuda) == "pallas"
    assert kops.effective_attn_impl("pallas", cpu) == "pallas"
    assert kops.effective_attn_impl("jnp", cuda) == "jnp"
    with pytest.raises(ValueError):
        kops.effective_attn_impl("triton", cpu)


def test_unported_features_raise():
    with pytest.raises(TypeError):             # pipeline knobs: not copied
        RunConfig(pipe_stages=2)
    # LAMB and remat="dots" are ported; the optimizer is validated as the
    # reference validates it
    assert RunConfig(optimizer="lamb").optimizer == "lamb"
    assert RunConfig(remat="dots").remat == "dots"
    with pytest.raises(ValueError, match="optimizer"):
        RunConfig(optimizer="sgd")
    cfg = get_reduced("yi-6b").model
    model = build_model(cfg, ParallelContext(),
                        RunConfig(param_dtype="float32",
                                  compute_dtype="float32"), device="cpu")
    for knob in ({"prefix_cache": True}, {"prefill_chunk": 8},
                 {"spec_k": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngine(model, EngineConfig(**knob), device="cpu")
    # the engine's fault sites stay unported: a plan naming one is refused
    # (a train-only plan is not the engine's business)
    for plan, refused in (("serve.step@1:drop_step", True),
                          ("train.grads@1:nan;serve.logits@2:nan(1)", True),
                          ("train.grads@1:nan", False)):
        faulty = build_model(cfg, ParallelContext(),
                             RunConfig(param_dtype="float32",
                                       compute_dtype="float32",
                                       fault_plan=plan), device="cpu")
        if refused:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                InferenceEngine(faulty, EngineConfig(), device="cpu")
        else:
            InferenceEngine(faulty, EngineConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_reduced("recurrentgemma-9b")
    # ssm training is ported, on the reference's einsum path; with the SSD
    # kernel (use_pallas=True), which has no backward, it is refused
    shape = ShapeSpec("t", 16, 2, "train")
    for use_pallas in (False, True):
        ssm = build_model(get_reduced("mamba2-1.3b").model,
                          ParallelContext(),
                          RunConfig(use_pallas=use_pallas), device="cpu")
        if use_pallas:
            with pytest.raises(NotImplementedError, match="custom_vjp"):
                build_train_step(ssm, shape)
        else:
            build_train_step(ssm, shape)


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    eng = main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                "--requests", "3", "--prompt-lens", "5,11",
                "--new-tokens", "4", "--block-size", "4",
                "--num-blocks", "32", "--max-seq-len", "32"])
    assert eng.stats.tokens == 12 and eng.stats.failed == 0
    assert "attn_impl=jnp device=cpu" in capsys.readouterr().out
