"""Fault-tolerant training across ranks: two spawns of 4 CPU ranks under
torchrun with gloo, started together with the module's first test.

- ``train_restart`` on [2, 2, 1] (``--layout 1,1,2,2``): on the fused
  schedule a NaN step, a damaged checkpoint and a crash, on the ring a NaN
  step and a crash with no checkpoint; each step's loss equals the
  uninterrupted run's on the same mesh within 1e-5, with one restart, one
  fallback (fused) and one skipped step; then the fused run's last
  checkpoint restores onto the 1-D baseline (megatron1d, cols 4), whose
  next loss equals the uninterrupted run's.
- ``zero1_elastic`` on data 2 x depth 2 with ZeRO-1 (``--layout
  2,2,1,1``): an injected device loss before step 4, ``replan`` onto 2
  ranks (data 1, accum 2), and ``train`` again on a mesh over ranks 0-1,
  the optimizer state resliced from zn 4 to zn 2: its losses continue the
  uninterrupted 4-rank run's within 1e-5.

The uninterrupted runs are the port's own on the same mesh, which
``tests/test_torch_summa.py`` (``train_parity``) holds to the port's one
rank and ``tests/test_torch_train.py`` to the reference.
"""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# check: (ranks, data,depth,rows,cols)
SPAWNS = {"train_restart": (4, "1,1,2,2"), "zero1_elastic": (4, "2,2,1,1")}
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def spawns():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "repro_torch.testing.mdchecks",
         name, "--device", "cpu", "--layout", layout],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (n, layout) in SPAWNS.items()}
    done = {}

    def result(name):
        if name not in done:
            out, _ = procs[name].communicate(timeout=SPAWN_TIMEOUT_S)
            done[name] = (procs[name].returncode, out)
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def test_train_restart_on_cpu_ranks(spawns):
    rc, out = spawns("train_restart")
    assert rc == 0 and "PASS train_restart" in out, out[-4000:]
    assert "(restarts, fallbacks, nan skips) (1, 1, 1)" in out
    assert "onto megatron1d cols 4" in out


def test_zero1_elastic_on_cpu_ranks(spawns):
    rc, out = spawns("zero1_elastic")
    assert rc == 0 and "PASS zero1_elastic" in out, out[-4000:]
    assert "replan 4 -> 2 ranks (data 2 -> 1, accum 2)" in out
    assert "embed state zn 4 -> 2" in out
