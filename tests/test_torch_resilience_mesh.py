"""Fault tolerance across ranks, training and serving: two spawns of 4 CPU
ranks under torchrun with gloo, started together with the module's first
test.

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
  uninterrupted 4-rank run's within 1e-5.  In the same spawn the serve
  engine on that mesh (reduced yi-6b, fp32, the reference's 8 requests,
  8 slots, 128 blocks of 4): ``engine_elastic`` re-plans onto ranks 0-1
  after 3 steps (data 2 -> 1), the live KV blocks moved to their new KV
  groups, and keeps the uninterrupted run's ids; ``chaos_serve`` runs the
  reference's chaos plan with the device loss sized for four (a NaN row, a
  dropped step, pool exhaustion, a loss to 2 ranks, seed 17): one
  quarantine, one dropped step, one exhaustion, nothing failed, the
  fault-free ids, and a second run from the seed fires the same schedule
  and gives the same ids.

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
# The rank processes run at a lower CPU priority (nice 5): the suite's
# longest file, tests/test_multidevice.py, runs beside them and sets
# its wall time.
NICE = ("nice", "-n", "5")
# spawn: (ranks, data,depth,rows,cols, the checks it runs)
SPAWNS = {"train_restart": (4, "1,1,2,2", ("train_restart",)),
          "elastic": (4, "2,2,1,1", ("zero1_elastic", "engine_elastic",
                                     "chaos_serve"))}
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def spawns():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "repro_torch.testing.mdchecks",
         *checks, "--device", "cpu", "--layout", layout],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (n, layout, checks) in SPAWNS.items()}
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
    rc, out = spawns("elastic")
    assert rc == 0 and "PASS zero1_elastic" in out, out[-4000:]
    assert "replan 4 -> 2 ranks (data 2 -> 1, accum 2)" in out
    assert "embed state zn 4 -> 2" in out


def test_engine_elastic_on_cpu_ranks(spawns):
    rc, out = spawns("elastic")
    assert rc == 0 and "PASS engine_elastic" in out, out[-4000:]
    assert ("3 steps, then replan 4 -> 2 ranks (data 2 -> 1, 2 ranks idle); "
            "ids identical to the uninterrupted run" in out)


def test_chaos_serve_on_cpu_ranks(spawns):
    rc, out = spawns("elastic")
    assert rc == 0 and "PASS chaos_serve" in out, out[-4000:]
    line = next(x for x in out.splitlines() if "  chaos_serve: plan" in x)
    assert "device_loss(2) (seed 17)" in line
    # (quarantines, dropped steps, pool exhausts, preemptions, failed)
    counts = line.split("failed) (")[1].split(")")[0]
    q, d, e, _, f = (int(v) for v in counts.split(", "))
    assert q >= 1 and d == 1 and e == 1 and f == 0
    assert "ids identical to the fault-free run, the replay identical" in line

