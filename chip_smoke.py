"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order (each prints its wall time); any failed check exits
non-zero and prints no result:

1. card: the GPU's name and power limit (nvidia-smi), and the build of the
   CUDA kernels from src/repro_torch/csrc with nvcc for sm_90a; ptxas must
   report no spills in the tensor-core kernels (the flash forward, dQ and
   dK/dV at D 64 and 128, the SUMMA kernel's wgmma route, and the SSD
   pass's TF32 kernel at P 16 and 64), and the wgmma route's SASS must
   hold wgmma (HGMMA) and TMA loads (UTMALDG);
2. kernels: each kernel against its plain PyTorch version on the card
   (flash forward, and the flash backward's dQ and dK/dV passes, at yi-6b
   and smollm-360m head shapes, Tq = Tk in {16, 1000, 2048}, q_start 0 /
   None, window 0 / 256, a fully masked case with exact-zero outputs and
   gradients, bf16 and fp32, and dQ and dK/dV each launched twice giving
   the same bits; the forward's position-derived tile skip: q_start None
   with the positions given and window 256, positions 37 past the keys,
   permuted positions, and a first block whose rows are all masked; paged
   decode with random tables, mixed positions with scratch slots, window 0
   / 64, a non-uniform kv_map, block sizes 8 / 16, and the split kernel's
   edges (a 256-page table with short positions, a window crossing a split
   boundary, every q head on one kv head), launched twice giving the same
   bits; the SSD intra-chunk pass
   at (H, P, N) = (64, 64, 128) and (4, 16, 16), Q in {256, 250, 143, 16,
   1}, B in {1, 2}, nc in {1, 8}, mild and steep decay, and launched twice
   giving the same bits);
3. summa kernels: the SUMMA contraction (kernel #1, tesseract_mm) and one
   ring step (kernel #2, tesseract_mm_stream) against their plain versions
   at yi-6b's per-rank projection shapes at q = 2 and at one rank (prefill
   and decode rows), at smollm-360m's train projections and mamba2-1.3b's
   prefill and decode projections at one rank and per rank at q = 2
   (partial G tiles), ragged E in {1, 3,
   1000}, T in {1, 2, 4}, the wgmma route's edges (E in {17, 64, 65, 129,
   1000}, F 2000, G in {64, 320, 960, 5504}, F and G below 64), bases 16
   but not 128 bytes past an allocation, F and G not multiples of 8, bf16
   and fp32: a repeat launch gives the same bits, the bf16 epilogue gives
   the fp32 C rounded, T launches of #2 agree with #1;
4. model parity: yi-6b at full width in fp32 (TF32 off), one 1000-token
   prefill and 8 paged decode steps through the kernels, then the same
   inputs teacher-forced through the plain versions: logits agree;
5. bf16 parity: yi-6b at full width in bf16, one prefill of 16 prompts of
   85..1000 tokens through the flash kernel and through the plain
   attention (#1 in both): logits within 5e-2 of their max, the same
   argmax wherever the plain run's top-2 margin exceeds that;
6. ring: the same request with matmul_schedule="ring" (kernel #2 in every
   projection) against "fused" (kernel #1): ids identical, logits within
   1e-4 of their max, only the schedule's kernel launched;
7. megatron: yi-6b at full width in fp32 (TF32 off), 4 layers, one
   1000-token prefill and 8 greedy paged decode steps through the 1-D
   baseline's op set at one rank (``ParallelContext(mode="megatron1d")``,
   ``MegatronOps``: its products are torch.matmul) against ``TesseractOps``
   on the same weights: ids identical, logits within 1e-4 of their max,
   the flash forward and paged decode launched once per layer per
   forward, kernel #1 not at all;
8. training parity: smollm-360m at full width and depth in fp32 (TF32
   off), B = 2, T = 1024: the loss and every gradient leaf through the
   kernels against the plain versions;
9. ssm parity: mamba2-1.3b at full width and depth in fp32 (TF32 off),
   B = 2, T = 1000 (the SSD kernel at Q = 250) and 8 greedy decode steps,
   then the same teacher-forced through the plain version: ids identical,
   every cache leaf within 1e-4 of its max; then the sequence-sharded
   prefill's SSD math: ``ssd_chunked`` through the SSD kernel on the two
   halves of 8 x 2048 tokens, chained by the mesh's local combine and
   correction, against the whole sequence's y and final state (within
   1e-4 of their max), and the kernel timed at the four-card prefill's
   per-rank shape;
10. serve: yi-6b at full width in bf16 through InferenceEngine (8 slots,
   block 16, 2048 blocks): 16 greedy requests of 128/512/1000/2000 prompt
   tokens and 32 new tokens each; the kernels' launch counters are zeroed
   just before and read just after, and must show the kernels ran (7
   tesseract_mm launches per layer of every prefill and decode step);
11. train: smollm-360m at full width and depth, fp32 params, bf16 compute,
   seq 2048 x batch 8, 10 steps through runtime/train_loop.train with the
   launch counters zeroed just before: finite losses starting near
   ln(vocab), no skipped step, 32 launches per step of each flash kernel
   and 7 x 32 of tesseract_mm; step time, tokens/s, peak memory, model
   FLOPs share and a profile;
   train features: the same 10 steps under remat="dots" (losses equal to
   phase 11's bit for bit; per step 64 flash forward launches, 32 of dQ
   and of dK/dV, 7 x 32 of tesseract_mm: the recompute hands the products
   back), 2 steps under remat="full" (2 x 7 x 32 tesseract_mm a step), the
   dots peak memory strictly between full's and phase 11's; one LAMB
   update at fp32 (B 2, T 1024) against a float64 host evaluation of the
   reference's formula with a trust ratio per stacked leaf (within 1e-6
   of each leaf's largest update), then 10 LAMB steps at bf16 compute on
   one batch: finite, none skipped, the last loss below the first;
12. train restart: the same run from the same weights through the
   fault-tolerant path (checkpoints every 3 steps into a temporary
   directory, a NaN at step 4, the step-5 checkpoint damaged, a crash
   before step 7): each step's loss equal to phase 11's bit for bit, one
   restart, one checkpoint fallback and one skipped step, and the
   kernels' launches exact for the 15 step executions (launch counters
   zeroed just before); the free disk space, the checkpoint's size, the
   save times (host copy, write) and the verify-and-restore time;
13. ssm serve: mamba2-1.3b at full width and depth in bf16, one prefill of
   8 prompts x 2048 tokens (Q = 256, nc = 8) and 32 greedy decode steps
   with the launch counters zeroed just before: exactly 48 SSD launches
   and 4 x 48 tesseract_mm launches per prefill and decode step, in-vocab
   ids, finite states; prefill time, decode step p50/p99, tokens/s, peak
   memory and a profiled prefill;
14. timings at the serve and train shapes: each kernel checked once more
   against its plain version on the exact inputs it times (flash at the
   2048 bucket and at the train shape, paged with a 256-entry table over
   the 2048-block pool, the backward passes and the forward at the train
   shape and at yi-6b's, the SSD pass at the ssm serve shape, the SUMMA
   kernels at yi-6b's q = 2 per-rank and one-rank gate/up shapes), then
   kernel, plain version and library call timed (CUDA events, median of
   20 launches with a cold L2), each beside the least time the card could
   take (bound) and, for the kernels redesigned last, the time recorded
   before the redesign (was_ms_recorded, a constant, not measured in the
   run); paged decode also its two kernels' device time under
   torch.profiler (device_ms: at that size the event span also holds the
   wrapper's host path); the bf16 outputs of dQ whose rounding differs
   from the plain version's; and the host time of one projection (the SUMMA
   wrapper against torch.matmul, and on the wgmma route, whose launch
   encodes two TMA descriptors);
15. the last line: {"ok": true, "device": {...}}.

The four-card mesh is not a phase (this script needs one card): it runs
under torchrun, ``python -m repro_torch.testing.mdchecks`` and
``python -m repro_torch.launch.serve`` (README.md).

It imports only repro_torch, torch, numpy and the standard library.
Weights and inputs are random, from fixed seeds.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np   # noqa: E402
import torch         # noqa: E402

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak (H100 SXM)
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth (H100 SXM)
ARCH = "yi-6b"
SERVE_PROMPTS = (128, 512, 1000, 2000)
SERVE_REQUESTS, SERVE_NEW = 16, 32
TRAIN_ARCH = "smollm-360m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2048, 8, 10
# the restart phase's faults: a NaN at step 4, the step-5 checkpoint
# damaged, a crash before step 7 (restores step 2, replays 3-6)
RESTART_PLAN = "train.grads@4:nan;ckpt.write@5:corrupt(0,bit_flip)"
RESTART_EVERY, RESTART_CRASH = 3, 7
RESTART_EXECS = TRAIN_STEPS + 1 + 4
H100_TF32_FLOPS = 495e12     # dense TF32 tensor-core peak (fp32 inputs)
H100_FP32_FLOPS = 67e12      # fp32 peak outside the tensor cores
SSM_ARCH = "mamba2-1.3b"
SSM_PROMPT, SSM_BATCH, SSM_NEW = 2048, 8, 32
SSD_TOL = 1e-4               # |kernel - plain| <= SSD_TOL * max |plain|
# |SUMMA kernel - plain| <= MM_TOL * max |plain|: the kernels sum up to
# T * F = 22016 products in fp32 in their tiles' order, the plain versions
# in float64 (a bf16 input is exact in both)
MM_TOL = 1e-4
DENSE_MM = 7                 # SUMMA contractions per dense layer: wq, wk,
                             # wv, wo, gate, up, down
SSM_MM = 4                   # per ssm layer: w_z, w_x, w_dt, w_out
# tensor-core kernel -> instances (D 64 and 128 for flash) in the build
TENSOR_CORE_KERNELS = {"flash_fwd_mma_kernel": 2, "flash_dkv_mma_kernel": 2,
                       "flash_dq_mma_kernel": 2,
                       "tesseract_mm_wgmma_kernel": 2,   # C loaded or not
                       "ssd_intra_mma_kernel": 2}        # P 16 and 64
# each redesigned kernel's time at its timing shape before the redesign,
# recorded (NVIDIA H100 80GB HBM3, 700 W; PERF.md) and printed as
# was_ms_recorded, not measured in the run: paged decode with one block
# per (q head, batch), the SSD pass on fp32 FMA
WAS_MS = {"paged_attention": 0.346, "ssd_intra": 2.120}


class CheckFailed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise CheckFailed(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- helpers

def time_ms(fn, iters=20, warmup=3):
    """Median of ``iters`` single-launch CUDA-event timings, each after an
    L2 flush (the serve path meets each layer's K/V and weights cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel, iters=20):
    """Device time per call of the kernels whose names hold ``kernel``,
    under torch.profiler, over ``iters`` calls each after an L2 flush as in
    ``time_ms``: the kernels' own time, without the host path that a
    CUDA-event span around a short call also holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key) \
        / 1e3 / iters


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phases

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({build.library_path().name})")
    report = build.library_path().with_suffix(".log")
    spills, entry = {}, ""
    if report.exists():
        for line in report.read_text().splitlines():
            if any(k in line for k in ("registers", "spill", "==",
                                       "entry function")):
                log("  ptxas:", line.strip())
            if "entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line and "mma_kernel" in entry:
                spills[entry] = line.strip()
    # the tensor-core kernels hold their accumulators in registers: a spill
    # would put them in local memory on every tile
    found = {k: sum(k in e for e in spills) for k in TENSOR_CORE_KERNELS}
    check(found == TENSOR_CORE_KERNELS and len(spills) == sum(found.values())
          and all(" 0 bytes spill stores, 0 bytes spill loads" in f" {v}"
                  for v in spills.values()),
          f"tensor-core kernels: expected {TENSOR_CORE_KERNELS} instances "
          f"with no spills, got {spills}")
    # the prefill route of #1/#2 issues wgmma (HGMMA) on TMA loads (UTMALDG)
    sass = subprocess.run(
        [str(pathlib.Path(build._nvcc()).parent / "cuobjdump"), "-sass",
         str(build.library_path())], capture_output=True, text=True,
        check=True).stdout
    ops = [{op: f.count(op) for op in ("HGMMA", "UTMALDG")}
           for f in sass.split("Function : ")
           if "tesseract_mm_wgmma_kernel" in f.split("\n", 1)[0]]
    log(f"  sass of tesseract_mm_wgmma_kernel's instances: {ops}")
    check(len(ops) == 2 and all(all(o.values()) for o in ops),
          f"tesseract_mm_wgmma_kernel: no HGMMA / UTMALDG in its SASS {ops}")
    return card


def _flash_case(gen, Hq, Hkv, D, T, q_start, window, dtype, q_pos=None):
    from repro_torch.kernels.flash_attention import flash_fwd, flash_fwd_plain
    q = randn(gen, 1, Hq, T, D, dtype=dtype)
    k = randn(gen, 1, Hkv, T, D, dtype=dtype)
    v = randn(gen, 1, Hkv, T, D, dtype=dtype)
    kw = dict(causal=True, local_window=window, q_pos=q_pos,
              q_start=q_start)
    out, lse = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    return out, lse, ref_out, ref_lse


def _tols(dtype):
    # fp32 (the FMA route): summation order only.  bf16 output: one to two
    # bf16 ulps at |x| <= 1.  The bf16 route's S = Q.K^T is exact bf16
    # products summed in fp32 on the tensor cores, its softmax fp32, and
    # P.V runs as lo.V + mid.V + hi.V with P cut exactly into three bf16
    # parts, so only the tensor cores' fp32 sums set its distance from the
    # plain version before the one rounding to bf16 (which then flips for
    # ~0.2% of outputs, by one ulp: 2^-6 at |x| in [2, 4), above this
    # limit, so the case data's few hundred such outputs must not flip).
    # lse is fp32 always
    return (1e-4 if dtype == torch.float32 else 1e-2), 1e-3


def _bwd_tol(dtype):
    # relative to the largest |gradient| of the case: fp32 (the FMA
    # routes) differs only in summation order (sums of up to ~6k fp32 terms
    # per entry, ~1e-6 relative), bf16 in one rounding of each output
    # (2^-8 relative at most).  In bf16 both passes run on the tensor cores
    # with fp32 sums: S (S^T) and dP (dP^T) from exact bf16 products, and
    # P^T and dS (dS^T) split into hi + lo bf16 parts (~2^-18 of each term)
    # where they enter dV, dQ and dK
    return 1e-4 if dtype == torch.float32 else 1e-2


def _bwd_inputs(gen, B, Hq, Hkv, D, T, dtype, **kw):
    """(q, k, v, dout and the forward's lse and delta, the forward's out),
    from the plain forward (so the backward is checked on its own)."""
    from repro_torch.kernels.flash_attention import flash_fwd_plain
    q = randn(gen, B, Hq, T, D, dtype=dtype)
    k = randn(gen, B, Hkv, T, D, dtype=dtype)
    v = randn(gen, B, Hkv, T, D, dtype=dtype)
    dout = randn(gen, B, Hq, T, D, dtype=dtype)
    out, lse = flash_fwd_plain(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1)
    return (q, k, v, dout, lse, delta), out


def _bwd_check(args, dtype, what, **kw):
    """dq, dk, dv of the kernels against the plain versions on ``args``;
    returns (kernel grads, largest |kernel - plain| of dQ, of dK/dV)."""
    from repro_torch.kernels.flash_attention import (flash_dkv,
                                                     flash_dkv_plain,
                                                     flash_dq,
                                                     flash_dq_plain)
    got = (flash_dq(*args, **kw), *flash_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = (flash_dq_plain(*args, **kw), *flash_dkv_plain(*args, **kw))
    torch.cuda.synchronize()
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e, scale = max_err(g, w), float(w.float().abs().max())
        check(e <= _bwd_tol(dtype) * scale,
              f"{what} {name}: err {e:.3g} vs max |grad| {scale:.3g}")
        errs.append(e)
    return got, errs[0], max(errs[1:])


def phase_bwd_kernels():
    """The flash backward's dQ and dK/dV kernels against their plain
    versions over the forward phase's grid, the fully masked case and a
    determinism check; returns the largest error of each."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"flash_dq": 0.0, "flash_dkv": 0.0}
    n = 0
    for Hq, Hkv, D in ((32, 4, 128), (15, 5, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            for T in (16, 1000, 2048):
                for q_start in (0, None):
                    for window in (0, 256):
                        kw = dict(causal=True, local_window=window,
                                  q_start=q_start)
                        args, _ = _bwd_inputs(gen, 1, Hq, Hkv, D, T, dtype,
                                              **kw)
                        _, e_dq, e_dkv = _bwd_check(
                            args, dtype, f"flash bwd Hq={Hq} D={D} T={T} "
                            f"q_start={q_start} window={window} {dtype}",
                            **kw)
                        worst["flash_dq"] = max(worst["flash_dq"], e_dq)
                        worst["flash_dkv"] = max(worst["flash_dkv"], e_dkv)
                        n += 1
            # rows whose positions precede every key, and keys no row sees
            T = 1000
            kw = dict(causal=True, q_start=None,
                      q_pos=torch.arange(T, device="cuda",
                                         dtype=torch.int32) - 70)
            args, _ = _bwd_inputs(gen, 1, Hq, Hkv, D, T, dtype, **kw)
            (dq, dk, dv), e_dq, e_dkv = _bwd_check(
                args, dtype, f"flash bwd masked Hq={Hq} {dtype}", **kw)
            check(bool((dq[:, :, :70] == 0).all())
                  and bool((dk[:, :, -70:] == 0).all())
                  and bool((dv[:, :, -70:] == 0).all()),
                  f"flash bwd fully masked rows/keys not exact zero "
                  f"({dtype})")
            worst["flash_dq"] = max(worst["flash_dq"], e_dq)
            worst["flash_dkv"] = max(worst["flash_dkv"], e_dkv)
            n += 1
    # dQ and dK/dV have no atomics: two launches give the same bits
    from repro_torch.kernels.flash_attention import flash_dkv, flash_dq
    args, _ = _bwd_inputs(gen, 2, 15, 5, 64, 2048, torch.bfloat16)
    a, b = flash_dkv(*args), flash_dkv(*args)
    dq_a, dq_b = flash_dq(*args), flash_dq(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "flash_dkv is not deterministic run to run")
    check(torch.equal(dq_a, dq_b), "flash_dq is not deterministic run to run")
    log(f"bwd kernel phase: {n} cases pass, dQ and dK/dV deterministic; max "
        f"|kernel - plain| dq {worst['flash_dq']:.3g}, dkv "
        f"{worst['flash_dkv']:.3g}")
    return worst


def phase_kernels():
    """Every kernel against its plain version; returns the largest output
    error of each over all cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"flash_fwd": 0.0, "paged_attention": 0.0}
    n = 0
    for Hq, Hkv, D in ((32, 4, 128), (15, 5, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            tol_out, tol_lse = _tols(dtype)
            for T in (16, 1000, 2048):
                for q_start in (0, None):
                    for window in (0, 256):
                        out, lse, r_out, r_lse = _flash_case(
                            gen, Hq, Hkv, D, T, q_start, window, dtype)
                        e_out, e_lse = max_err(out, r_out), max_err(lse, r_lse)
                        worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
                        check(e_out <= tol_out and e_lse <= tol_lse,
                              f"flash Hq={Hq} D={D} T={T} q_start={q_start} "
                              f"window={window} {dtype}: out err {e_out:.3g} "
                              f"lse err {e_lse:.3g}")
                        n += 1
            # rows whose positions precede every key: exact zeros, lse floor
            T = 1000
            q_pos = torch.arange(T, device="cuda", dtype=torch.int32) - 70
            out, lse, r_out, r_lse = _flash_case(
                gen, Hq, Hkv, D, T, None, 0, dtype, q_pos=q_pos)
            check(bool((out[:, :, :70] == 0).all())
                  and bool((lse[:, :, :70] == -1e25).all()),
                  f"flash fully masked rows not exact zero ({dtype})")
            e_out = max_err(out, r_out)
            worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
            check(e_out <= tol_out and max_err(lse, r_lse) <= tol_lse,
                  f"flash masked case {dtype}: out err {e_out:.3g}")
            n += 1
            n += _flash_skip_cases(gen, Hq, Hkv, D, dtype, worst)
            for bs in (8, 16):
                for window in (0, 64):
                    e = _paged_case(gen, Hq, Hkv, D, bs, window, dtype)
                    worst["paged_attention"] = max(worst["paged_attention"], e)
                    check(e <= tol_out,
                          f"paged Hq={Hq} D={D} bs={bs} window={window} "
                          f"{dtype}: err {e:.3g}")
                    n += 1
            for label, kw in PAGED_SPLIT_CASES:
                e = _paged_case(gen, Hq, Hkv, D, dtype=dtype, **kw)
                worst["paged_attention"] = max(worst["paged_attention"], e)
                check(e <= tol_out, f"paged {label} Hq={Hq} D={D} {dtype}: "
                                    f"err {e:.3g}")
                n += 1
    # the splits merge in a fixed order with no atomics: two launches give
    # the same bits
    from repro_torch.kernels.paged_attention import paged_attention
    args = _paged_inputs(gen, 32, 4, 128, 16, torch.bfloat16, max_len=4096,
                         pos=[144, 528, 1016, 2016, 4095, 9, 300, 0])
    a, b = paged_attention(*args), paged_attention(*args)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "paged_attention is not deterministic run to run")
    log(f"kernel phase: {n} cases pass, paged decode deterministic; max "
        f"|kernel - plain| flash {worst['flash_fwd']:.3g}, paged "
        f"{worst['paged_attention']:.3g}")
    return worst


def _flash_skip_cases(gen, Hq, Hkv, D, dtype, worst):
    """The bf16 route walks only the KV tiles its rows' positions can see
    (csrc/flash_fwd.cu, kv_tile_range): q_start None with the positions
    given and a window of 256 (the serve prefill's call, windowed), rows
    37 positions past the keys (Tk = Tq), permuted positions, and positions
    that start 100 before the keys with a window of 16, where the first
    block's rows are all masked and it walks no tile.  Rows that see no key
    must be exact zeros with lse = -1e25.  Returns the number of cases."""
    T = 1000
    tol_out, tol_lse = _tols(dtype)
    ar = torch.arange(T, device="cuda", dtype=torch.int32)
    perm = ar[torch.randperm(T, generator=gen, device="cuda")]
    cases = (("positions, window 256", ar, 256), ("arange + 37", ar + 37, 0),
             ("permuted", perm, 0), ("arange - 100, window 16", ar - 100, 16))
    for label, q_pos, window in cases:
        out, lse, r_out, r_lse = _flash_case(gen, Hq, Hkv, D, T, None, window,
                                             dtype, q_pos=q_pos)
        e_out, e_lse = max_err(out, r_out), max_err(lse, r_lse)
        worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
        check(e_out <= tol_out and e_lse <= tol_lse,
              f"flash {label} Hq={Hq} D={D} {dtype}: out err {e_out:.3g} "
              f"lse err {e_lse:.3g}")
        dead = q_pos < 0
        check(bool((out[:, :, dead] == 0).all())
              and bool((lse[:, :, dead] == -1e25).all()),
              f"flash {label} {dtype}: rows that see no key are not exact "
              f"zeros with lse -1e25")
    return len(cases)


def _paged_inputs(gen, Hq, Hkv, D, bs, dtype, max_len=2048, pos=None,
                  one_kv=False):
    """(q, pool_k, pool_v, table, pos, kv_map) for 8 slots over ``max_len``
    positions of ``bs``-position pages: random tables, slots 0 and 7
    retired (all scratch, pos 0), a random kv_map (or every q head sent to
    the last kv head, ``one_kv``)."""
    B = 8
    nb = max_len // bs
    P = B * nb + 1
    if pos is None:
        pos = [0, 5, bs - 1, bs, 700, 1500, max_len - 1, 0]
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * nb].reshape(B, nb).to(torch.int32)
    table[0] = 0                       # retired slots: all scratch, pos 0
    table[-1] = 0
    kv_map = torch.randint(0, Hkv, (Hq,), generator=gen, device="cuda",
                           dtype=torch.int32)
    if one_kv:
        kv_map.fill_(Hkv - 1)
    q = randn(gen, B, Hq, D, dtype=dtype)
    pk = randn(gen, P, bs, Hkv, D, dtype=dtype)
    pv = randn(gen, P, bs, Hkv, D, dtype=dtype)
    return q, pk, pv, table, pos, kv_map


def _paged_case(gen, Hq, Hkv, D, bs, window, dtype, **kw):
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    args = _paged_inputs(gen, Hq, Hkv, D, bs, dtype, **kw)
    out = paged_attention(*args, local_window=window)
    torch.cuda.synchronize()
    ref = paged_attention_plain(*args, local_window=window)
    torch.cuda.synchronize()
    return max_err(out, ref)


# the split kernel's edges (csrc/paged_attention.cu; splits of
# SPLIT_POSITIONS = 128 positions at bs 16): a 256-page table whose slots
# sit in its first pages (every later split empty), a window of 100 that
# crosses a split boundary (pos 300, 520, 1030), and every q head sent to
# one kv head (more q heads than a block takes in one pass; the other kv
# heads serve none)
PAGED_SPLIT_CASES = (
    ("256-page table, short positions",
     dict(bs=16, window=0, max_len=4096, pos=[0, 3, 17, 100, 255, 256, 300,
                                              0])),
    ("window crossing a split boundary",
     dict(bs=16, window=100, pos=[300, 520, 1030, 2000, 257, 700, 1500, 0])),
    ("every q head to one kv head",
     dict(bs=16, window=0, one_kv=True)))


def _model(arch, param_dtype, compute_dtype, attn_impl, **run_kw):
    """Full-width ``arch`` on the card with random weights from seed 0
    (remat off unless ``run_kw`` says otherwise: the train phases keep
    every activation)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model, get_arch
    run = RunConfig(param_dtype=param_dtype, compute_dtype=compute_dtype,
                    attn_impl=attn_impl, **{"remat": "none", **run_kw})
    ctx = ParallelContext(mode="tesseract", attn_impl=attn_impl)
    return build_model(get_arch(arch).model, ctx, run, device="cuda", seed=0)


def _prefill_decode(model, prompt, steps, feed=None):
    """One ``prompt``-token request through ``model.prefill`` (the next
    bucket of 1024) and ``steps`` paged decode steps, greedy or fed the ids
    ``feed``.  Returns (logits per step, the ids fed)."""
    from repro_torch.runtime.steps import paged_reshard
    bs, bucket = 16, -(-prompt // 1024) * 1024
    rng = np.random.RandomState(2)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :prompt] = rng.randint(0, model.cfg.vocab_size, prompt)
    n_blocks = (bucket + steps) // bs + 2
    table = torch.arange(1, n_blocks, dtype=torch.int32,
                         device="cuda")[None]
    lengths = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    shape, dt = model.paged_cache_shape(n_blocks, bs)
    pool = {k: torch.zeros(shape, dtype=dt, device="cuda")
            for k in ("k", "v")}
    logits, pcache = model.prefill(torch.from_numpy(tokens).cuda(), lengths)
    paged_reshard(pool, pcache, table[:, :bucket // bs])
    out, ids = [logits], []
    for t in range(steps):
        nxt = feed[t] if feed else int(out[-1].argmax(-1))
        ids.append(nxt)
        ids_t = torch.tensor([[nxt]], dtype=torch.int32, device="cuda")
        pos = torch.tensor([prompt + t], dtype=torch.int32, device="cuda")
        out.append(model.decode_paged(pool, table, ids_t, pos))
    torch.cuda.synchronize()
    return out, ids


def phase_parity():
    """Full-width fp32: kernels vs plain versions through the model."""
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("parity: float32, TF32 off for matmul and cuDNN")
    model = _model(ARCH, "float32", "float32", "pallas")
    L, prompt, steps = model.cfg.num_layers, 1000, 8
    kops.reset_launches()
    kern, ids = _prefill_decode(model, prompt, steps)
    check(kops.LAUNCHES["flash_fwd"] == L
          and kops.LAUNCHES["paged_attention"] == L * steps
          and kops.LAUNCHES["tesseract_mm"] == DENSE_MM * L * (1 + steps),
          f"parity run did not go through the kernels: {kops.LAUNCHES}")
    model.ctx = model.ctx.replace(attn_impl="jnp")
    plain, _ = _prefill_decode(model, prompt, steps, feed=ids)
    errs = [max_err(a, b) for a, b in zip(kern, plain)]
    scale = max(float(x.abs().max()) for x in plain)
    log(f"parity: {ARCH} L={L} fp32, prompt {prompt} + {steps} decode steps;"
        f" max |logit| {scale:.3g}; max |kernels - plain| per step "
        f"{['%.2e' % e for e in errs]}")
    check(all(np.isfinite(errs)) and max(errs) <= 1e-3,
          f"parity logits differ: {errs}")
    del model, kern, plain
    torch.cuda.empty_cache()


# |kernels - plain| <= BF16_MODEL_TOL * max |logit| in the bf16 model check:
# both runs round every layer's activations to bf16, so an attention output
# whose fp32 value sits near a bf16 rounding boundary can round one way in
# one run and the other way in the other (one bf16 ulp, 2^-8 relative), and
# that flip is carried through the later layers and the head; the kernels'
# own fp32 arithmetic differs from the plain versions' by ~1e-6 relative
BF16_MODEL_TOL = 5e-2


def phase_bf16_parity():
    """yi-6b at full width in bf16 through one prefill of 16 right-padded
    prompts (the first 1000 tokens of one random sequence cut at 16 lengths
    from 1000 down to 85, so the logits at each request's last position are
    that sequence's at 16 positions), through the kernels (flash forward and
    #1) and through attn_impl="jnp" (the plain attention, #1 in both runs):
    logits within BF16_MODEL_TOL of their max, and the same argmax wherever
    the plain run's top-2 margin exceeds that tolerance."""
    from repro_torch.kernels import ops as kops
    model = _model(ARCH, "bfloat16", "bfloat16", "pallas")
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    lengths = [1000 - 61 * i for i in range(16)]
    rng = np.random.RandomState(9)
    seq = rng.randint(0, vocab, 1000)
    tokens = np.zeros((len(lengths), 1024), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = seq[:n]
    tokens = torch.from_numpy(tokens).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    logits = {}
    for impl in ("pallas", "jnp"):
        model.ctx = model.ctx.replace(attn_impl=impl)
        kops.reset_launches()
        logits[impl] = model.prefill(tokens, lens)[0][:, :vocab].float()
        torch.cuda.synchronize()
        want = (L if impl == "pallas" else 0, DENSE_MM * L)
        got = (kops.LAUNCHES["flash_fwd"], kops.LAUNCHES["tesseract_mm"])
        check(got == want, f"bf16 parity {impl} run launched (flash_fwd, "
                           f"tesseract_mm) = {got}, want {want}")
    kern, plain = logits["pallas"], logits["jnp"]
    check(bool(torch.isfinite(kern).all()), "bf16 parity: non-finite logits")
    scale = float(plain.abs().max())
    err = max_err(kern, plain)
    top2 = plain.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > BF16_MODEL_TOL * scale
    same = kern.argmax(-1) == plain.argmax(-1)
    log(f"bf16 parity: {ARCH} L={L} bf16, 16 prompts of {lengths[-1]}.."
        f"{lengths[0]} tokens; max |kernels - plain| {err:.4g} of max "
        f"|logit| {scale:.4g} ({err / scale:.3g}, tolerance "
        f"{BF16_MODEL_TOL}); argmax identical at {int(same.sum())} of "
        f"{len(lengths)} positions, {int(sure.sum())} with a top-2 margin "
        f"above the tolerance, all identical there: "
        f"{bool(same[sure].all())}")
    check(err <= BF16_MODEL_TOL * scale, f"bf16 parity logits differ by "
                                         f"{err:.3g} of {scale:.3g}")
    check(bool(same[sure].all()), "bf16 parity: argmax differs where the "
                                  "plain run's margin exceeds the tolerance")
    del model, logits, kern, plain
    torch.cuda.empty_cache()


def phase_summa_ring():
    """yi-6b at full width in fp32 (TF32 off): one 1000-token prefill and 8
    greedy paged decode steps with matmul_schedule="ring" (kernel #2 in
    every projection) against the same with "fused" (kernel #1): ids
    identical, logits within 1e-4 of their max, and only the schedule's
    kernel launched.  Returns the ring run's launches."""
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(ARCH, "float32", "float32", "pallas")
    L, prompt, steps = model.cfg.num_layers, 1000, 8
    n = DENSE_MM * L * (1 + steps)
    runs = {}
    for sched in ("fused", "ring"):
        model.ctx = model.ctx.replace(matmul_schedule=sched)
        kops.reset_launches()
        runs[sched] = _prefill_decode(model, prompt, steps)
        launches = dict(kops.LAUNCHES)
        want = (n, 0) if sched == "fused" else (0, n)
        got = (launches["tesseract_mm"], launches["tesseract_mm_stream"])
        check(got == want, f"{sched} run launched (#1, #2) = {got}, want "
                           f"{want}")
    (fused, f_ids), (ring, r_ids) = runs["fused"], runs["ring"]
    scale = max(float(x.abs().max()) for x in fused)
    err = max(max_err(a, b) for a, b in zip(ring, fused))
    log(f"summa ring: {ARCH} L={L} fp32, prompt {prompt} + {steps} decode "
        f"steps: ids identical {r_ids == f_ids}; max |ring - fused| "
        f"{err:.3g} of max |logit| {scale:.3g}; ring launches {launches}")
    check(r_ids == f_ids, f"ring ids {r_ids} != fused ids {f_ids}")
    check(err <= 1e-4 * scale, f"ring logits differ by {err:.3g}")
    del model, runs, fused, ring
    torch.cuda.empty_cache()
    return launches


MEGATRON_LAYERS = 4


def phase_megatron():
    """yi-6b at full width in fp32 (TF32 off), MEGATRON_LAYERS layers: one
    1000-token prefill and 8 greedy paged decode steps through
    ``MegatronOps`` at one rank against ``TesseractOps`` on the same
    weights (both built from seed 0).  Each run's launch counters are
    zeroed just before it and read just after: both launch the flash
    forward (#3) once per layer of the prefill and paged decode (#6) once
    per layer of each step; Tesseract's projections launch #1 (7 per
    layer per forward), Megatron's (torch.matmul) none.  Ids identical,
    logits within 1e-4 of their max."""
    import dataclasses

    from repro_torch.configs.base import RunConfig
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels import ops as kops
    from repro_torch.models.registry import build_model, get_arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(ARCH).model,
                              num_layers=MEGATRON_LAYERS)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="pallas")
    L, prompt, steps = MEGATRON_LAYERS, 1000, 8
    runs = {}
    for mode in ("tesseract", "megatron1d"):
        model = build_model(cfg, ParallelContext(mode=mode,
                                                 attn_impl="pallas"),
                            run, device="cuda", seed=0)
        kops.reset_launches()
        runs[mode] = _prefill_decode(model, prompt, steps)
        launches = dict(kops.LAUNCHES)
        mm = DENSE_MM * L * (1 + steps) if mode == "tesseract" else 0
        want = (L, L * steps, mm, 0)
        got = (launches["flash_fwd"], launches["paged_attention"],
               launches["tesseract_mm"], launches["tesseract_mm_stream"])
        check(got == want, f"{mode} run launched (#3, #6, #1, #2) = {got}, "
                           f"want {want}")
        del model
        torch.cuda.empty_cache()
    (tess, t_ids), (meg, m_ids) = runs["tesseract"], runs["megatron1d"]
    scale = max(float(x.abs().max()) for x in tess)
    err = max(max_err(a, b) for a, b in zip(meg, tess))
    log(f"megatron: {ARCH} L={L} fp32, prompt {prompt} + {steps} decode "
        f"steps, MegatronOps vs TesseractOps at one rank: ids identical "
        f"{m_ids == t_ids}; max |megatron - tesseract| {err:.3g} of max "
        f"|logit| {scale:.3g}; megatron launches {launches}")
    check(m_ids == t_ids, f"megatron ids {m_ids} != tesseract ids {t_ids}")
    check(err <= 1e-4 * scale, f"megatron logits differ by {err:.3g}")
    del runs, tess, meg


def _train_batch(model, seq, batch, step=0):
    from repro_torch.data.pipeline import SyntheticLMStream
    stream = SyntheticLMStream(model.cfg.vocab_size, batch, seq, seed=0)
    return {k: torch.from_numpy(v).cuda()
            for k, v in stream.batch(step).items()}


def phase_train_parity():
    """Full-width fp32 training: the loss and every gradient leaf through
    the kernels (flash forward, dQ, dK/dV) against the plain versions."""
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(TRAIN_ARCH, "float32", "float32", "pallas")
    L = model.cfg.num_layers
    batch = _train_batch(model, 1024, 2)
    results = []
    for impl in ("pallas", "jnp"):
        model.ctx = model.ctx.replace(attn_impl=impl)
        kops.reset_launches()
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "pallas":
            check(kops.LAUNCHES["flash_fwd"] == kops.LAUNCHES["flash_dq"]
                  == kops.LAUNCHES["flash_dkv"] == L
                  and kops.LAUNCHES["tesseract_mm"] == DENSE_MM * L,
                  f"train parity did not go through the kernels: "
                  f"{kops.LAUNCHES}")
        results.append((loss.item(),
                        {n: p.grad.clone() for n, p in
                         model.named_parameters()}))
    (l_k, g_k), (l_p, g_p) = results
    worst, worst_name = 0.0, ""
    for name, gp in g_p.items():
        rel = max_err(g_k[name], gp) / max(float(gp.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"train parity: {TRAIN_ARCH} L={L} fp32 B=2 T=1024: loss kernels "
        f"{l_k:.6f} plain {l_p:.6f} (|diff| {abs(l_k - l_p):.2e}); largest "
        f"leaf max|diff| / max|grad| {worst:.2e} ({worst_name})")
    check(abs(l_k - l_p) <= 1e-4, f"train parity loss {l_k} vs {l_p}")
    check(worst <= 1e-3, f"train parity grads: {worst_name} {worst:.3g}")
    del model, results, g_k, g_p
    torch.cuda.empty_cache()


def phase_train():
    """The train slice's main path: smollm-360m at full width and depth,
    fp32 params and bf16 compute, through runtime/train_loop.train."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.train_loop import train
    model = _model(TRAIN_ARCH, "float32", "bfloat16", "auto")
    cfg, L = model.cfg, model.cfg.num_layers
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    res = train(model, shape, steps=TRAIN_STEPS, seed=0, log_every=1)
    torch.cuda.synchronize()
    launches = dict(kops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(len(res.losses) == TRAIN_STEPS and all(np.isfinite(res.losses)),
          f"train losses: {res.losses}")
    check(abs(res.losses[0] - np.log(cfg.vocab_size)) < 0.5,
          f"step 0 loss {res.losses[0]:.3f} not near ln(vocab) "
          f"{np.log(cfg.vocab_size):.3f}")
    check(res.nan_skips == 0, f"{res.nan_skips} steps skipped")
    want = L * TRAIN_STEPS
    check(launches["flash_fwd"] == launches["flash_dq"]
          == launches["flash_dkv"] == want,
          f"train launches {launches} != {L} x {TRAIN_STEPS} each")
    check(launches["tesseract_mm"] == DENSE_MM * want
          and launches["tesseract_mm_stream"] == 0,
          f"train: tesseract_mm launched {launches['tesseract_mm']} times, "
          f"want {DENSE_MM} x {L} x {TRAIN_STEPS} (one forward a step)")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    p50 = float(np.median(res.step_times))
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2          # causal (q, k) pairs
    # 6 N per token for the matmuls (N counts the head but not the
    # embedding table, whose lookup multiplies nothing), and the
    # attention's 4 D FLOPs per causal pair per q head forward, 8 D
    # backward (dQ 4 D: dO.V^T and dS.K; dK/dV 4 D: dS^T.Q and P^T.dO;
    # QK^T recomputed in both passes is not counted)
    n_matmul = cfg.param_count() - cfg.vocab_size * cfg.d_model
    flops = 6 * n_matmul * tokens \
        + 12 * model.D * pairs * cfg.num_heads * TRAIN_BATCH * L
    log(f"train: {TRAIN_ARCH} fp32 params bf16 compute L={L}, seq "
        f"{TRAIN_SEQ} x batch {TRAIN_BATCH}, {TRAIN_STEPS} steps: losses "
        f"{['%.4f' % x for x in res.losses]}")
    log(f"train: step time p50 {p50 * 1e3:.1f} ms (first step "
        f"{res.step_times[0] * 1e3:.1f} ms)")
    log(f"train: tokens/s {tokens / p50:.1f}")
    log(f"train: peak device memory {peak / 2**30:.2f} GiB")
    log(f"train: model FLOPs per step {flops:.4g}, {flops / p50 / 1e12:.1f} "
        f"TFLOP/s, {flops / p50 / H100_BF16_FLOPS:.4f} of the 989 TFLOP/s "
        f"bf16 peak")
    log(f"train launches: {launches}")
    profile_train_step(model, shape)
    del model
    torch.cuda.empty_cache()
    return launches, res.losses, peak


def _train_run(steps, stream=None, **run_kw):
    """``steps`` steps of phase_train's run (smollm-360m from seed 0, fp32
    params, bf16 compute, seq 2048 x batch 8, the seed-0 stream unless
    ``stream`` is given) with ``run_kw`` changed, the launch counters
    zeroed just before: (the TrainResult, the launches, the peak device
    memory in bytes)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.train_loop import train
    model = _model(TRAIN_ARCH, "float32", "bfloat16", "auto", **run_kw)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    res = train(model, shape, steps=steps, seed=0, log_every=1,
                stream=stream)
    torch.cuda.synchronize()
    launches = dict(kops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()
    return res, launches, peak


LAMB_CHECK_LR = 1.0  # one step's update as large as the params, so the
                     # fp32 rounding of the new params stays ~1e-7 of it


def _lamb_check():
    """One LAMB update on the card against a float64 host evaluation of
    the reference's formula: smollm-360m at full width in fp32 (TF32 off),
    B = 2, T = 1024, the second of two steps (so m and v are not zero);
    the trust ratios over each stacked reference leaf (``leaf_groups``).
    Fails unless every leaf's |update - float64 update| is within 1e-6
    of its max |float64 update|."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import lamb_update_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(TRAIN_ARCH, "float32", "float32", "auto",
                   optimizer="lamb")
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    update = lamb_update_fn(model, None)
    groups = update.keywords["leaf_groups"]
    opt = adamw_init(params)
    wd, b1, b2, eps = model.run.weight_decay, 0.9, 0.999, 1e-6
    for step in range(2):
        model.zero_grad(set_to_none=True)
        model.loss(_train_batch(model, 1024, 2, step=step)).backward()
        grads = [p.grad for p in params]
        if step == 1:
            host = [tuple(t.detach().cpu().numpy().copy() for t in leaf)
                    for leaf in zip(params, grads, opt["m"], opt["v"])]
        update(params, grads, opt, lr=LAMB_CHECK_LR, weight_decay=wd)
    torch.cuda.synchronize()
    # the bias corrections as the reference computes them, in fp32
    f32 = np.float32
    c1, c2 = (float(f32(1) - f32(b) ** f32(2)) for b in (b1, b2))
    worst, worst_name = 0.0, ""
    for g in range(max(groups) + 1):
        idx = [i for i, k in enumerate(groups) if k == g]
        us, pn2, un2 = [], 0.0, 0.0
        for i in idx:
            p0, gr, m0, v0 = (a.astype(np.float64) for a in host[i])
            m1 = b1 * m0 + (1 - b1) * gr
            v1 = b2 * v0 + (1 - b2) * gr * gr
            u = (m1 / c1) / (np.sqrt(v1 / c2) + eps) + wd * p0
            us.append(u)
            pn2 += float((p0 * p0).sum())
            un2 += float((u * u).sum())
        trust = (np.sqrt(pn2) / np.sqrt(un2) if pn2 > 0 and un2 > 0
                 else 1.0)
        for i, u in zip(idx, us):
            want = LAMB_CHECK_LR * trust * u
            got = host[i][0].astype(np.float64) \
                - params[i].detach().cpu().numpy().astype(np.float64)
            rel = float(np.abs(got - want).max()) / max(
                float(np.abs(want).max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, names[i]
    log(f"train features: LAMB update of {TRAIN_ARCH} (fp32, B=2 T=1024, "
        f"step 2, lr {LAMB_CHECK_LR}) against the float64 formula with the "
        f"trust ratio per stacked leaf ({max(groups) + 1} groups of "
        f"{len(params)} leaves): worst leaf |diff| / max |update| "
        f"{worst:.3g} ({worst_name})")
    check(worst <= 1e-6, f"LAMB update off the float64 formula by "
                         f"{worst:.3g} of max |update| ({worst_name})")
    del model, opt, host
    torch.cuda.empty_cache()


def phase_train_features(want_losses, none_peak):
    """remat="dots" and LAMB on phase_train's path.  dots: the same 10
    steps as phase_train (remat="none"): losses bit-equal to its own, each
    flash kernel's launches exact (#3 twice a layer a step: the recompute
    runs attention again; #4 and #5 once), #1 7 x 32 a step (the
    recompute hands the products back) and #2 none; its peak memory
    strictly between remat="full"'s (2 steps: #1 2 x 7 x 32 a step) and
    phase_train's.  LAMB: one fp32 update against the float64 formula
    (``_lamb_check``), then 10 bf16-compute steps through
    ``train(optimizer="lamb")`` on one batch (the stream's step-0 batch
    at every step: its tokens are uniform, so a new batch each step leaves
    nothing to learn in 10 warm-up steps, and only a batch seen again
    shows the optimizer fitting): finite losses, none skipped, the last
    below the first."""
    from repro_torch.models.registry import get_arch
    L = get_arch(TRAIN_ARCH).model.num_layers
    res, launches, peak = _train_run(TRAIN_STEPS, remat="dots")
    same = [a == b for a, b in zip(res.losses, want_losses)]
    p50 = float(np.median(res.step_times))
    log(f"train features: remat=dots, {TRAIN_STEPS} steps: losses "
        f"{['%.4f' % x for x in res.losses]}, bit-equal to phase_train's "
        f"(remat=none): {same}; step time p50 {p50 * 1e3:.1f} ms (first "
        f"{res.step_times[0] * 1e3:.1f} ms); peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    check(len(same) == TRAIN_STEPS and all(same),
          f"remat=dots losses {res.losses} != remat=none's {want_losses}")
    steps = L * TRAIN_STEPS
    want = {"flash_fwd": 2 * steps, "flash_dq": steps, "flash_dkv": steps,
            "tesseract_mm": DENSE_MM * steps, "tesseract_mm_stream": 0}
    check(all(launches[k] == n for k, n in want.items()),
          f"remat=dots launches {launches}, want {want}")
    fres, flaunches, fpeak = _train_run(2, remat="full")
    log(f"train features: remat=full, 2 steps: step times ms "
        f"{[round(t * 1e3, 1) for t in fres.step_times]}; peak device "
        f"memory {fpeak / 2**30:.2f} GiB; "
        f"launches {flaunches}")
    check(flaunches["tesseract_mm"] == 2 * DENSE_MM * L * 2,
          f"remat=full launched tesseract_mm {flaunches['tesseract_mm']} "
          f"times, want 2 x {DENSE_MM} x {L} x 2")
    log(f"train features: peak device memory GiB: remat=full "
        f"{fpeak / 2**30:.2f} < dots {peak / 2**30:.2f} < none "
        f"{none_peak / 2**30:.2f}")
    check(fpeak < peak < none_peak,
          f"remat=dots peak {peak} not strictly between full's {fpeak} and "
          f"none's {none_peak}")
    _lamb_check()
    from repro_torch.data.pipeline import SyntheticLMStream

    class OneBatch(SyntheticLMStream):
        def batch(self, step):
            return super().batch(0)

    one = OneBatch(get_arch(TRAIN_ARCH).model.vocab_size, TRAIN_BATCH,
                   TRAIN_SEQ, seed=0)
    lres, llaunches, lpeak = _train_run(TRAIN_STEPS, stream=one,
                                        optimizer="lamb")
    log(f"train features: optimizer=lamb, {TRAIN_STEPS} steps on the "
        f"step-0 batch (bf16 compute): losses "
        f"{['%.4f' % x for x in lres.losses]}, "
        f"skipped {lres.nan_skips}, step time p50 "
        f"{float(np.median(lres.step_times)) * 1e3:.1f} ms; peak device "
        f"memory {lpeak / 2**30:.2f} GiB; launches {llaunches}")
    check(len(lres.losses) == TRAIN_STEPS
          and all(np.isfinite(lres.losses)) and lres.nan_skips == 0,
          f"LAMB losses {lres.losses}, {lres.nan_skips} skipped")
    check(lres.losses[-1] < lres.losses[0],
          f"LAMB: last loss {lres.losses[-1]} not below the first "
          f"{lres.losses[0]}")


def _dir_bytes(path):
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def phase_train_restart(want_losses):
    """The fault-tolerant train path: phase_train's run again (the same
    seed-0 weights, stream and shape), with a checkpoint every
    RESTART_EVERY steps into a temporary directory and RESTART_PLAN's
    faults: a NaN at step 4 (one retry), the step-5 checkpoint damaged
    after its write, and a crash before step 7, which falls back across
    the damaged step-5 checkpoint to step 2 and replays steps 3-6.  Each
    step's loss must equal phase_train's bit for bit, and every kernel of
    the path must have launched its count per step execution (15 of
    them: 10 steps, the retry and 4 replayed)."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.runtime.train_loop import train
    model = _model(TRAIN_ARCH, "float32", "bfloat16", "auto")
    L = model.cfg.num_layers
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    usage = shutil.disk_usage(ckpt)
    log(f"train restart: checkpoints in {ckpt}: {usage.free / 2**30:.1f} "
        f"GiB free of {usage.total / 2**30:.1f} GiB")
    fired = []

    def crash(step):
        if step == RESTART_CRASH and not fired:
            fired.append(step)
            raise RuntimeError(f"injected crash before step {step}")

    try:
        torch.cuda.synchronize()
        kops.reset_launches()
        res = train(model, shape, steps=TRAIN_STEPS, seed=0, log_every=1,
                    ckpt_dir=ckpt, ckpt_every=RESTART_EVERY,
                    fault_hook=crash,
                    injector=FaultInjector(FaultPlan.parse(RESTART_PLAN)))
        torch.cuda.synchronize()
        launches = dict(kops.LAUNCHES)
        size = _dir_bytes(pathlib.Path(ckpt) / f"step_{TRAIN_STEPS - 1:08d}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    got = dict(zip(res.loss_steps, res.losses))
    execs = len(res.losses) + res.nan_skips
    log(f"train restart: {TRAIN_ARCH} fp32 params bf16 compute, plan "
        f"{RESTART_PLAN!r} + a crash before step {RESTART_CRASH}, "
        f"checkpoints every {RESTART_EVERY} steps: steps run "
        f"{res.loss_steps} (+{res.nan_skips} skipped), restarts "
        f"{res.restarts}, ckpt fallbacks {res.ckpt_fallbacks}, nan skips "
        f"{res.nan_skips}, fault log {res.fault_log}")
    same = [got.get(s) == want_losses[s] for s in range(TRAIN_STEPS)]
    log(f"train restart: losses per step equal phase_train's bit for bit: "
        f"{same}; largest |diff| "
        f"{max(abs(got[s] - want_losses[s]) for s in got):.3g}")
    secs = res.ckpt_seconds
    log(f"train restart: checkpoint {size / 2**30:.3f} GiB on disk "
        f"({size} bytes: fp32 params, m and v); save: host copy s "
        f"{[round(t, 3) for t in secs['host_copy']]}, write s (on its "
        f"thread) {[round(t, 3) for t in secs['write']]}; verify and "
        f"restore s {[round(t, 3) for t in secs['restore']]}; step ms "
        f"{[round(t * 1e3, 1) for t in res.step_times]}")
    log(f"train restart launches: {launches}")
    check(sorted(got) == list(range(TRAIN_STEPS)) and all(same),
          f"train restart losses {got} != phase_train's {want_losses}")
    check((res.restarts, res.ckpt_fallbacks, res.nan_skips) == (1, 1, 1),
          f"train restart: restarts {res.restarts}, fallbacks "
          f"{res.ckpt_fallbacks}, nan skips {res.nan_skips}, want 1 each")
    check(execs == RESTART_EXECS, f"train restart ran {execs} step "
                                  f"executions, want {RESTART_EXECS}")
    want = L * RESTART_EXECS
    check(launches["flash_fwd"] == launches["flash_dq"]
          == launches["flash_dkv"] == want
          and launches["tesseract_mm"] == DENSE_MM * want
          and launches["tesseract_mm_stream"] == 0,
          f"train restart launches {launches}: want {want} of each flash "
          f"kernel and {DENSE_MM} x {want} of tesseract_mm")
    del model
    torch.cuda.empty_cache()


def profile_train_step(model, shape):
    """Where a train step's time goes: one step after a warm-up step,
    under torch.profiler; device time by kernel and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import build_train_step
    step = build_train_step(model, shape)
    opt = adamw_init(list(model.parameters()),
                     master=model.run.master_weights)
    batch = _train_batch(model, shape.seq_len, shape.global_batch, step=100)
    step(opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms, _ in kernels)
    log(json.dumps({
        "profile": f"train step, {TRAIN_ARCH} seq {shape.seq_len} x batch "
                   f"{shape.global_batch}, bf16 compute",
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        "top_kernels_ms_calls": [[k[:80], ms, n]
                                 for k, ms, n in kernels[:12]]}))
    del opt


def phase_serve():
    """The main path: InferenceEngine at full width in bf16."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import EngineConfig, InferenceEngine, SamplingParams
    from repro_torch.serve.scheduler import FINISHED
    model = _model(ARCH, "bfloat16", "bfloat16", "auto")
    cfg = EngineConfig(n_slots=8, block_size=16, num_blocks=2048,
                       max_seq_len=4096)
    engine = InferenceEngine(model, cfg)
    check(engine.attn_impl == "pallas", f"auto resolved to {engine.attn_impl}")
    rng = np.random.RandomState(0)
    reqs = [engine.add_request(
        rng.randint(0, model.cfg.vocab_size,
                    SERVE_PROMPTS[i % len(SERVE_PROMPTS)]).tolist(),
        SamplingParams(max_new_tokens=SERVE_NEW))
        for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kops.LAUNCHES)
    s = engine.stats
    L = model.cfg.num_layers
    for r in reqs:
        toks = results[r.rid]
        check(r.state == FINISHED and len(toks) == SERVE_NEW,
              f"request {r.rid} ended {r.state} with {len(toks)} tokens")
        check(all(0 <= t < model.cfg.vocab_size for t in toks),
              f"request {r.rid}: out-of-vocab token")
    check(s.failed == 0 and s.nan_quarantines == 0,
          f"non-finite logits or failures: failed={s.failed} "
          f"quarantines={s.nan_quarantines}")
    check(launches["flash_fwd"] > 0 and launches["paged_attention"] > 0,
          f"a kernel never ran on the main path: {launches}")
    check(launches["flash_fwd"] == s.prefills * L,
          f"flash launches {launches['flash_fwd']} != prefills "
          f"{s.prefills} x {L}")
    check(launches["paged_attention"] == s.decode_steps * L,
          f"paged launches {launches['paged_attention']} != decode steps "
          f"{s.decode_steps} x {L}")
    check(launches["tesseract_mm"]
          == DENSE_MM * L * (s.prefills + s.decode_steps)
          and launches["tesseract_mm_stream"] == 0,
          f"tesseract_mm launches {launches['tesseract_mm']} != {DENSE_MM} "
          f"x {L} x (prefills {s.prefills} + decode steps "
          f"{s.decode_steps})")
    ttft, itl = s.ttft_percentiles(), s.itl_percentiles()
    log(f"serve: {ARCH} bf16 L={L}, {SERVE_REQUESTS} requests x "
        f"{SERVE_NEW} new tokens, prompts {SERVE_PROMPTS}: {s.steps} steps, "
        f"{s.prefills} prefills, {s.decode_steps} decode steps, "
        f"{s.preemptions} preemptions, wall {wall:.2f} s")
    log(f"serve: tokens/s {s.tokens / wall:.1f}; TTFT p50 "
        f"{ttft['p50_ms']:.1f} ms p99 {ttft['p99_ms']:.1f} ms; ITL p50 "
        f"{itl['p50_ms']:.1f} ms p99 {itl['p99_ms']:.1f} ms; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve launches: {launches}")
    counts = dict(steps=s.steps, prefills=s.prefills,
                  decode_steps=s.decode_steps)
    profile_decode(engine, rng)
    del engine, model
    torch.cuda.empty_cache()
    return launches, counts


def profile_decode(engine, rng, steps=8):
    """Where a decode step's time goes, after the counted run: 8 resident
    1000-token requests, ``steps`` engine steps under torch.profiler; device
    time by kernel name and the device's idle share of the (profiled)
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import SamplingParams
    vocab = engine.model.cfg.vocab_size
    for _ in range(engine.cfg.n_slots):
        engine.add_request(rng.randint(0, vocab, 1000).tolist(),
                           SamplingParams(max_new_tokens=steps + 3))
    engine.step()                  # admit + prefill all, first decode
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # kernel events only: a CPU op's device time repeats its kernels'
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    log(json.dumps({
        "profile": "decode step, 8 slots at ~1000 positions",
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        # kernel #6's launches: the split and the combine kernel
        "paged_attention_ms_per_step": sum(
            ms for k, ms in kernels if "paged_attention" in k),
        "top_kernels_ms_per_step": [[k[:80], ms] for k, ms in kernels[:10]]}))
    engine.run()


def _ssd_inputs(gen, B, nc, Q, H, P, N, steep):
    """x, log_a (about -0.01, or about -5 where the decay underflows far
    from the diagonal), B, C on the card, float32."""
    scale = 5.0 if steep else 0.01
    la = -scale * (0.5 + torch.rand(B, nc, Q, H, generator=gen,
                                    device="cuda"))
    return (randn(gen, B, nc, Q, H, P), la.contiguous(),
            randn(gen, B, nc, Q, N), randn(gen, B, nc, Q, N))


def _ssd_check(args, what):
    """The SSD kernel against its plain version on ``args``; returns (the
    kernel's outputs, the larger of its Y and S_c errors)."""
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    got = ssd_intra(*args)
    torch.cuda.synchronize()
    want = ssd_intra_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("Y", "S_c"), got, want):
        e, scale = max_err(g, w), float(w.abs().max())
        check(np.isfinite(e) and e <= SSD_TOL * scale,
              f"{what} {name}: err {e:.3g} vs max |plain| {scale:.3g}")
        worst = max(worst, e)
    return got, worst


def phase_ssd_kernels():
    """The SSD intra-chunk kernel against its plain version: the full width
    (H, P, N) = (64, 64, 128) and (4, 16, 16), Q in {256, 250, 143, 16, 1}
    (the chunks the model's shrink-to-divide rule gives), B in {1, 2},
    nc in {1, 8}, mild and steep decay; then two launches on the same
    inputs must give the same bits.  Returns the largest error."""
    from repro_torch.kernels.ssd import ssd_intra
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst, n = 0.0, 0
    for H, P, N in ((64, 64, 128), (4, 16, 16)):
        for Q in (256, 250, 143, 16, 1):
            for B in (1, 2):
                for nc in (1, 8):
                    for steep in (False, True):
                        args = _ssd_inputs(gen, B, nc, Q, H, P, N, steep)
                        _, e = _ssd_check(args, f"ssd H={H} P={P} N={N} "
                                          f"Q={Q} B={B} nc={nc} "
                                          f"steep={steep}")
                        worst = max(worst, e)
                        n += 1
    args = _ssd_inputs(gen, 2, 8, 250, 64, 64, 128, False)
    a, b = ssd_intra(*args), ssd_intra(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "ssd_intra is not deterministic run to run")
    log(f"ssd kernel phase: {n} cases pass (tolerance {SSD_TOL} x max "
        f"|plain|), two launches give the same bits; max |kernel - plain| "
        f"{worst:.3g}")
    return {"ssd_intra": worst}


def _mm_inputs(gen, T, E, F, G, dtype):
    """a [T, E, F] and b [T, F, G] (scaled so entries of C are ~1)."""
    return (randn(gen, T, E, F, dtype=dtype),
            (randn(gen, T, F, G) / F ** 0.5).to(dtype))


def _mm_check(a, b, what):
    """#1 against its plain version on (a, b), a repeat launch of #1, #1
    with a bf16 epilogue (bf16 inputs) against #1's fp32 C rounded, T
    launches of #2 against #1, and #2 against its plain version on a random
    accumulator.  Returns (errors of #1 and #2, #2 x T bit-equal to #1)."""
    from repro_torch.kernels.tesseract_mm import (tesseract_mm,
                                                  tesseract_mm_plain,
                                                  tesseract_mm_stream,
                                                  tesseract_mm_stream_plain)
    c = tesseract_mm(a, b)
    again = tesseract_mm(a, b)
    low = tesseract_mm(a, b, out_dtype=a.dtype)
    acc = torch.zeros_like(c)
    for t in range(a.shape[0]):
        tesseract_mm_stream(a[t], b[t], acc)
    c0 = torch.randn_like(c)
    step = tesseract_mm_stream(a[0], b[0], c0.clone())
    torch.cuda.synchronize()
    ref = tesseract_mm_plain(a, b)
    ref_step = tesseract_mm_stream_plain(a[0], b[0], c0)
    scale, scale_step = float(ref.abs().max()), float(ref_step.abs().max())
    e1, e_acc, e2 = (max_err(c, ref), max_err(acc, c),
                     max_err(step, ref_step))
    check(e1 <= MM_TOL * scale, f"tesseract_mm {what}: err {e1:.3g} vs max "
                                f"|plain| {scale:.3g}")
    check(torch.equal(c, again), f"tesseract_mm {what}: a repeat launch "
                                 f"gave other bits")
    check(low.dtype == a.dtype and torch.equal(low, c.to(a.dtype)),
          f"tesseract_mm {what}: the {a.dtype} epilogue differs from the "
          f"fp32 C rounded")
    check(e_acc <= MM_TOL * scale, f"tesseract_mm_stream x T {what}: "
                                   f"differs from #1 by {e_acc:.3g}")
    check(e2 <= MM_TOL * scale_step, f"tesseract_mm_stream {what}: err "
                                     f"{e2:.3g} vs max {scale_step:.3g}")
    return e1, e2, bool(torch.equal(acc, c))


def _path_mm_shapes():
    """(T, E, F, G) of the SUMMA contractions of the one-card paths other
    than the dense serve's: smollm-360m's train forward (E = seq x batch;
    wq/wo, wk/wv, gate/up, down) and its fp32 parity batch (E 2 x 1024),
    and mamba2-1.3b's projections (w_z/w_x, w_dt, w_out) at the serve
    phase's prefill and decode rows and the fp32 parity phase's (B 2 x T
    1000, decode B 2), and at T = q = 2 their per-rank blocks on the
    four-card mesh [1, 1, 2, 2] at that traffic (F and G halved; the
    prefill's rows over the two sequence shards, the decode's batch over
    them).  Their G of 960, 320, 64 and 32 end in a partial 128-wide tile,
    which yi-6b's widths never do."""
    from repro_torch.models.registry import get_arch
    sm, mb = get_arch(TRAIN_ARCH).model, get_arch(SSM_ARCH).model
    h, qd = sm.d_model, sm.num_heads * sm.resolved_head_dim
    kvd = sm.num_kv_heads * sm.resolved_head_dim
    train = {(h, qd), (h, kvd), (qd, h), (h, sm.d_ff), (sm.d_ff, h)}
    di = mb.ssm_expand * mb.d_model
    ssm = {(mb.d_model, di), (mb.d_model, di // mb.ssm_head_dim),
           (di, mb.d_model)}
    q = 2
    return ([(1, E, F, G) for E in (TRAIN_SEQ * TRAIN_BATCH, 2 * 1024)
             for F, G in sorted(train)]
            + [(1, E, F, G)
               for E in (SSM_BATCH * SSM_PROMPT, SSM_BATCH, 2 * 1000, 2)
               for F, G in sorted(ssm)]
            + [(q, E, F // q, G // q)
               for E in (SSM_BATCH * SSM_PROMPT // q, SSM_BATCH // q)
               for F, G in sorted(ssm)])


def _offset_copy(t, nbytes=16):
    """t copied into a view that starts ``nbytes`` past a fresh allocation:
    16-byte aligned, not 128-byte aligned."""
    n = nbytes // t.element_size()
    buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    return buf[n:].view(t.shape).copy_(t)


def phase_summa_kernels():
    """Kernels #1 and #2 against their plain versions: yi-6b's per-rank
    projection shapes at q = 2 (T 2; E 1024 and 4; F x G of wq/wo, wk/wv,
    gate/up, down) and at one rank (T 1; E 2048 and 8), the train and ssm
    paths' shapes, the ssm's per-rank ones at q = 2 among them
    (``_path_mm_shapes``), ragged E in {1, 3, 1000} at T in
    {1, 2, 4}, the wgmma route's edges (E in {17, 64, 65, 129, 1000} just
    past the skinny tile and around its 64-row halves, F 2000 not a multiple
    of its 64-deep stages, G in {64, 320, 960, 5504} ending inside a
    256-wide tile, T in {1, 2, 4}; F and G below one 64-wide box), bases
    16- but not 128-byte aligned, F x
    G = 100 x 60 (element-wise tile loads), bf16 and fp32; a repeat launch
    gives the same bits, the bf16 epilogue gives the fp32 C's bits
    rounded, and T launches of #2 agree with #1.  Returns the largest
    errors."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(2, E, F, G) for E in (1024, 4)
             for F, G in ((2048, 2048), (2048, 256), (2048, 5504),
                          (5504, 2048))]
    cases += [(1, E, F, G) for E in (2048, 8)
              for F, G in ((4096, 4096), (4096, 512), (4096, 11008),
                           (11008, 4096))]
    cases += _path_mm_shapes()
    cases += [(T, E, 2048, 256) for T in (1, 2, 4) for E in (1, 3, 1000)]
    cases += [(T, E, F, G) for E in (17, 64, 65, 129, 1000)
              for G in (64, 320, 960, 5504)
              for T, F in ((1, 2000), (2, 2048), (4, 2000))]
    # F and G below one 64-wide TMA box
    cases += [(1, 33, 24, 40), (2, 20, 56, 8)]
    # F and G not multiples of 8: the tiles load element by element
    cases += [(2, 5, 100, 60), (1, 200, 100, 60)]
    worst = {"tesseract_mm": 0.0, "tesseract_mm_stream": 0.0}
    bitwise = True
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for T, E, F, G in cases:
            a, b = _mm_inputs(gen, T, E, F, G, dtype)
            e1, e2, same = _mm_check(a, b, f"T={T} E={E} F={F} G={G} "
                                           f"{dtype}")
            worst["tesseract_mm"] = max(worst["tesseract_mm"], e1)
            worst["tesseract_mm_stream"] = max(worst["tesseract_mm_stream"],
                                               e2)
            bitwise &= same
            n += 1
            del a, b
    # TMA takes any 16-byte-aligned base: sliced views, as #2's a[t] are
    for T, E, F, G in ((2, 1000, 2048, 960), (1, 129, 2000, 320)):
        a, b = (_offset_copy(x) for x in _mm_inputs(gen, T, E, F, G,
                                                    torch.bfloat16))
        check(a.data_ptr() % 128 == 16 and b.data_ptr() % 128 == 16,
              "offset views are not 16 bytes past a 128-byte boundary")
        e1, e2, same = _mm_check(a, b, f"T={T} E={E} F={F} G={G} bf16 at "
                                       f"a 16-byte offset")
        worst["tesseract_mm"] = max(worst["tesseract_mm"], e1)
        worst["tesseract_mm_stream"] = max(worst["tesseract_mm_stream"], e2)
        bitwise &= same
        n += 1
        del a, b
    torch.cuda.empty_cache()
    log(f"summa kernel phase: {n} cases pass (tolerance "
        f"{MM_TOL} x max |plain|), repeat launches bit-identical, bf16 "
        f"epilogue = fp32 C rounded, #2 x T "
        f"{'bit-identical to' if bitwise else 'within tolerance of'} #1; max "
        f"|kernel - plain| #1 {worst['tesseract_mm']:.3g}, #2 "
        f"{worst['tesseract_mm_stream']:.3g}")
    return worst


def _host_us_per_projection(calls=2000):
    """Host time of one projection at one rank: ``tesseract_matmul`` (the
    SUMMA wrapper and kernel #1's launch) against ``torch.matmul``, each
    issued ``calls`` times back to back on decode-shaped [8, 1, 256] x
    [256, 256] bf16 operands (the skinny route), and ``tesseract_matmul``
    on 32 rows, [1, 32, 256] (the wgmma route, whose launch also encodes
    two TMA descriptors); their few microseconds of device time leave the
    host's issue rate as the wall time per call."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.summa import tesseract_matmul
    ctx = ParallelContext()
    mesh = Mesh(ctx)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = randn(gen, 8, 1, 256, dtype=torch.bfloat16)
    x32 = randn(gen, 1, 32, 256, dtype=torch.bfloat16)
    w = randn(gen, 256, 256, dtype=torch.bfloat16)
    us = {}
    for name, fn in (("tesseract_matmul",
                      lambda: tesseract_matmul(ctx, mesh, x, w)),
                     ("torch.matmul", lambda: torch.matmul(x, w)),
                     ("tesseract_matmul 32 rows",
                      lambda: tesseract_matmul(ctx, mesh, x32, w))):
        with torch.no_grad():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us[name] = 1e6 * (time.perf_counter() - t0) / calls
    log(f"host per projection (one rank, [8, 1, 256] x [256, 256] bf16, "
        f"{calls} calls): tesseract_matmul {us['tesseract_matmul']:.2f} us, "
        f"torch.matmul {us['torch.matmul']:.2f} us; [1, 32, 256] (wgmma "
        f"route, TMA descriptors encoded per launch): tesseract_matmul "
        f"{us['tesseract_matmul 32 rows']:.2f} us")


def phase_summa_timings(launches, ring_launches, worst):
    """Kernel / plain / library times of #1 and #2 in bf16 at the q = 2
    per-rank gate/up shape (T 2, E 1024, F 2048, G 5504), smollm-360m's
    train gate/up (E 16384, F 960, G 2560), mamba2-1.3b's prefill w_z/w_x
    (E 16384, F 2048, G 4096) and the one-rank gate/up (T 1, E 2048, F
    4096, G 11008), each checked once more on the timed inputs, and at
    the decode rows of the yi-6b projections (E 4 and 8);
    the kernels line carries the one-rank prefill shape (the last), the
    serve phase's launches for #1 and the ring phase's for #2.  #1 is timed
    as the fused schedule launches it, its C rounded to bf16 in the
    epilogue, and its library call is one bf16 ``torch.einsum`` (fp32
    accumulation, bf16 C); #2 adds a bf16 product into an fp32
    accumulator, and its library call is ``torch.addmm(c, a, b,
    out_dtype=torch.float32)`` (a new C: the same bytes, not in place).
    Then the host time of one projection."""
    from repro_torch.kernels.tesseract_mm import (tesseract_mm,
                                                  tesseract_mm_plain,
                                                  tesseract_mm_stream,
                                                  tesseract_mm_stream_plain)
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for label, T, E, F, G in (("q=2 per-rank decode gate/up", 2, 4, 2048,
                               5504),
                              ("one-rank decode gate/up", 1, 8, 4096, 11008),
                              ("q=2 per-rank gate/up", 2, 1024, 2048, 5504),
                              ("smollm-360m train gate/up", 1,
                               TRAIN_SEQ * TRAIN_BATCH, 960, 2560),
                              ("mamba2-1.3b prefill w_z/w_x", 1,
                               SSM_BATCH * SSM_PROMPT, 2048, 4096),
                              ("one-rank gate/up", 1, 2048, 4096, 11008)):
        a, b = _mm_inputs(gen, T, E, F, G, bf16)
        e1, e2, _ = _mm_check(a, b, f"timed {label}")
        worst["tesseract_mm"] = max(worst["tesseract_mm"], e1)
        worst["tesseract_mm_stream"] = max(worst["tesseract_mm_stream"], e2)
        acc = torch.zeros(E, G, dtype=f32, device="cuda")
        a0, b0 = a[0], b[0]
        t = {"tesseract_mm": (
                 time_ms(lambda: tesseract_mm(a, b, out_dtype=bf16)),
                 time_ms(lambda: tesseract_mm_plain(a, b, out_dtype=bf16)),
                 time_ms(lambda: torch.einsum("tef,tfg->eg", a, b))),
             "tesseract_mm_stream": (
                 time_ms(lambda: tesseract_mm_stream(a0, b0, acc)),
                 time_ms(lambda: tesseract_mm_stream_plain(a0, b0, acc)),
                 time_ms(lambda: torch.addmm(acc, a0, b0, out_dtype=f32)))}
        work = {"tesseract_mm": (2 * T * E * F * G,
                                 2 * (a.numel() + b.numel()) + 2 * E * G),
                "tesseract_mm_stream": (2 * E * F * G,
                                        2 * (E * F + F * G) + 8 * E * G)}
        library = {"tesseract_mm": "torch.einsum('tef,tfg->eg') in bf16",
                   "tesseract_mm_stream":
                       "torch.addmm(c, a, b, out_dtype=torch.float32)"}
        for name, (ms, plain_ms, library_ms) in t.items():
            flops, nbytes = work[name]
            bound_ms, bound_by = _bound(flops, nbytes)
            log(json.dumps({
                "timing": name, "shape_of": label,
                "shape": [T if name == "tesseract_mm" else 1, E, F, G],
                "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "library": library[name],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flops / ms / 1e9}))
            rows[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/tesseract_mm.cu",
                replaces=("src/repro/kernels/tesseract_mm.py:47"
                          if name == "tesseract_mm" else
                          "src/repro/kernels/tesseract_mm.py:113"),
                launches=(launches if name == "tesseract_mm"
                          else ring_launches)[name],
                max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        del a, b, acc, a0, b0
        torch.cuda.empty_cache()
    _host_us_per_projection()
    return [rows["tesseract_mm"], rows["tesseract_mm_stream"]]


def _ssm_model(param_dtype, compute_dtype, use_pallas):
    """Full-width, full-depth mamba2-1.3b on the card, weights from seed 0."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model, get_arch
    run = RunConfig(param_dtype=param_dtype, compute_dtype=compute_dtype,
                    use_pallas=use_pallas)
    return build_model(get_arch(SSM_ARCH).model, ParallelContext(), run,
                       device="cuda", seed=0)


def phase_ssm_parity():
    """Full-width fp32 (TF32 off): a B = 2, T = 1000 prefill (the kernel at
    Q = 250 in every layer) and 8 greedy decode steps through the SSD
    kernel, then the same weights and tokens through the plain version,
    teacher-forced with the kernel run's ids: ids identical, every cache
    leaf within 1e-4 of its largest magnitude."""
    import dataclasses
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _ssm_model("float32", "float32", True)
    L, B, T, steps = model.cfg.num_layers, 2, 1000, 8
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, T), generator=gen,
                           device="cuda")

    def run(feed):
        ids, cache = model.prefill(tokens)
        out_ids, caches = [ids], [cache]
        for t in range(steps):
            ids, cache = model.decode(cache, feed[t] if feed else ids)
            out_ids.append(ids)
            caches.append(cache)
        torch.cuda.synchronize()
        return out_ids, caches

    kops.reset_launches()
    k_ids, k_caches = run(None)
    check(kops.LAUNCHES["ssd_intra"] == L
          and kops.LAUNCHES["tesseract_mm"] == SSM_MM * L * (1 + steps),
          f"ssm parity did not go through the kernels: {kops.LAUNCHES}")
    model.run = dataclasses.replace(model.run, use_pallas=False)
    p_ids, p_caches = run(k_ids)
    check(kops.LAUNCHES["ssd_intra"] == L, "the plain run launched the kernel")
    same = [bool(torch.equal(a, b)) for a, b in zip(k_ids, p_ids)]
    worst, worst_at = 0.0, ""
    for step, (kc, pc) in enumerate(zip(k_caches, p_caches)):
        for name in pc:
            rel = max_err(kc[name], pc[name]) / max(
                float(pc[name].abs().max()), 1e-30)
            if not rel <= worst:
                worst, worst_at = rel, f"step {step} {name}"
    log(f"ssm parity: {SSM_ARCH} L={L} fp32 B={B} T={T} (Q=250) + {steps} "
        f"decode steps: ids identical per step {same}; largest cache leaf "
        f"max|kernel - plain| / max|plain| {worst:.3g} ({worst_at})")
    check(all(same), f"ssm parity ids differ: {same}")
    check(worst <= 1e-4, f"ssm parity cache: {worst_at} {worst:.3g}")
    del model, k_caches, p_caches
    torch.cuda.empty_cache()


def phase_ssm_serve():
    """The ssm slice's main path: mamba2-1.3b at full width and depth in
    bf16, one prefill of 8 prompts x 2048 tokens through the SSD kernel
    and 32 greedy decode steps, with the launch counters zeroed just
    before.  Returns (launches, the prefill's inputs for the profile)."""
    from repro_torch.kernels import ops as kops
    model = _ssm_model("bfloat16", "bfloat16", True)
    cfg, L = model.cfg, model.cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    t0 = time.perf_counter()
    ids, cache = model.prefill(tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, steps_s = [ids], []
    for _ in range(SSM_NEW):
        t1 = time.perf_counter()
        ids, cache = model.decode(cache, ids)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t1)
        out.append(ids)
    wall = time.perf_counter() - t0
    launches = dict(kops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ids_all = torch.cat(out, 1)
    check(launches["ssd_intra"] == L,
          f"ssd_intra launched {launches['ssd_intra']} times, want {L} "
          f"(once per layer of the one prefill, never in decode)")
    check(launches["tesseract_mm"] == SSM_MM * L * (1 + SSM_NEW)
          and launches["tesseract_mm_stream"] == 0,
          f"tesseract_mm launched {launches['tesseract_mm']} times, want "
          f"{SSM_MM} x {L} x (1 prefill + {SSM_NEW} decode steps)")
    check(bool(((ids_all >= 0) & (ids_all < cfg.vocab_size)).all()),
          "out-of-vocab token")
    check(all(bool(torch.isfinite(v).all()) for v in cache.values()),
          "non-finite cache")
    n_out = ids_all.numel()
    p50, p99 = (float(np.percentile(steps_s, q)) * 1e3 for q in (50, 99))
    log(f"ssm serve: {SSM_ARCH} bf16 L={L}, {SSM_BATCH} prompts x "
        f"{SSM_PROMPT} tokens, {SSM_NEW} decode steps")
    log(f"ssm serve: prefill (time to first token of the batch) "
        f"{prefill_s * 1e3:.1f} ms; decode step p50 {p50:.2f} ms p99 "
        f"{p99:.2f} ms; output tokens/s {n_out / wall:.1f} ({n_out} tokens "
        f"in {wall:.3f} s, prefill included); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"ssm serve launches: {launches}")
    profile_prefill(model, tokens)
    del model, cache
    torch.cuda.empty_cache()
    return launches


def profile_prefill(model, tokens):
    """Where an ssm prefill's time goes: one prefill after a warm-up
    prefill, under torch.profiler; device time by kernel, the SSD kernel's
    share and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model.prefill(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms, _ in kernels)
    ssd = sum(ms for k, ms, _ in kernels if "ssd_intra" in k)
    log(json.dumps({
        "profile": f"ssm prefill, {SSM_ARCH} bf16, {tokens.shape[0]} x "
                   f"{tokens.shape[1]} tokens",
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        "ssd_intra_ms": ssd,
        "ssd_intra_share_of_busy": ssd / busy if busy else None,
        "top_kernels_ms_calls": [[k[:80], ms, n]
                                 for k, ms, n in kernels[:15]]}))


def phase_ssd_timings(launches, worst):
    """The SSD kernel's row at the serve shape (B 8, nc 8, Q 256, H 64,
    P 64, N 128, fp32): checked against its plain version on the timed
    inputs, then kernel and plain version timed; no single PyTorch call
    computes this function (library_ms null)."""
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    gen = torch.Generator(device="cuda").manual_seed(8)
    B, nc, Q, H, P, N = SSM_BATCH, SSM_PROMPT // 256, 256, 64, 64, 128
    la = -(0.3 + 0.7 * torch.rand(B, nc, Q, H, generator=gen,
                                  device="cuda"))   # dt*A at init: ~ -0.7
    args = (randn(gen, B, nc, Q, H, P), la.contiguous(),
            randn(gen, B, nc, Q, N), randn(gen, B, nc, Q, N))
    _, e = _ssd_check(args, "ssd at the serve shape")
    worst["ssd_intra"] = max(worst["ssd_intra"], e)
    ms = time_ms(lambda: ssd_intra(*args))
    plain_ms = time_ms(lambda: ssd_intra_plain(*args))
    flops, nbytes, bound_ms, bound_by = _ssd_bound(args)
    log(json.dumps({"timing": "ssd_intra", "shape": [B, nc, Q, H, P, N],
                    "dtype": "float32", "ms": ms,
                    "was_ms_recorded": WAS_MS["ssd_intra"],
                    "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": bound_ms,
                    "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                    "fp32_cuda_core_ms": flops / H100_FP32_FLOPS * 1e3,
                    "launches_per_prefill": launches["ssd_intra"],
                    "tflops": flops / ms / 1e9}))
    return [dict(name="ssd_intra", route="cuda",
                 source="src/repro_torch/csrc/ssd.cu",
                 replaces="src/repro/kernels/ssd.py:24",
                 launches=launches["ssd_intra"],
                 max_abs_err=worst["ssd_intra"], ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]


def _ssd_bound(args):
    """(FLOPs, bytes, bound ms, bound by) of the SSD kernel on ``args``:
    the causal half of the Q x Q products (scores once per chunk, Y per
    head) and the chunk-end states, over the TF32 peak; each input read
    and each output written once, over the memory rate."""
    B, nc, Q, H, P = args[0].shape
    N = args[2].shape[-1]
    pairs = Q * (Q + 1) // 2
    flops = B * nc * (2 * pairs * N + H * (2 * pairs * P + 2 * Q * P * N))
    nbytes = 4 * (sum(a.numel() for a in args) + B * nc * Q * H * P
                  + B * nc * H * P * N)
    t_ops, t_bytes = flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_ssd_shards(worst):
    """The sequence-sharded prefill's SSD math on one card: mamba2-1.3b's
    ``ssd_chunked`` through #7 on the two halves of a batch of 8 x 2048
    tokens, the second half chained to the first by the mesh's local
    combine (``collectives.linear_scan_carry``) and correction
    (``models/ssm.py::chain_shard``), held to the whole sequence's y and
    final state within ``SSD_TOL`` of their max.  The decay is slow
    (log_a in -0.011..-0.001), so the first half's state reaches the
    second half's outputs; the halves unchained must miss by more.  Then
    #7 timed at the per-rank shape of the four-card prefill ([1, 1, 2, 2]:
    B 8, nc 4, Q 256, H 32, P 64, N 128), beside its bound."""
    from repro_torch.core.collectives import linear_scan_carry
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    from repro_torch.models.ssm import chain_shard, ssd_chunked
    gen = torch.Generator(device="cuda").manual_seed(17)
    B, T, H, P, N, chunk = SSM_BATCH, SSM_PROMPT, 64, 64, 128, 256
    x = randn(gen, B, T, H, P)
    la = -(0.001 + 0.01 * torch.rand(B, T, H, generator=gen, device="cuda"))
    Bm, Cm = randn(gen, B, T, N), randn(gen, B, T, N)
    y_full, h_full, _ = ssd_chunked(x, la, Bm, Cm, chunk, use_pallas=True)
    halves = (slice(0, T // 2), slice(T // 2, T))
    outs = [ssd_chunked(*(t[:, s].contiguous() for t in (x, la, Bm, Cm)),
                        chunk, use_pallas=True) for s in halves]
    a_all = torch.stack([o[2] for o in outs])
    b_all = torch.stack([o[1] for o in outs])
    ys = []
    for i, (s, (y, h, a)) in enumerate(zip(halves, outs)):
        y, h = chain_shard(y, h, a, la[:, s], Cm[:, s],
                           linear_scan_carry(a_all, b_all, i))
        ys.append(y)
    torch.cuda.synchronize()
    y_max, h_max = float(y_full.abs().max()), float(h_full.abs().max())
    e_y = max_err(torch.cat(ys, 1), y_full) / y_max
    e_h = max_err(h, h_full) / h_max
    e_off = max_err(torch.cat([o[0] for o in outs], 1), y_full) / y_max
    log(f"ssd shards: {SSM_ARCH} ssd_chunked on two halves of {B} x {T} "
        f"tokens, chained: y within {e_y:.3g} and the final state within "
        f"{e_h:.3g} of their max (unchained, y misses by {e_off:.3g})")
    check(e_y <= SSD_TOL and e_h <= SSD_TOL,
          f"ssd shards: chained halves off the whole sequence: y {e_y:.3g}, "
          f"state {e_h:.3g} of max")
    check(e_off > 100 * SSD_TOL, f"ssd shards: the first half's state "
          f"does not reach the second half's outputs ({e_off:.3g})")
    del x, la, Bm, Cm, y_full, h_full, outs, ys, a_all, b_all
    # #7 at the four-card per-rank shape
    Bl, nc, Q, Hl = SSM_BATCH, SSM_PROMPT // 2 // 256, 256, H // 2
    lal = -(0.3 + 0.7 * torch.rand(Bl, nc, Q, Hl, generator=gen,
                                   device="cuda"))
    args = (randn(gen, Bl, nc, Q, Hl, P), lal.contiguous(),
            randn(gen, Bl, nc, Q, N), randn(gen, Bl, nc, Q, N))
    _, e = _ssd_check(args, "ssd at the four-card per-rank shape")
    worst["ssd_intra"] = max(worst["ssd_intra"], e)
    ms = time_ms(lambda: ssd_intra(*args))
    plain_ms = time_ms(lambda: ssd_intra_plain(*args))
    flops, nbytes, bound_ms, bound_by = _ssd_bound(args)
    log(json.dumps({"timing": "ssd_intra, per rank of the four-card "
                              "prefill at [1, 1, 2, 2]",
                    "shape": [Bl, nc, Q, Hl, P, N], "dtype": "float32",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                    "max_abs_err": e}))
    del args
    torch.cuda.empty_cache()


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _time_fwd_train(worst):
    """#3 at the train shape, as the train step calls it (q_start = 0):
    checked against its plain version on the timed inputs, then timed
    beside its plain version, SDPA (causal, GQA) and its bound; logged as a
    second timing line of #3."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_fwd, flash_fwd_plain
    gen = torch.Generator(device="cuda").manual_seed(15)
    bf = torch.bfloat16
    tol_out, tol_lse = _tols(bf)
    B, Hq, Hkv, T, D = TRAIN_BATCH, 15, 5, TRAIN_SEQ, 64
    q, k, v = (randn(gen, B, Hq, T, D, dtype=bf),
               randn(gen, B, Hkv, T, D, dtype=bf),
               randn(gen, B, Hkv, T, D, dtype=bf))
    out, lse = flash_fwd(q, k, v, causal=True, q_start=0)
    torch.cuda.synchronize()
    r_out, r_lse = flash_fwd_plain(q, k, v, causal=True, q_start=0)
    e_out, e_lse = max_err(out, r_out), max_err(lse, r_lse)
    check(e_out <= tol_out and e_lse <= tol_lse,
          f"flash at the train shape: out err {e_out:.3g} lse err "
          f"{e_lse:.3g}")
    worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
    del out, lse, r_out, r_lse
    ms = time_ms(lambda: flash_fwd(q, k, v, causal=True, q_start=0))
    plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, causal=True,
                                              q_start=0))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = T * (T + 1) // 2
    bound_ms, bound_by = _bound(4 * D * pairs * Hq * B,
                                2 * (2 * q.numel() + k.numel() + v.numel())
                                + 4 * B * Hq * T)
    log(json.dumps({"timing": "flash_fwd", "shape_of": "train",
                    "shape": [B, Hq, Hkv, T, D], "dtype": "bfloat16",
                    "q_start": 0, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library": "scaled_dot_product_attention(is_causal, "
                               "enable_gqa)",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "tflops": 4 * D * pairs * Hq * B / ms / 1e9}))
    del q, k, v
    torch.cuda.empty_cache()


def phase_timings(launches, counts, worst):
    """Kernel / plain / library times at the serve phase's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_fwd, flash_fwd_plain
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    _time_fwd_train(worst)   # first, so the row's max_abs_err counts it
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    rows = []

    # flash at the largest serve bucket, as the engine calls it
    B, Hq, Hkv, T, D = 1, 32, 4, 2048, 128
    q, k, v = (randn(gen, B, Hq, T, D, dtype=bf),
               randn(gen, B, Hkv, T, D, dtype=bf),
               randn(gen, B, Hkv, T, D, dtype=bf))
    pos = torch.arange(T, device="cuda", dtype=torch.int32)
    tol_out, tol_lse = _tols(bf)
    out, lse = flash_fwd(q, k, v, q_pos=pos, causal=True, q_start=None)
    torch.cuda.synchronize()
    r_out, r_lse = flash_fwd_plain(q, k, v, q_pos=pos, causal=True,
                                   q_start=None)
    e_out, e_lse = max_err(out, r_out), max_err(lse, r_lse)
    check(e_out <= tol_out and e_lse <= tol_lse,
          f"flash at the serve shape: out err {e_out:.3g} lse err "
          f"{e_lse:.3g}")
    worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
    del out, lse, r_out, r_lse
    ms = time_ms(lambda: flash_fwd(q, k, v, q_pos=pos, causal=True,
                                   q_start=None))
    plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, q_pos=pos,
                                               causal=True, q_start=None))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = T * (T + 1) // 2                     # causal (q, k) pairs
    flops = 4 * D * pairs * Hq * B
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + 4 * B * Hq * T
    bound_ms, bound_by = _bound(flops, nbytes)
    rows.append(dict(
        name="flash_fwd", route="cuda",
        source="src/repro_torch/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:134",
        launches=launches["flash_fwd"], max_abs_err=worst["flash_fwd"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms))
    log(json.dumps({"timing": "flash_fwd", "shape_of": "serve",
                    "shape": [B, Hq, Hkv, T, D],
                    "dtype": "bfloat16", "q_start": None, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library": "scaled_dot_product_attention(is_causal)",
                    "launches_per_prefill": launches["flash_fwd"]
                    / counts["prefills"],
                    "launches_per_step": launches["flash_fwd"]
                    / counts["steps"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "tflops": flops / ms / 1e9}))

    # paged decode: 8 slots at the serve prompts plus half the new tokens
    B, bs, max_len = 8, 16, 4096
    nb, P = max_len // bs, 2048
    lens = [p + SERVE_NEW // 2 for p in SERVE_PROMPTS] * 2
    pos_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    perm = (torch.randperm(P - 1, generator=gen, device="cuda") + 1)
    table = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lens):
        need = n // bs + 1
        table[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
    kv_map = (torch.arange(Hq, device="cuda", dtype=torch.int32)
              // (Hq // Hkv)).to(torch.int32)
    qd = randn(gen, B, Hq, D, dtype=bf)
    pk, pv = randn(gen, P, bs, Hkv, D, dtype=bf), randn(gen, P, bs, Hkv, D,
                                                        dtype=bf)
    out = paged_attention(qd, pk, pv, table, pos_t, kv_map)
    torch.cuda.synchronize()
    e = max_err(out, paged_attention_plain(qd, pk, pv, table, pos_t, kv_map))
    check(e <= tol_out, f"paged at the serve shape: err {e:.3g}")
    worst["paged_attention"] = max(worst["paged_attention"], e)
    ms = time_ms(lambda: paged_attention(qd, pk, pv, table, pos_t, kv_map))
    dev_ms = device_ms(lambda: paged_attention(qd, pk, pv, table, pos_t,
                                               kv_map), "paged_attention")
    plain_ms = time_ms(lambda: paged_attention_plain(qd, pk, pv, table,
                                                     pos_t, kv_map))
    live = sum(n + 1 for n in lens)              # attended positions
    flops = 4 * D * live * Hq
    nbytes = live * Hkv * D * 2 * 2 + 2 * 2 * qd.numel() \
        + 4 * (B + B * nb + Hq)
    bound_ms, bound_by = _bound(flops, nbytes)
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:54",
        launches=launches["paged_attention"],
        max_abs_err=worst["paged_attention"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    log(json.dumps({"timing": "paged_attention",
                    "shape": [B, Hq, Hkv, D, bs], "positions": lens,
                    "dtype": "bfloat16", "ms": ms, "device_ms": dev_ms,
                    "was_ms_recorded": WAS_MS["paged_attention"],
                    "plain_ms": plain_ms,
                    "library_ms": None,
                    "launches_per_decode_step": launches["paged_attention"]
                    / counts["decode_steps"],
                    "launches_per_step": launches["paged_attention"]
                    / counts["steps"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "gb_per_s": nbytes / ms / 1e6}))
    return rows


def _time_bwd(gen, B, Hq, Hkv, T, D, worst):
    """dQ, dK/dV, their plain versions and SDPA's backward at one causal
    bf16 shape with q_start = 0 (as the train step calls them); the
    forward, dQ and dK/dV kernels are each checked against their plain
    versions on the timed inputs first."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_dkv,
                                                     flash_dkv_plain,
                                                     flash_dq,
                                                     flash_dq_plain,
                                                     flash_fwd)
    bf = torch.bfloat16
    kw = dict(causal=True, q_start=0)
    args, r_out = _bwd_inputs(gen, B, Hq, Hkv, D, T, bf, **kw)
    out, lse = flash_fwd(*args[:3], **kw)
    torch.cuda.synchronize()
    tol_out, tol_lse = _tols(bf)
    e_out, e_lse = max_err(out, r_out), max_err(lse, args[4])
    check(e_out <= tol_out and e_lse <= tol_lse,
          f"flash fwd timed shape B={B} Hq={Hq} D={D}: out err {e_out:.3g} "
          f"lse err {e_lse:.3g}")
    worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
    del out, lse, r_out
    (dq, _, _), e_dq, e_dkv = _bwd_check(args, bf, f"flash bwd timed shape "
                                         f"B={B} Hq={Hq} D={D}", **kw)
    # outputs whose bf16 rounding differs from the plain version's (dS is
    # split in two parts on the tensor cores)
    flips = int((dq != flash_dq_plain(*args, **kw)).sum())
    log(f"flash_dq B={B} Hq={Hq} D={D}: {flips} of {dq.numel()} bf16 "
        f"outputs differ from the plain version's")
    del dq
    worst["flash_dq"] = max(worst["flash_dq"], e_dq)
    worst["flash_dkv"] = max(worst["flash_dkv"], e_dkv)
    t = {"flash_dq": time_ms(lambda: flash_dq(*args, **kw)),
         "flash_dkv": time_ms(lambda: flash_dkv(*args, **kw))}
    plain = {"flash_dq": time_ms(lambda: flash_dq_plain(*args, **kw)),
             "flash_dkv": time_ms(lambda: flash_dkv_plain(*args, **kw))}
    q, k, v, dout = (a.detach().clone().requires_grad_(i < 3)
                     for i, a in enumerate(args[:4]))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (q, k, v), dout, retain_graph=True))
    del out
    pairs = T * (T + 1) // 2
    io = 2 * (args[0].numel() + args[1].numel() + args[2].numel()
              + args[3].numel()) + 4 * 2 * args[4].numel()
    bounds = {   # inputs read once, outputs written once; causal pairs
        "flash_dq": _bound(6 * D * pairs * Hq * B, io + 2 * q.numel()),
        "flash_dkv": _bound(8 * D * pairs * Hq * B,
                            io + 2 * 2 * k.numel())}
    return t, plain, library_ms, bounds


def phase_bwd_timings(launches, worst):
    """Kernel / plain / library times of the backward passes at the train
    phase's shape (smollm-360m) and at yi-6b's head shape."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    shapes = (("train", TRAIN_BATCH, 15, 5, TRAIN_SEQ, 64),
              ("yi-6b", 1, 32, 4, 2048, 128))
    for label, B, Hq, Hkv, T, D in shapes:
        t, plain, library_ms, bounds = _time_bwd(gen, B, Hq, Hkv, T, D,
                                                 worst)
        for name in ("flash_dq", "flash_dkv"):
            bound_ms, bound_by = bounds[name]
            log(json.dumps({
                "timing": name, "shape_of": label,
                "shape": [B, Hq, Hkv, T, D], "dtype": "bfloat16",
                "q_start": 0, "ms": t[name], "plain_ms": plain[name],
                "library_ms": library_ms,
                "library": "backward of scaled_dot_product_attention("
                           "is_causal, enable_gqa): dQ, dK and dV in one "
                           "call",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "launches_per_train_step": launches[name] / TRAIN_STEPS}))
            if label == "train":
                rows.append(dict(
                    name=name, route="cuda",
                    source="src/repro_torch/csrc/flash_bwd.cu",
                    replaces=("src/repro/kernels/flash_attention.py:287"
                              if name == "flash_dq" else
                              "src/repro/kernels/flash_attention.py:312"),
                    launches=launches[name], max_abs_err=worst[name],
                    ms=t[name], plain_ms=plain[name], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms))
        torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    try:
        card = phase(phase_card)
        worst = phase(phase_kernels)
        worst.update(phase(phase_bwd_kernels))
        worst.update(phase(phase_ssd_kernels))
        worst.update(phase(phase_summa_kernels))
        phase(phase_parity)
        phase(phase_bf16_parity)
        ring_launches = phase(phase_summa_ring)
        phase(phase_megatron)
        phase(phase_train_parity)
        phase(phase_ssm_parity)
        phase(phase_ssd_shards, worst)
        launches, counts = phase(phase_serve)
        train_launches, train_losses, train_peak = phase(phase_train)
        phase(phase_train_features, train_losses, train_peak)
        phase(phase_train_restart, train_losses)
        ssm_launches = phase(phase_ssm_serve)
        # the backward timings check the forward at the train shape too,
        # so they run before the forward's row is written
        bwd_rows = phase(phase_bwd_timings, train_launches, worst)
        rows = (phase(phase_timings, launches, counts, worst) + bwd_rows
                + phase(phase_ssd_timings, ssm_launches, worst)
                + phase(phase_summa_timings, launches, ring_launches, worst))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
