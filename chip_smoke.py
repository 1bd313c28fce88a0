"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero and prints no result:

1. card: the GPU's name and power limit (nvidia-smi), and the build of the
   CUDA kernels from src/repro_torch/csrc with nvcc for sm_90a;
2. kernels: each kernel against its plain PyTorch version on the card
   (flash forward, and the flash backward's dQ and dK/dV passes, at yi-6b
   and smollm-360m head shapes, Tq = Tk in {16, 1000, 2048}, q_start 0 /
   None, window 0 / 256, a fully masked case with exact-zero outputs and
   gradients, bf16 and fp32, and dK/dV launched twice giving the same
   bits; paged decode with random tables, mixed positions with scratch
   slots, window 0 / 64, a non-uniform kv_map, block sizes 8 / 16);
3. model parity: yi-6b at full width in fp32 (TF32 off), one 1000-token
   prefill and 8 paged decode steps through the kernels, then the same
   inputs teacher-forced through the plain versions: logits agree;
4. training parity: smollm-360m at full width and depth in fp32 (TF32
   off), B = 2, T = 1024: the loss and every gradient leaf through the
   kernels against the plain versions;
5. serve: yi-6b at full width in bf16 through InferenceEngine (8 slots,
   block 16, 2048 blocks): 16 greedy requests of 128/512/1000/2000 prompt
   tokens and 32 new tokens each; the kernels' launch counters are zeroed
   just before and read just after, and must show both kernels ran;
6. train: smollm-360m at full width and depth, fp32 params, bf16 compute,
   seq 2048 x batch 8, 10 steps through runtime/train_loop.train with the
   launch counters zeroed just before: finite losses starting near
   ln(vocab), no skipped step, 32 launches per step of each flash kernel;
   step time, tokens/s, peak memory, model FLOPs share and a profile;
7. timings at the serve and train shapes: each kernel checked once more
   against its plain version on the exact inputs it times (flash at the
   2048 bucket, paged with a 256-entry table over the 2048-block pool, the
   backward passes and the forward at the train shape and at yi-6b's),
   then kernel, plain
   version and library call timed (CUDA events, median of 20 launches with
   a cold L2), each beside the least time the card could take (bound);
8. the last line: {"ok": true, "device": {...}}.

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
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "==" in line:
                log("  ptxas:", line.strip())
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
    # fp32: summation order only; bf16 output: one to two bf16 ulps at
    # |x| <= 1 (the arithmetic is fp32 on both sides); lse is fp32 always
    return (1e-4 if dtype == torch.float32 else 1e-2), 1e-3


def _bwd_tol(dtype):
    # relative to the largest |gradient| of the case: fp32 differs only in
    # summation order (sums of up to ~6k fp32 terms per entry, ~1e-6
    # relative), bf16 in one rounding of each output (2^-8 relative at
    # most; the arithmetic is fp32 on both sides)
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
    # dK/dV has no atomics: two launches give the same bits
    from repro_torch.kernels.flash_attention import flash_dkv
    args, _ = _bwd_inputs(gen, 2, 15, 5, 64, 2048, torch.bfloat16)
    a, b = flash_dkv(*args), flash_dkv(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "flash_dkv is not deterministic run to run")
    log(f"bwd kernel phase: {n} cases pass, dK/dV deterministic; max "
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
            for bs in (8, 16):
                for window in (0, 64):
                    e = _paged_case(gen, Hq, Hkv, D, bs, window, dtype)
                    worst["paged_attention"] = max(worst["paged_attention"], e)
                    check(e <= tol_out,
                          f"paged Hq={Hq} D={D} bs={bs} window={window} "
                          f"{dtype}: err {e:.3g}")
                    n += 1
    log(f"kernel phase: {n} cases pass; max |kernel - plain| "
        f"flash {worst['flash_fwd']:.3g}, paged "
        f"{worst['paged_attention']:.3g}")
    return worst


def _paged_case(gen, Hq, Hkv, D, bs, window, dtype):
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    B, max_len = 8, 2048
    nb = max_len // bs
    P = B * nb + 1
    pos = torch.tensor([0, 5, bs - 1, bs, 700, 1500, max_len - 1, 0],
                       dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * nb].reshape(B, nb).to(torch.int32)
    table[0] = 0                       # retired slots: all scratch, pos 0
    table[-1] = 0
    kv_map = torch.randint(0, Hkv, (Hq,), generator=gen, device="cuda",
                           dtype=torch.int32)
    q = randn(gen, B, Hq, D, dtype=dtype)
    pk = randn(gen, P, bs, Hkv, D, dtype=dtype)
    pv = randn(gen, P, bs, Hkv, D, dtype=dtype)
    out = paged_attention(q, pk, pv, table, pos, kv_map, local_window=window)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q, pk, pv, table, pos, kv_map,
                                local_window=window)
    torch.cuda.synchronize()
    return max_err(out, ref)


def _model(arch, param_dtype, compute_dtype, attn_impl):
    """Full-width ``arch`` on the card with random weights from seed 0
    (remat off: the train phases keep every activation)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model, get_arch
    run = RunConfig(param_dtype=param_dtype, compute_dtype=compute_dtype,
                    attn_impl=attn_impl, remat="none")
    ctx = ParallelContext(mode="tesseract", attn_impl=attn_impl)
    return build_model(get_arch(arch).model, ctx, run, device="cuda", seed=0)


def phase_parity():
    """Full-width fp32: kernels vs plain versions through the model."""
    from repro_torch.runtime.steps import paged_reshard
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("parity: float32, TF32 off for matmul and cuDNN")
    model = _model(ARCH, "float32", "float32", "pallas")
    L, bs, prompt, bucket, steps = model.cfg.num_layers, 16, 1000, 1024, 8
    rng = np.random.RandomState(2)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :prompt] = rng.randint(0, model.cfg.vocab_size, prompt)
    n_blocks = (bucket + steps) // bs + 2
    table = torch.arange(1, n_blocks, dtype=torch.int32,
                         device="cuda")[None]
    lengths = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(tokens).cuda()

    def run(feed):
        shape, dt = model.paged_cache_shape(n_blocks, bs)
        pool = {k: torch.zeros(shape, dtype=dt, device="cuda")
                for k in ("k", "v")}
        logits, pcache = model.prefill(toks, lengths)
        paged_reshard(pool, pcache, table[:, :bucket // bs])
        out, ids = [logits], []
        for t in range(steps):
            nxt = feed[t] if feed else int(out[-1].argmax(-1))
            ids.append(nxt)
            ids_t = torch.tensor([[nxt]], dtype=torch.int32, device="cuda")
            pos = torch.tensor([prompt + t], dtype=torch.int32,
                               device="cuda")
            out.append(model.decode_paged(pool, table, ids_t, pos))
        torch.cuda.synchronize()
        return out, ids

    from repro_torch.kernels import ops as kops
    kops.reset_launches()
    kern, ids = run(None)
    check(kops.LAUNCHES["flash_fwd"] == L
          and kops.LAUNCHES["paged_attention"] == L * steps,
          f"parity run did not go through the kernels: {kops.LAUNCHES}")
    model.ctx = model.ctx.replace(attn_impl="jnp")
    plain, _ = run(ids)
    errs = [max_err(a, b) for a, b in zip(kern, plain)]
    scale = max(float(x.abs().max()) for x in plain)
    log(f"parity: {ARCH} L={L} fp32, prompt {prompt} + {steps} decode steps;"
        f" max |logit| {scale:.3g}; max |kernels - plain| per step "
        f"{['%.2e' % e for e in errs]}")
    check(all(np.isfinite(errs)) and max(errs) <= 1e-3,
          f"parity logits differ: {errs}")
    del model, kern, plain
    torch.cuda.empty_cache()


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
                  == kops.LAUNCHES["flash_dkv"] == L,
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
    return launches


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
        "top_kernels_ms_per_step": [[k[:80], ms] for k, ms in kernels[:10]]}))
    engine.run()


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_timings(launches, counts, worst):
    """Kernel / plain / library times at the serve phase's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_fwd, flash_fwd_plain
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
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
    log(json.dumps({"timing": "flash_fwd", "shape": [B, Hq, Hkv, T, D],
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
                    "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
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
    _, e_dq, e_dkv = _bwd_check(args, bf, f"flash bwd timed shape B={B} "
                                f"Hq={Hq} D={D}", **kw)
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
    try:
        card = phase_card()
        worst = phase_kernels()
        worst.update(phase_bwd_kernels())
        phase_parity()
        phase_train_parity()
        launches, counts = phase_serve()
        train_launches = phase_train()
        # the backward timings check the forward at the train shape too,
        # so they run before the forward's row is written
        bwd_rows = phase_bwd_timings(train_launches, worst)
        rows = phase_timings(launches, counts, worst) + bwd_rows
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
