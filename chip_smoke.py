"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero and prints no result:

1. card: the GPU's name and power limit (nvidia-smi), and the build of the
   CUDA kernels from src/repro_torch/csrc with nvcc for sm_90a;
2. kernels: each kernel against its plain PyTorch version on the card
   (flash forward at yi-6b and smollm-360m head shapes, Tq = Tk in
   {16, 1000, 2048}, q_start 0 / None, window 0 / 256, a fully masked case,
   bf16 and fp32; paged decode with random tables, mixed positions with
   scratch slots, window 0 / 64, a non-uniform kv_map, block sizes 8 / 16);
3. model parity: yi-6b at full width in fp32 (TF32 off), one 1000-token
   prefill and 8 paged decode steps through the kernels, then the same
   inputs teacher-forced through the plain versions: logits agree;
4. serve: yi-6b at full width in bf16 through InferenceEngine (8 slots,
   block 16, 2048 blocks): 16 greedy requests of 128/512/1000/2000 prompt
   tokens and 32 new tokens each; the kernels' launch counters are zeroed
   just before and read just after, and must show both kernels ran;
5. timings at the serve shapes: each kernel checked once more against its
   plain version on the exact serve-shape inputs (flash at the 2048 bucket,
   paged with a 256-entry table over the 2048-block pool), then kernel,
   plain version and library call timed (CUDA events, median of 20 launches
   with a cold L2), each beside the least time the card could take (bound);
6. the last line: {"ok": true, "device": {...}}.

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


def _model(dtype, attn_impl):
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model, get_arch
    run = RunConfig(param_dtype=dtype, compute_dtype=dtype,
                    attn_impl=attn_impl)
    ctx = ParallelContext(mode="tesseract", attn_impl=attn_impl)
    return build_model(get_arch(ARCH).model, ctx, run, device="cuda", seed=0)


def phase_parity():
    """Full-width fp32: kernels vs plain versions through the model."""
    from repro_torch.runtime.steps import paged_reshard
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("parity: float32, TF32 off for matmul and cuDNN")
    model = _model("float32", "pallas")
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


def phase_serve():
    """The main path: InferenceEngine at full width in bf16."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import EngineConfig, InferenceEngine, SamplingParams
    from repro_torch.serve.scheduler import FINISHED
    model = _model("bfloat16", "auto")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    try:
        card = phase_card()
        worst = phase_kernels()
        phase_parity()
        launches, counts = phase_serve()
        rows = phase_timings(launches, counts, worst)
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
