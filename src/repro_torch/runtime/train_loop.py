"""Fault-tolerant training loop of the port (counterpart of
``repro.runtime.train_loop``).

The model's own parameters, on one card or on every rank of its mesh:
each step takes the step-keyed synthetic batch, the same on every rank,
from a ``Prefetcher`` that copies it to the model's device ahead of the
step, and runs ``build_train_step``, in which each rank keeps its block of
the batch.  Rank 0 prints.  As in the reference:

- checkpoint/restart: with ``ckpt_dir``, a checkpoint every
  ``ckpt_every`` steps (async: the state is copied to the host, then
  written on a thread, ``checkpoint/ckpt.py``) and a blocking one after
  the last step; a failure (any FloatingPointError, RuntimeError or
  ValueError) restores the newest checkpoint that passes its checks,
  falling back across damaged ones, and replays from the step after it;
  a checkpoint written under another layout (another mesh, the 1-D
  baseline, ZeRO-1 or not, the reference's) is resliced on restore;
- the restart budget: ``max_restarts`` restarts per replay window, and a
  window ends only when a checkpoint that passes its checks has landed
  after the last restore, so a corrupting or failing checkpoint directory
  plus a recurring fault still ends the run;
- non-finite steps: a skipped step (the step's guard left params and
  optimizer state bit-identical) retries the SAME batch up to
  ``run.nan_skip_limit`` times, then halves the static loss scale (floor
  1) and rebuilds the step, then raises FloatingPointError (a restart);
- deterministic fault injection (``runtime/faults.py``): ``train.step``
  (device loss, straggler delay), ``train.grads`` (NaN / Inf sent into the
  gradients through the step's fault port) and ``ckpt.write`` (the durable
  checkpoint damaged after its write) fire replayably by (seed, step); a
  device loss raises ``DeviceLostError`` past the restart budget, for the
  caller's elastic re-plan (``runtime/elastic.py``);
- straggler monitoring: each rank's step times, gathered across ranks once
  per log interval (``runtime/stragglers.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint.ckpt import CheckpointManager, load_state, state_to_host
from ..core import collectives as col
from ..core.mesh import AXES
from ..data.pipeline import Prefetcher, SyntheticLMStream
from ..optim.zero import make_ckpt_converter
from . import faults as faults_mod
from .faults import DeviceLostError
from .steps import build_train_step, init_opt_state
from .stragglers import StragglerMonitor


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)   # every step run, replays too
    loss_steps: list = field(default_factory=list)   # the step of each loss
    grad_norms: list = field(default_factory=list)
    step_times: list = field(default_factory=list)   # seconds, host clock
    last_step: int = -1
    restarts: int = 0
    nan_skips: int = 0             # non-finite steps whose update was skipped
    loss_scale_backoffs: int = 0   # loss-scale halvings after skip storms
    ckpt_fallbacks: int = 0        # damaged checkpoints skipped on restore
    fault_log: list = field(default_factory=list)  # injector firing order
    # seconds, host clock: "host_copy" (state to the host, each save),
    # "write" (each finished write, on its thread), "restore" (verify and
    # load, each restore)
    ckpt_seconds: dict = field(default_factory=lambda: {
        "host_copy": [], "write": [], "restore": []})


def train(model, shape, *, steps: int, seed: int = 0, log_every: int = 10,
          accum_steps: int | None = None, ckpt_dir=None,
          ckpt_every: int = 50, max_restarts: int = 3, fault_hook=None,
          stream=None, monitor=None, injector=None) -> TrainResult:
    """Run ``steps`` optimizer steps of ``model`` (a DenseLM or a MambaLM,
    on its device and mesh) on ``stream`` (default ``SyntheticLMStream(vocab,
    shape.global_batch, shape.seq_len, seed=seed)``), from the newest
    checkpoint in ``ckpt_dir`` or else from the model's current parameters
    and a fresh AdamW state (ZeRO-1 slices when ``run.zero_enabled``).

    ``accum_steps`` defaults to ``model.run.accum_steps`` (an elastic
    re-plan passes ``Replan.accum_steps``).  ``fault_hook(step)`` may raise
    to simulate a failure.  ``injector`` (``runtime/faults.FaultInjector``)
    defaults to the plan on ``model.run.fault_plan`` / ``fault_seed``,
    restricted to the train and ckpt sites; pass the same injector to the
    ``train`` after a re-plan so spent faults stay spent.  ``monitor`` is a
    ``StragglerMonitor`` (a fresh one by default).  A step's time is the
    host clock around the step, which ends in a device sync (the step reads
    its loss)."""
    run = model.run
    mesh = model.mesh
    accum = run.accum_steps if accum_steps is None else accum_steps
    if injector is None:
        injector = faults_mod.injector_from_run(run, sites=("train", "ckpt"))
    loss_scale = run.loss_scale
    step_fn = build_train_step(model, shape, accum_steps=accum)
    mgr = (CheckpointManager(ckpt_dir, mesh=mesh, device=model.device)
           if ckpt_dir is not None else None)
    # the port's checkpoints hold global optimizer leaves; the converter
    # makes a reference checkpoint's ZeRO-1 slices global too
    convert = make_ckpt_converter(None)
    monitor = monitor or StragglerMonitor()
    result = TrainResult()
    if injector is not None:
        result.fault_log = injector.fired   # live view, shared list
    if stream is None:
        stream = SyntheticLMStream(model.cfg.vocab_size, shape.global_batch,
                                   shape.seq_len, seed=seed)
    params = list(model.parameters())
    # the state a restart without a checkpoint goes back to
    init_params = [p.detach().to("cpu", copy=True) for p in params]
    rank0 = mesh.rank == 0
    pending_times: list = []

    def say(msg):
        if rank0:
            print(msg, flush=True)

    def flush_times():
        """Record every rank's pending step times in the monitor (one
        gather across ranks) and report the stragglers."""
        if not pending_times:
            return
        if mesh.size == 1:
            for dt in pending_times:
                monitor.record(0, dt)
        else:
            t = torch.tensor(pending_times, dtype=torch.float64,
                             device=model.device)
            got = col.all_gather_inv(mesh, t, AXES).cpu().numpy()
            for r, times in enumerate(got):
                for dt in times:
                    monitor.record(r, float(dt))
        pending_times.clear()
        slow = monitor.stragglers()
        if slow:
            say(f"[straggler] ranks {slow} over the fleet's step time: "
                f"{monitor.host_means()}")

    def init_state():
        with torch.no_grad():
            for p, t in zip(params, init_params):
                p.copy_(t)
        return init_opt_state(model)

    def restore_or_init():
        if mgr is not None:
            try:
                mgr.wait()   # flush an in-flight async save before reading
            except RuntimeError as e:
                say(f"[ckpt] pending async save failed: {e}")
            t0 = time.perf_counter()
            # newest first with integrity checks: a damaged checkpoint
            # (bit flip, truncation, torn manifest) is skipped, not loaded
            leaves, last = mgr.restore_latest(convert)
            result.ckpt_fallbacks += mgr.last_fallbacks
            if leaves is not None:
                opt = load_state(model, leaves)
                del leaves
                if model.device.type == "cuda":
                    torch.cuda.synchronize(model.device)
                result.ckpt_seconds["restore"].append(
                    time.perf_counter() - t0)
                say(f"[ckpt] restored step {last}")
                return opt, last + 1
        return init_state(), 0

    def save(step, blocking=False):
        t0 = time.perf_counter()
        state = state_to_host(model, opt)
        result.ckpt_seconds["host_copy"].append(time.perf_counter() - t0)
        mgr.save(step, state, blocking=blocking)

    def run_step(batch, step):
        """One optimizer step with the bounded non-finite retry and the
        loss-scale back-off; returns its metrics."""
        nonlocal step_fn, loss_scale
        attempts = 0
        while True:
            fb = batch
            if injector is not None:
                g = 1.0
                for spec in injector.fire("train.grads", step):
                    g = float("nan") if spec.kind == "nan" else float("inf")
                fb = dict(batch, fault_scale=g)
            metrics = step_fn(opt, fb)
            if not metrics["skipped"]:
                return metrics
            # params/opt are bit-identical: retry the SAME step-keyed batch
            attempts += 1
            result.nan_skips += 1
            say(f"[fault] step {step}: non-finite grads/loss, update "
                f"skipped (retry {attempts}/{run.nan_skip_limit}, "
                f"loss_scale={loss_scale:g})")
            if attempts <= run.nan_skip_limit:
                continue
            if loss_scale > 1.0:
                loss_scale = max(1.0, loss_scale / 2.0)
                result.loss_scale_backoffs += 1
                say(f"[fault] step {step}: backing loss_scale off to "
                    f"{loss_scale:g} and rebuilding the step")
                step_fn = build_train_step(model, shape, accum_steps=accum,
                                           loss_scale=loss_scale)
                attempts = 0
                continue
            raise FloatingPointError(
                f"non-finite grads persist at step {step} after "
                f"{run.nan_skip_limit} retries and loss-scale backoff")

    opt, start = restore_or_init()
    step = start
    budget_used = 0        # restarts within the current replay window
    window_start = start   # where the last restore landed us
    while step < steps:
        try:
            pf = Prefetcher(stream, model.device, start_step=step)
            try:
                while step < steps:
                    got_step, batch = pf.next()
                    assert got_step == step
                    if fault_hook is not None:
                        fault_hook(step)
                    if injector is not None:
                        for spec in injector.fire("train.step", step):
                            if spec.kind == "device_loss":
                                raise DeviceLostError(
                                    int(spec.arg),
                                    f"injected device loss at step {step}: "
                                    f"{int(spec.arg)} devices survive")
                            elif spec.kind == "straggler":
                                time.sleep(spec.arg)
                    t0 = time.perf_counter()
                    metrics = run_step(batch, step)
                    dt = time.perf_counter() - t0
                    loss = metrics["loss"]
                    pending_times.append(dt)
                    result.step_times.append(dt)
                    if not np.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss at {step}")
                    result.losses.append(loss)
                    result.loss_steps.append(step)
                    result.grad_norms.append(metrics["grad_norm"])
                    result.last_step = step
                    if log_every and step % log_every == 0:
                        flush_times()
                        say(f"step {step} loss {loss:.4f} "
                            f"gnorm {metrics['grad_norm']:.3f} "
                            f"({dt * 1e3:.0f} ms)")
                    step += 1
                    if mgr is not None and step % ckpt_every == 0:
                        save(step - 1)
                        if injector is not None:
                            for spec in injector.fire("ckpt.write", step - 1):
                                mgr.wait()   # damage the DURABLE artifact
                                if mgr.writer:
                                    p = faults_mod.corrupt_checkpoint(
                                        ckpt_dir, step - 1,
                                        mode=spec.mode or "bit_flip",
                                        leaf_index=int(spec.arg),
                                        seed=injector.plan.seed)
                                    say(f"[fault] injected ckpt corruption "
                                        f"({spec.mode or 'bit_flip'}): {p}")
            finally:
                pf.stop()
        except DeviceLostError as e:
            # a lost device is not fixed by a same-mesh restart: the caller
            # re-plans onto the survivors and calls train() again on the
            # new mesh (with the same injector, so spent faults stay
            # spent), which restores the last checkpoint: let an in-flight
            # save land first
            if mgr is not None:
                try:
                    mgr.wait()
                except RuntimeError as werr:
                    say(f"[ckpt] pending async save failed: {werr}")
            result.restarts += 1
            e.partial_result = result
            raise
        except (FloatingPointError, RuntimeError, ValueError) as e:
            result.restarts += 1
            if mgr is not None:
                # a checkpoint that passes its checks and landed after the
                # last restore starts a new replay window (judged after
                # flushing the writer, never by save() calls made)
                try:
                    mgr.wait()
                except RuntimeError as werr:
                    say(f"[ckpt] pending async save failed: {werr}")
                latest = mgr.latest_valid_step()
                if latest is not None and latest + 1 > window_start:
                    budget_used = 0
                    window_start = latest + 1
            budget_used += 1
            say(f"[fault] step {step}: {type(e).__name__}: {e}; "
                f"restart {budget_used}/{max_restarts} in this replay "
                f"window ({result.restarts} total)")
            if budget_used > max_restarts:
                raise
            opt, step = restore_or_init()
    flush_times()
    if mgr is not None:
        save(steps - 1, blocking=True)
        mgr.wait()
        result.ckpt_seconds["write"] = list(mgr.write_seconds)
    return result
