"""Training loop of the port (counterpart of ``repro.runtime.train_loop``).

The model's own parameters, on one card or on every rank of its mesh:
each step copies the step-keyed synthetic batch, the same on every rank,
to the model's device and runs ``build_train_step``, in which each rank
keeps its block of the batch.  Rank 0 prints.  The
reference's non-finite recovery ladder is kept: a skipped step (the step's
guard left params and optimizer state bit-identical) retries the SAME
batch up to ``run.nan_skip_limit`` times, then halves the static loss scale
(floor 1) and rebuilds the step, then raises FloatingPointError.
Checkpoint/restart, fault injection and the straggler monitor are not
ported yet (ROADMAP Queue A, item A3): ``ckpt_dir`` raises, and
``RunConfig`` refuses a fault plan.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.pipeline import SyntheticLMStream
from .steps import build_train_step, init_opt_state


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    step_times: list = field(default_factory=list)   # seconds, host clock
    last_step: int = -1
    nan_skips: int = 0             # non-finite steps whose update was skipped
    loss_scale_backoffs: int = 0   # loss-scale halvings after skip storms


def train(model, shape, *, steps: int, seed: int = 0, log_every: int = 10,
          accum_steps: int | None = None, ckpt_dir=None) -> TrainResult:
    """Run ``steps`` optimizer steps of ``model`` (a DenseLM, on its device
    and mesh) on ``SyntheticLMStream(vocab, shape.global_batch,
    shape.seq_len, seed=seed)``, from the model's current parameters and a
    fresh AdamW state (ZeRO-1 slices when ``run.zero_enabled``).
    ``accum_steps`` defaults to ``model.run.accum_steps``.  A step's time
    is the host clock around the step, which ends in a device sync (the
    step reads its loss)."""
    if ckpt_dir is not None:
        raise NotImplementedError(
            "checkpoint/restart is not supported by repro_torch yet "
            "(ROADMAP Queue A, item A3)")
    run = model.run
    accum = run.accum_steps if accum_steps is None else accum_steps
    loss_scale = run.loss_scale
    step_fn = build_train_step(model, shape, accum_steps=accum)
    stream = SyntheticLMStream(model.cfg.vocab_size, shape.global_batch,
                               shape.seq_len, seed=seed)
    opt = init_opt_state(model)
    result = TrainResult()
    rank0 = model.mesh.rank == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    def run_step(batch, step):
        nonlocal step_fn, loss_scale
        attempts = 0
        while True:
            metrics = step_fn(opt, batch)
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

    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in stream.batch(step).items()}
        t0 = time.perf_counter()
        metrics = run_step(batch, step)
        dt = time.perf_counter() - t0
        loss = metrics["loss"]
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at {step}")
        result.step_times.append(dt)
        result.losses.append(loss)
        result.grad_norms.append(metrics["grad_norm"])
        result.last_step = step
        if log_every and step % log_every == 0:
            say(f"step {step} loss {loss:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} ({dt * 1e3:.0f} ms)")
    return result
