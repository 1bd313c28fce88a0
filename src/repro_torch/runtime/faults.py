"""Seeded, deterministic fault injection (the port's copy of
``repro.runtime.faults``; pure Python and numpy, no JAX).

A ``FaultPlan`` is an immutable schedule of ``FaultSpec`` entries, each
pinned to a *site* (a hook point in the train loop, the serve engine or
the checkpoint layer) and a *step*.  Whether a fault fires at ``(site,
step)`` is a pure function of the plan; for random plans, a pure function
of ``(seed, site, kind, step)`` through a crc32-keyed digest (never
``hash()``: str hashing is salted per process), so the same seed gives
the same plan string as the reference's, in every process.

Sites and the kinds each accepts:

    train.step   device_loss(n) | straggler(seconds)
    train.grads  nan | inf            (scaled into the step's gradients
                                       through the batch's ``fault_scale``)
    ckpt.write   corrupt(leaf_index; mode=bit_flip|truncate|manifest)
    serve.step   device_loss(n) | straggler(seconds) | drop_step
                 | pool_exhaust(n_steps)
    serve.logits nan(slot) | inf(slot)
    serve.prefix evict | flush

The port's train loop (``runtime/train_loop.py``) wires the ``train.*``
and ``ckpt.*`` sites, and the serve engine (``serve/engine.py``) the
``serve.*`` sites.

A ``FaultInjector`` wraps a plan with once-per-occurrence semantics: each
spec fires on its first ``attempts`` executions of its (site, step) and
is then spent, so a restart that replays the step recovers instead of
dying again.  A fresh injector over the same plan reproduces the same
fired log.
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field, replace

import numpy as np

# site -> kinds accepted there
SITES = {
    "train.step": ("device_loss", "straggler"),
    "train.grads": ("nan", "inf"),
    "ckpt.write": ("corrupt",),
    "serve.step": ("device_loss", "straggler", "drop_step", "pool_exhaust"),
    "serve.logits": ("nan", "inf"),
    "serve.prefix": ("evict", "flush"),
}


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault occurrence.

    ``arg`` is the kind-specific number (surviving device count for
    device_loss, seconds for straggler, slot for serve.logits, held steps
    for pool_exhaust, leaf index for corrupt); ``mode`` the kind-specific
    string (corruption flavor).  ``attempts`` is how many executions of
    (site, step) the fault fires on before it is spent — attempts=1 is a
    transient fault a retry/replay survives, a large value models a
    persistent one."""
    site: str
    step: int
    kind: str
    arg: float = 0.0
    mode: str = ""
    attempts: int = 1

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"registered: {sorted(SITES)}")
        if self.kind not in SITES[self.site]:
            raise ValueError(f"kind {self.kind!r} not valid at {self.site!r} "
                             f"(accepts {SITES[self.site]})")
        if self.step < 0 or self.attempts < 1:
            raise ValueError(f"step >= 0 and attempts >= 1 required, got "
                             f"step={self.step} attempts={self.attempts}")

    def compact(self) -> str:
        s = f"{self.site}@{self.step}:{self.kind}"
        extra = []
        if self.arg:
            extra.append(f"{self.arg:g}")
        if self.mode:
            extra.append(self.mode)
        if extra:
            s += "(" + ",".join(extra) + ")"
        if self.attempts != 1:
            s += f"x{self.attempts}"
        return s


def _parse_spec(text: str) -> FaultSpec:
    """``site@step:kind[(arg[,mode])][xattempts]`` — e.g.
    ``train.grads@5:nan``, ``ckpt.write@4:corrupt(0,bit_flip)``,
    ``serve.logits@3:nan(1)x2``."""
    t = text.strip()
    attempts = 1
    # only a trailing x<digits> is an attempts suffix — an "x" inside a
    # site or kind name (serve.prefix, flush) is plain spelling
    m = re.search(r"x(\d+)$", t)
    if m:
        attempts = int(m.group(1))
        t = t[:m.start()]
    loc, _, rest = t.partition(":")
    site, _, step = loc.partition("@")
    kind, arg, mode = rest, 0.0, ""
    if "(" in rest:
        kind, _, args = rest.partition("(")
        args = args.rstrip(")")
        parts = [p.strip() for p in args.split(",") if p.strip()]
        for p in parts:
            try:
                arg = float(p)
            except ValueError:
                mode = p
    return FaultSpec(site=site.strip(), step=int(step), kind=kind.strip(),
                     arg=arg, mode=mode, attempts=attempts)


def _unit(seed: int, site: str, kind: str, step: int) -> float:
    """Uniform [0,1) digest, pure in (seed, site, kind, step)."""
    key = (seed, zlib.crc32(site.encode()), zlib.crc32(kind.encode()), step)
    return float(np.random.default_rng(key).random())


@dataclass(frozen=True)
class FaultPlan:
    """Immutable, hashable fault schedule (safe to hang off frozen configs)."""
    specs: tuple = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the compact ``;``-separated DSL (RunConfig.fault_plan)."""
        specs = tuple(_parse_spec(p) for p in text.split(";") if p.strip())
        return cls(specs=specs, seed=seed)

    @classmethod
    def random(cls, seed: int, horizon: int, rates: dict) -> "FaultPlan":
        """Bernoulli schedule: ``rates`` maps ``"site/kind"`` -> per-step
        probability.  Whether (site, kind) fires at step s depends only on
        (seed, site, kind, s) — adding sites or extending the horizon never
        reshuffles earlier draws."""
        specs = []
        for key, p in sorted(rates.items()):
            site, _, kind = key.partition("/")
            if site not in SITES or kind not in SITES[site]:
                raise ValueError(f"unknown rate key {key!r}")
            for step in range(horizon):
                if _unit(seed, site, kind, step) < p:
                    specs.append(FaultSpec(site=site, step=step, kind=kind))
        return cls(specs=tuple(specs), seed=seed)

    def at(self, site: str, step: int):
        return tuple(s for s in self.specs
                     if s.site == site and s.step == step)

    def sites(self):
        return sorted({s.site for s in self.specs})

    def compact(self) -> str:
        return ";".join(s.compact() for s in self.specs)


class FaultInjector:
    """Stateful executor of a FaultPlan: fires each spec on its first
    ``attempts`` executions of (site, step), logs every firing.  Two fresh
    injectors over the same plan produce identical logs for identical
    execution sequences — the (seed, step) determinism contract."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._remaining = {id(s): s.attempts for s in plan.specs}
        self.fired: list = []        # (site, step, kind) in firing order

    def fire(self, site: str, step: int):
        """Specs due at (site, step) on this execution; spends one attempt
        per returned spec."""
        out = []
        for s in self.plan.at(site, step):
            if self._remaining[id(s)] > 0:
                self._remaining[id(s)] -= 1
                self.fired.append((s.site, s.step, s.kind))
                out.append(s)
        return out

    @property
    def exhausted(self) -> bool:
        return all(v == 0 for v in self._remaining.values())


def injector_from_run(run, sites=None):
    """Build an injector from RunConfig.fault_plan / fault_seed (the config
    surface the launchers thread through); None when no plan is set.
    ``sites`` filters to the subsystem's own hook points so one plan string
    can drive a trainer and an engine without cross-firing."""
    if not getattr(run, "fault_plan", ""):
        return None
    plan = FaultPlan.parse(run.fault_plan, seed=run.fault_seed)
    if sites is not None:
        plan = replace(plan, specs=tuple(
            s for s in plan.specs
            if s.site.split(".")[0] in sites or s.site in sites))
    return FaultInjector(plan) if plan.specs else None


# ---------------------------------------------------------------------------
# checkpoint corruption (the ckpt.write fault body)
# ---------------------------------------------------------------------------

def corrupt_checkpoint(ckpt_dir, step: int, *, mode: str = "bit_flip",
                       leaf_index: int = 0, seed: int = 0) -> str:
    """Deterministically damage the DURABLE checkpoint for ``step``.

    bit_flip  — flip one bit of one leaf file (byte position keyed by seed)
    truncate  — cut a leaf file to half its length
    manifest  — truncate manifest.json mid-JSON

    Returns the damaged file's path.  The checksummed manifest
    (checkpoint/ckpt.py) must detect all three on restore."""
    import json
    import pathlib
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    if mode == "manifest":
        mf = d / "manifest.json"
        mf.write_text(mf.read_text()[: max(1, mf.stat().st_size // 2)])
        return str(mf)
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = sorted(manifest["leaves"])
    path = d / manifest["leaves"][leaves[leaf_index % len(leaves)]]["file"]
    raw = bytearray(path.read_bytes())
    if mode == "truncate":
        path.write_bytes(bytes(raw[: len(raw) // 2]))
    elif mode == "bit_flip":
        # flip a bit inside the payload (past the .npy header, which the
        # loader might tolerate or re-derive)
        pos = 128 + int(_unit(seed, "ckpt", "bit_flip", step)
                        * max(1, len(raw) - 129))
        raw[pos] ^= 0x20
        path.write_bytes(bytes(raw))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return str(path)


class DeviceLostError(RuntimeError):
    """A (simulated) device/host loss: recovery needs an elastic re-plan,
    not a same-mesh restart, so the train loop re-raises it past the
    restart budget for the caller to handle (runtime/elastic.replan)."""

    def __init__(self, n_surviving: int, msg: str = ""):
        self.n_surviving = int(n_surviving)
        super().__init__(msg or f"device loss: {n_surviving} devices survive")
