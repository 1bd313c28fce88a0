"""Checkpoints of the port: atomic, async, reshard-on-restore (counterpart
of ``repro.checkpoint.ckpt``).

Format, the reference's, so a checkpoint written by either package
restores in the other: one directory per step, ``step_<8 digits>/``, with

    manifest.json   step, time, and per leaf its file, shape, dtype,
                    nbytes and the crc32 of its raw payload (plus the
                    optional ``meta``)
    <leaf>.npy      the leaf's raw bytes as a uint8 .npy (``/`` in the
                    leaf's path becomes ``__``); bf16 is stored as its two
                    bytes under the dtype string ``bfloat16``

The leaves are global, unsharded arrays named by the reference's tree:
``params/embed``, ``params/head``, ``params/blocks/<name>`` stacked on a
leading [L], ``opt/{m,v,master}/...`` in the same layout and ``opt/step``
(an int32 scalar).  Params keep the padded global shape of the layout that
wrote them, as the reference's do; a restore cuts every leaf to its
logical shape and pads it again for its own layout, so a checkpoint taken
on one layout restores on any other: each rank keeps its block
(``convert.shard_params``) and, under ZeRO-1, its slice of it
(``optim/zero.zslice``).  A reference checkpoint whose manifest names
ZeRO-1 layouts (``meta.opt_layout``) has its optimizer leaves made global
first (``optim/zero.make_ckpt_converter``).

Durability: a write goes to ``<dir>/.tmp-<step>``, is renamed to
``step_<step>``, and the ``latest`` pointer is replaced last, so a crash
mid-write never damages the previous checkpoint.  ``save`` copies the
state to the host and writes it on a thread; a failed write is re-raised
by the next ``wait()`` or ``save()``.  Every leaf is checked against its
manifest entry as it is read, and ``restore_latest`` falls back across
damaged checkpoints, newest first.

Across ranks (a ``Mesh`` of more than one rank), every call is made on
every rank: rank 0 gathers the state (``state_to_host``: one leaf at a
time, a ZeRO-1 slice first over its zaxes, then the block over the leaf's
own axes) and writes it; on restore rank 0 picks the step, falling back
as needed, and broadcasts it, and every rank reads that step and keeps
its block.  A failed write on rank 0 is raised on every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..core import collectives as col
from ..core.mesh import AXES, axis_index, axis_size
from ..optim import zero

# dtype strings of the manifest (numpy's names; bf16 as the reference's
# ml_dtypes spells it)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check (checksum mismatch,
    truncated leaf, unreadable manifest).  Restore falls back to the next
    older checkpoint (``restore_latest``) instead of loading damaged
    state."""


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _host(x) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (numpy arrays are wrapped)."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = torch.from_numpy(np.array(x))
    return x.detach().cpu().contiguous()


def _raw(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a uint8 numpy array."""
    return t.reshape(-1).view(torch.uint8).numpy()


class CheckpointManager:
    """Checkpoints of one run in ``directory``; ``mesh`` (a ``Mesh`` of
    more than one rank) and ``device`` (its rank's device) make every
    call collective, as the module doc says."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True,
                 mesh=None, device=None):
        self.dir = Path(directory)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = device
        self.writer = self.mesh is None or self.mesh.rank == 0
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._error_step: int | None = None
        self.last_fallbacks = 0
        self.write_seconds: list = []     # each finished write, host clock

    # ------------------------------------------------------------- save
    def save(self, step: int, state: dict, blocking: bool = False,
             meta: dict | None = None):
        """Write ``state`` (a tree of tensors or numpy arrays, global
        arrays; across ranks only rank 0's is read, and the others may pass
        None) as ``step``.  One save is in flight at a time: a failure of
        the previous async save is re-raised here first."""
        self.wait()
        if not self.writer:
            return
        host = {k: _host(v) for k, v in _flatten(state).items()}
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write_guarded(self, step: int, host: dict, meta=None):
        try:
            self._write(step, host, meta)
        except BaseException as e:  # surfaced on the next wait()/save()
            self._error = e
            self._error_step = step

    def _write(self, step: int, host: dict, meta=None):
        t0 = time.perf_counter()
        tmp = self.dir / f".tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": {},
                    **({"meta": meta} if meta else {})}
        for path, t in host.items():
            fn = path.replace("/", "__") + ".npy"
            raw = _raw(t)
            np.save(tmp / fn, raw)
            # the checksum covers the payload, not the .npy header: bit
            # flips and truncation are both caught on restore
            manifest["leaves"][path] = {
                "file": fn, "shape": list(t.shape),
                "dtype": DTYPE_NAMES[t.dtype], "nbytes": int(raw.nbytes),
                "crc32": int(zlib.crc32(raw))}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (self.dir / "latest.tmp").write_text(str(step))
        os.replace(self.dir / "latest.tmp", self.dir / "latest")
        self._gc()
        self.write_seconds.append(time.perf_counter() - t0)

    def wait(self):
        """Join the in-flight async save; re-raise its failure (on every
        rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, step = self._error, self._error_step
        self._error = self._error_step = None
        if self.mesh is not None:
            failed = torch.tensor([0.0 if err is None else 1.0],
                                  device=self.device)
            if float(col.pmax(self.mesh, failed, AXES)[0]) > 0 \
                    and err is None:
                raise RuntimeError("async checkpoint save failed on rank 0")
        if err is not None:
            raise RuntimeError(
                f"async checkpoint save for step {step} failed: "
                f"{type(err).__name__}: {err}") from err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        lp = self.dir / "latest"
        if lp.exists():
            try:
                s = int(lp.read_text().strip())
                if (self.dir / f"step_{s:08d}" / "manifest.json").exists():
                    return s
            except ValueError:
                pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _candidates(self):
        """Steps newest first, the ``latest`` pointer's first."""
        candidates = sorted(self.all_steps(), reverse=True)
        latest = self.latest_step()
        if latest is not None and latest in candidates:
            candidates.remove(latest)
            candidates.insert(0, latest)
        return candidates

    def _agreed(self, step):
        """Rank 0's ``step`` (an int or None) on every rank."""
        if self.mesh is None:
            return step
        got = col.broadcast_scalar(self.mesh, -1.0 if step is None
                                   else float(step), self.device)
        return None if got < 0 else int(got)

    def latest_valid_step(self) -> int | None:
        """Newest step that passes a full integrity check (``verify``), or
        None; rank 0's answer on every rank.  The train loop's
        restart-budget window reads it: a save that landed damaged is no
        durable progress."""
        found = None
        if self.writer:
            for step in self._candidates():
                try:
                    self.verify(step)
                    found = step
                    break
                except CheckpointCorruptError:
                    continue
        return self._agreed(found)

    def _manifest(self, step: int) -> dict:
        d = self.dir / f"step_{step:08d}"
        try:
            return json.loads((d / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable manifest: {e}") from e

    def _load_leaf(self, step: int, path: str, meta: dict) -> torch.Tensor:
        """Read one leaf and check its length and crc32 against the
        manifest (an entry without them, from before checksums, is not
        checked)."""
        d = self.dir / f"step_{step:08d}"
        try:
            raw = np.load(d / meta["file"])
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"step {step}: leaf {path!r} unreadable "
                f"({type(e).__name__}: {e})") from e
        if "nbytes" in meta and int(raw.nbytes) != meta["nbytes"]:
            raise CheckpointCorruptError(
                f"step {step}: leaf {path!r} truncated: {raw.nbytes} bytes "
                f"on disk, manifest says {meta['nbytes']}")
        if "crc32" in meta and zlib.crc32(raw) != meta["crc32"]:
            raise CheckpointCorruptError(
                f"step {step}: leaf {path!r} failed its checksum (bit "
                f"flip / partial write)")
        if meta["dtype"] not in DTYPES:
            raise CheckpointCorruptError(
                f"step {step}: leaf {path!r} has dtype {meta['dtype']!r}")
        t = torch.from_numpy(raw.reshape(-1).view(np.uint8))
        return t.view(DTYPES[meta["dtype"]]).reshape(meta["shape"])

    def verify(self, step: int) -> None:
        """Check every leaf of ``step``; raises CheckpointCorruptError."""
        manifest = self._manifest(step)
        for path, meta in manifest["leaves"].items():
            self._load_leaf(step, path, meta)

    def restore(self, step: int, convert=None) -> dict:
        """Every leaf of ``step``, checked, as {path: CPU tensor}.
        ``convert(path, array, manifest_meta) -> array`` (optional) maps
        each leaf's numpy array first (the ZeRO-1 converter).  Raises
        CheckpointCorruptError before anything is returned."""
        manifest = self._manifest(step)
        mf_meta = manifest.get("meta") or {}
        out = {}
        for path, meta in manifest["leaves"].items():
            t = self._load_leaf(step, path, meta)
            if convert is not None and t.dtype != torch.bfloat16:
                arr = convert(path, t.numpy(), mf_meta)
                t = torch.from_numpy(np.ascontiguousarray(arr))
            out[path] = t
        return out

    def restore_latest(self, convert=None):
        """``(leaves, step)`` of the newest checkpoint that passes its
        checks, falling back across damaged ones (newest to oldest), or
        ``(None, None)``; ``self.last_fallbacks`` counts the damaged ones
        skipped.  Across ranks rank 0 picks the step and every rank reads
        it."""
        self.last_fallbacks = 0
        found, leaves = None, None
        if self.writer:
            for step in self._candidates():
                try:
                    leaves = self.restore(step, convert)
                    found = step
                    break
                except CheckpointCorruptError as e:
                    print(f"[ckpt] {e}; falling back to an older "
                          f"checkpoint", flush=True)
                    self.last_fallbacks += 1
        if self.mesh is not None:
            self.last_fallbacks = int(col.broadcast_scalar(
                self.mesh, float(self.last_fallbacks), self.device))
            found = self._agreed(found)
            if found is not None and leaves is None:
                leaves = self.restore(found, convert)
        return (leaves, found) if found is not None else (None, None)


# ---------------------------------------------------------------------------
# the model's state <-> the checkpoint's global leaves
# ---------------------------------------------------------------------------

def _spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in the mesh's axis order."""
    used = {a for dim in spec for a in dim}
    return tuple(a for a in AXES if a in used)


def _global(mesh, t, spec, padded):
    """The global array (shape ``padded``) of the block ``t`` cut by
    ``spec``: gathered over the spec's axes and put together."""
    axes = _spec_axes(spec)
    if mesh.axis_size(axes) == 1:
        return t
    got = col.all_gather_inv(mesh, t.contiguous(), axes)
    out = torch.empty(padded, dtype=t.dtype, device=t.device)
    for i, blk in enumerate(got):
        coords, lin = {}, i
        for a in reversed(axes):
            lin, coords[a] = divmod(lin, mesh.sizes[a])
        idx = []
        for n, dim_axes in zip(padded, spec):
            m = n // axis_size(mesh.sizes, dim_axes)
            j = axis_index(mesh.sizes, coords, dim_axes)
            idx.append(slice(j * m, (j + 1) * m))
        out[tuple(idx)] = blk
    return out


def _named_leaves(model):
    """(tree path, name, layer or None, spec entry) for every parameter,
    in the order of ``model.parameters()``."""
    out = []
    for name, _ in model.named_parameters():
        if name.startswith("blocks."):
            _, layer, base = name.split(".")
            out.append((f"blocks/{base}", base, int(layer),
                        model.block_specs[base]))
        else:
            out.append((name, name, None, model.top_specs[name]))
    return out


@torch.no_grad()
def state_to_host(model, opt) -> dict | None:
    """The train state of ``model`` (a DenseLM or a MambaLM on its mesh)
    and ``opt`` (``runtime/steps.init_opt_state``'s) as the checkpoint's
    tree of global CPU tensors, on rank 0 (None on the others; collective):
    ``params``, and ``opt`` with ``m``, ``v``, ``master`` (when kept) in
    the params' layout and ``step``.  One leaf is in flight at a time."""
    from ..runtime.steps import leaf_layouts
    mesh = model.mesh
    keep = mesh.rank == 0
    params = list(model.parameters())
    leaves = _named_leaves(model)
    lays = ([leaf[2] for leaf in leaf_layouts(model)]
            if model.run.zero_enabled else None)
    groups = {"params": params}
    groups.update({name: opt[name] for name in ("m", "v", "master")
                   if name in opt})
    flat = {}
    for group, tensors in groups.items():
        for i, (path, _, layer, (_, padded, spec)) in enumerate(leaves):
            t = tensors[i]
            if lays is not None and group != "params":
                t = zero.zgather(mesh, t, lays[i])
            g = _global(mesh, t, spec, padded)
            if not keep:
                continue
            # a copy, never a view of the live tensor: the writer thread
            # reads it while the next steps update the params in place
            key = f"{group}/{path}" if group == "params" \
                else f"opt/{group}/{path}"
            if layer is None:
                flat[key] = g.to("cpu", copy=True)
                continue
            if layer == 0:               # the [L] stack, filled per layer
                flat[key] = torch.empty((model.cfg.num_layers,) + g.shape,
                                        dtype=g.dtype)
            flat[key][layer].copy_(g)
    if not keep:
        return None
    flat["opt/step"] = torch.tensor(opt["step"], dtype=torch.int32)
    return _unflatten(flat)


def _fit(arr: np.ndarray, logical, padded, lead=()) -> np.ndarray:
    """A global leaf written under any layout, cut to its logical shape
    and zero-padded to ``padded`` (this layout's)."""
    want = tuple(lead) + tuple(logical)
    if arr.ndim != len(want) or any(a < w for a, w in zip(arr.shape, want)):
        raise CheckpointCorruptError(
            f"leaf of shape {arr.shape} does not hold logical {want}")
    arr = arr[tuple(slice(n) for n in want)]
    pad = [(0, 0)] * len(lead) + [(0, p - n) for n, p in zip(logical,
                                                            padded)]
    return np.pad(arr, pad) if any(p for _, p in pad) else arr


@torch.no_grad()
def load_state(model, leaves: dict) -> dict:
    """Load a checkpoint's global ``leaves`` ({path: CPU tensor}, from
    ``CheckpointManager.restore``) into ``model``'s parameters, each rank
    its block, and return the optimizer state for it
    (``runtime/steps.init_opt_state``'s layout: under ZeRO-1 each rank's
    slice of its block).  Raises CheckpointCorruptError for a missing or
    misshapen leaf."""
    from ..convert import params_from_jax, shard_params
    from ..runtime.steps import init_opt_state, leaf_layouts
    cfg, ctx, mesh = model.cfg, model.ctx, model.mesh
    top, block = model.top_specs, model.block_specs
    L = cfg.num_layers

    def tree(prefix):
        out = {"blocks": {}}
        for name, (logical, padded, _) in top.items():
            out[name] = _fit(_get(f"{prefix}/{name}"), logical, padded)
        for name, (logical, padded, _) in block.items():
            out["blocks"][name] = _fit(_get(f"{prefix}/blocks/{name}"),
                                       logical, padded, lead=(L,))
        return shard_params(out, cfg, ctx, mesh.coords)

    def _get(path):
        if path not in leaves:
            raise CheckpointCorruptError(f"leaf {path!r} missing")
        return leaves[path].float().numpy()

    params_from_jax(tree("params"), model)
    opt = init_opt_state(model)
    lays = ([leaf[2] for leaf in leaf_layouts(model)]
            if model.run.zero_enabled else None)
    for group in ("m", "v", "master"):
        if group not in opt:
            continue
        local = tree(f"opt/{group}")
        for i, (_, name, layer, _) in enumerate(_named_leaves(model)):
            arr = local[name] if layer is None else \
                local["blocks"][name][layer]
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(model.device)
            if lays is not None:
                t = zero.zslice(mesh, t, lays[i])
            opt[group][i].copy_(t.reshape(opt[group][i].shape))
    if "opt/step" not in leaves:
        raise CheckpointCorruptError("leaf 'opt/step' missing")
    opt["step"] = int(leaves["opt/step"])
    return opt
