"""Speculative-decoding proposers of the serving engine (port of
``repro.serve.spec``).

Two proposal sources feed the engine's verify round:

- ``NgramProposer`` (a copy of the reference's): model-free prompt lookup.
  The longest recent n-gram suffix of the request's own tokens is matched
  against its earlier occurrences and the continuation is proposed
  verbatim.
- ``DraftRunner``: a small port ``DenseLM`` drafting on the target's
  device and mesh.  Its own paged pool ``[L_d, P_loc, bs, Hkv_d_loc,
  D_d]`` is addressed by the target's GLOBAL block tables, so there is no
  second allocator: the capacity the scheduler reserves for the target
  covers the draft.  Per request ``draft_cached`` marks how much of the
  sequence the draft pool holds; catch-up runs the draft's chunk trunk
  ``CHUNK`` positions at a time, then k greedy paged-decode steps make
  the proposals (kernels #1 and #6 on the card, as the target's steps).

The draft pool is disposable: preemption resets ``draft_cached`` to 0 and
the next round re-prefills it.  The target's verification gates every
committed token, so a stale draft can cost acceptance, never parity.
Across ranks every rank runs the same draft steps; the proposals come from
the gathered logits, which are the same bytes on every rank.
"""
from __future__ import annotations

import numpy as np
import torch


class NgramProposer:
    """Prompt-lookup proposer: longest-suffix n-gram match over the
    request's own resident tokens (prompt + generated)."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if max_n < min_n or min_n < 1:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n, self.min_n = max_n, min_n

    def propose(self, tokens, k: int):
        """Up to ``k`` proposed continuation tokens (possibly empty)."""
        if k <= 0 or len(tokens) < self.min_n + 1:
            return []
        tokens = list(tokens)
        for n in range(min(self.max_n, len(tokens) - 1), self.min_n - 1, -1):
            suffix = tokens[-n:]
            # most recent earlier occurrence wins (local context beats
            # distant repeats)
            for i in range(len(tokens) - n - 1, -1, -1):
                if tokens[i:i + n] == suffix:
                    cont = tokens[i + n:i + n + k]
                    if cont:
                        return cont
        return []


class DraftRunner:
    """Draft-model executor sharing the target engine's block tables: the
    draft pool's block axis lines up 1:1 with the target's, so any table
    the engine builds addresses both."""

    #: catch-up chunk width
    CHUNK = 16

    def __init__(self, model, n_slots: int, blocks_per_group: int,
                 block_size: int):
        self.model = model
        self.n_slots = n_slots
        shape, dtype = model.paged_cache_shape(blocks_per_group, block_size)
        self.pool = {leaf: torch.zeros(shape, dtype=dtype,
                                       device=model.device)
                     for leaf in ("k", "v")}
        # steps run, for the launch accounting (kernel #1 per projection,
        # #6 per layer of a decode step)
        self.chunk_steps = 0
        self.decode_steps = 0

    def reset(self) -> None:
        """Drop all draft K/V."""
        for t in self.pool.values():
            t.zero_()

    def _tensor(self, a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(
            self.model.device)

    def _catch_up(self, reqs, tables) -> None:
        """Chunk-prefill the draft pool from each request's draft_cached
        mark to its target num_cached (caught-up slots idle)."""
        n = self.n_slots
        while True:
            behind = [r for r in reqs if r.draft_cached < r.num_cached]
            if not behind:
                return
            ids = np.zeros((n, self.CHUNK), np.int32)
            pos = np.zeros((n,), np.int32)
            lens = np.zeros((n,), np.int32)
            for r in behind:
                s = r.slot
                t = min(self.CHUNK, r.num_cached - r.draft_cached)
                ids[s, :t] = r.seq_tokens[r.draft_cached:r.draft_cached + t]
                pos[s] = r.draft_cached
                lens[s] = t
            self.model.prefill_chunk_paged(self.pool, tables,
                                           self._tensor(ids),
                                           self._tensor(pos),
                                           self._tensor(lens))
            self.chunk_steps += 1
            for r in behind:
                r.draft_cached += min(self.CHUNK,
                                      r.num_cached - r.draft_cached)

    def propose(self, reqs, tables, k_eff: dict):
        """Greedy draft proposals per request: {rid: [tokens...]}.

        reqs: running requests with last_token set; tables: the engine's
        [n_slots, max_blocks] GLOBAL table on the device (capacity for
        num_cached + k_eff + 1 reserved); k_eff: rid -> proposal budget.
        Slots whose budget is spent stay in the fixed-shape batch frozen
        at their last (pos, token): the rewrite is idempotent."""
        self._catch_up(reqs, tables)
        props = {r.rid: [] for r in reqs}
        kmax = max(k_eff.values(), default=0)
        if kmax == 0:
            return props
        n = self.n_slots
        cur_id = np.zeros((n, 1), np.int32)
        cur_pos = np.zeros((n,), np.int32)
        for r in reqs:
            cur_id[r.slot, 0] = r.last_token
            cur_pos[r.slot] = r.num_cached
        for j in range(kmax):
            lg = self.model.decode_paged(self.pool, tables,
                                         self._tensor(cur_id),
                                         self._tensor(cur_pos))
            self.decode_steps += 1
            nxt = lg.argmax(-1).cpu().numpy()
            for r in reqs:
                if j < k_eff[r.rid]:
                    t = int(nxt[r.slot])
                    props[r.rid].append(t)
                    cur_id[r.slot, 0] = t
                    cur_pos[r.slot] += 1
        return props
