"""Radix prefix cache over the paged block pool (the port's copy of
``repro.serve.prefix_cache``; pure Python, no devices).

Multi-tenant traffic shares long prompt prefixes (system prompts, few-shot
templates).  This module maps those shared prefixes to *shared pages* in
the existing ``BlockPool``: a per-KV-group radix tree whose edges are
full-block token keys (tuples of ``block_size`` token ids) and whose nodes
hold one physical block id each.  A request whose prompt walks q full
edges reuses those q pages verbatim — the pool refcount tracks every
holder, so a page is only returned to the freelist when the last request
AND the cache itself have released it.

Copy-on-write: when the common prefix ends *inside* a cached block (r
tokens into it, 0 < r < block_size), the block cannot be shared — the
request will write its own tokens into positions r.. of that block.  The
lookup reports the cached block as a COW *donor* (``cow_src``/``cow_len``)
and the engine copies the donor page into a freshly-allocated private
block before prefilling the suffix.  Shared pages are therefore never
mutated: decode only ever appends at positions >= len(prompt), which live
in the request's private tail blocks, and divergent prefixes write into
private COW copies.

Eviction: leaves whose page has refcount 1 (the cache is the only holder)
are reclaimable, oldest ``last_use`` first.  Interior nodes become leaves
as their children go; pages still referenced by running requests are
never candidates — eviction respects refcounts by construction (the
``serve.prefix`` fault site drives this under test).  ``flush`` drops the
whole index.

Across ranks every rank holds the same tree: it is built from host tokens
and the allocator's block ids alone, which are the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class _Node:
    __slots__ = ("key", "block", "parent", "children", "last_use")

    def __init__(self, key, block, parent):
        self.key = key            # tuple of block_size token ids
        self.block = block        # global physical block id
        self.parent = parent
        self.children = {}        # key tuple -> _Node
        self.last_use = 0


@dataclass
class PrefixHit:
    """Result of a lookup: how much of a prompt the cache can supply."""
    tokens: int                   # cached positions usable by this request
    full_blocks: list             # shared page ids covering tokens // bs
    cow_src: int | None = None    # donor page for a partial tail block
    cow_len: int = 0              # valid positions inside the donor
    nodes: list = field(default_factory=list)   # tree path (for LRU touch)


class RadixPrefixCache:
    """Per-group radix index of prompt prefixes -> refcounted pool pages."""

    def __init__(self, pool, block_size: int):
        self.pool = pool
        self.block_size = block_size
        self._roots = [{} for _ in range(pool.n_groups)]  # key -> _Node
        self._clock = 0
        # counters (engine folds these into EngineStats)
        self.evictions = 0
        self.flushes = 0

    # ------------------------------------------------------------ queries
    def __len__(self):
        n = 0
        stack = [c for root in self._roots for c in root.values()]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def cached_blocks(self, group: int):
        out = []
        stack = list(self._roots[group].values())
        while stack:
            node = stack.pop()
            out.append(node.block)
            stack.extend(node.children.values())
        return out

    def lookup(self, group: int, tokens, limit: int) -> PrefixHit:
        """Longest cached prefix of ``tokens``, capped at ``limit`` positions.

        ``limit`` is len(seq) - 1 in practice: the engine must run at least
        one real position through the model to produce the next token, so a
        whole-prompt hit is clamped — the clamp may demote the last fully
        matched block to a COW donor.
        """
        self._clock += 1
        bs = self.block_size
        node_map = self._roots[group]
        matched = []                       # full-block path nodes
        q = 0
        while (q + 1) * bs <= len(tokens):
            key = tuple(tokens[q * bs:(q + 1) * bs])
            child = node_map.get(key)
            if child is None:
                break
            matched.append(child)
            node_map = child.children
            q += 1
        # best partial continuation: a child sharing r > 0 leading tokens
        # with the next (possibly short) prompt segment
        seg = tuple(tokens[q * bs:(q + 1) * bs])
        partial, r = None, 0
        if seg:
            for key, child in node_map.items():
                m = 0
                for a, b in zip(key, seg):
                    if a != b:
                        break
                    m += 1
                if m > r:
                    partial, r = child, m
        raw = q * bs + r
        hit_tokens = min(raw, limit)
        if hit_tokens <= 0:
            return PrefixHit(tokens=0, full_blocks=[])
        n_full = hit_tokens // bs
        cow_len = hit_tokens - n_full * bs
        if cow_len:
            donor = matched[n_full] if n_full < len(matched) else partial
            cow_src = donor.block
            path = matched[:n_full] + [donor]
        else:
            cow_src = None
            path = matched[:n_full]
        now = self._clock
        for nd in path:
            nd.last_use = now
        return PrefixHit(tokens=hit_tokens,
                         full_blocks=[nd.block for nd in matched[:n_full]],
                         cow_src=cow_src, cow_len=cow_len, nodes=path)

    # ------------------------------------------------------------ updates
    def insert(self, group: int, tokens, block_ids) -> int:
        """Index a fully-prefilled prompt's full blocks; returns new nodes.

        ``block_ids`` are the request's resident pages, position-aligned
        with ``tokens``.  Existing nodes win (the request's duplicate page
        stays private to it); new nodes take a cache-owned reference on the
        request's page, so it survives the request's retirement.
        """
        self._clock += 1
        bs = self.block_size
        node_map, parent = self._roots[group], None
        added = 0
        n_full = min(len(tokens) // bs, len(block_ids))
        for i in range(n_full):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node_map.get(key)
            if child is None:
                child = _Node(key, block_ids[i], parent)
                self.pool.ref([child.block])
                node_map[key] = child
                added += 1
            child.last_use = self._clock
            node_map, parent = child.children, child
        return added

    def evict(self, group: int, want: int, protect=()) -> int:
        """Free up to ``want`` pool blocks by dropping cold shareable leaves.

        Only leaves whose page refcount is 1 (cache-only holder) return
        capacity; shared pages are left alone — eviction can never pull a
        page out from under a running request.  ``protect`` pins block ids
        (a just-looked-up hit path) against eviction.  Returns blocks freed.
        """
        freed = 0
        while freed < want:
            victim = None
            stack = [(None, k, n) for k, n in self._roots[group].items()]
            while stack:
                pmap_owner, key, node = stack.pop()
                if not node.children:
                    if (self.pool.refcount(node.block) == 1
                            and node.block not in protect
                            and (victim is None
                                 or node.last_use < victim[2].last_use)):
                        victim = (pmap_owner, key, node)
                else:
                    stack.extend((node, k, c)
                                 for k, c in node.children.items())
            if victim is None:
                break
            owner, key, node = victim
            (owner.children if owner is not None
             else self._roots[group]).pop(key)
            self.pool.free([node.block])
            self.evictions += 1
            freed += 1
        return freed

    def flush(self) -> int:
        """Drop the whole index, releasing every cache-held page reference."""
        dropped = 0
        for g in range(self.pool.n_groups):
            for b in self.cached_blocks(g):
                self.pool.free([b])
                dropped += 1
            self._roots[g] = {}
        self.flushes += 1
        return dropped
