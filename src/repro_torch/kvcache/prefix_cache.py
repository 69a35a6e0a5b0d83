"""Radix prefix cache over refcounted pool pages (DESIGN.md §13).

A page-granular trie keyed on token ids. Each node is one physical
page of committed, frozen KV: full interior nodes carry exactly
``page_size`` tokens; at most one *partial* child per node carries a
shorter committed tail. A new session looks up its prompt, attaches to
the longest indexed prefix (``PagedPool.attach_prefix``), and starts
prefill at the first uncached token — the fused kernel's per-row
``q_start`` already renders rows from any offset, so a partial-page hit
is safe: positions past the matched length are masked by ``seq_lens``
and simply overwritten when the attacher appends (after COW if the
page is still shared).

The cache holds *non-refcount* references: registering a page marks it
``cache_held`` in the pool but does not bump its refcount, so the
conservation invariant stays exactly "sum(refcounts) == live
block-table references". A page whose last sequence reference dies
survives at refcount 0 while indexed; ``reclaim`` frees such orphans
leaves-first under memory pressure, farthest banked next-use first
(min-over-sharers Eq.4: while any sharer lives the page is not
reclaimable at all, so the banked value only matters once every sharer
detached — the last detacher's estimate, with protection extended to
the max over sharers' TTLs).

Chains may mix pages registered by different sessions: KV for the same
token prefix is the same state whichever session computed it (up to
the rounding of the product shapes its round ran in), so a lookup that
walks session A's full pages into session B's deeper nodes attaches
the state B would have computed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("tokens", "phys", "children", "partial", "parent",
                 "banked_next_use", "banked_protect")

    def __init__(self, tokens: Tuple[int, ...], phys: Optional[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.phys = phys
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.partial: Optional["_Node"] = None
        self.parent = parent
        self.banked_next_use = 0.0
        self.banked_protect = -1.0


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and int(a[i]) == int(b[i]):
        i += 1
    return i


class PrefixCache:
    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node((), None, None)
        self.by_phys: Dict[int, _Node] = {}
        # telemetry
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self.by_phys)

    @staticmethod
    def _kids(node: _Node) -> List[_Node]:
        out = list(node.children.values())
        if node.partial is not None:
            out.append(node.partial)
        return out

    # ---------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest indexed prefix of ``tokens``: greedy exact full-page
        walk, then the best partial match (longest common prefix over
        the stopping level's children, full or partial). Returns
        (matched token count, physical pages covering them)."""
        self.lookups += 1
        ps = self.page_size
        node = self.root
        matched = 0
        phys: List[int] = []
        i = 0
        n = len(tokens)
        while True:
            if n - i >= ps:
                child = node.children.get(
                    tuple(int(t) for t in tokens[i:i + ps]))
                if child is not None:
                    phys.append(child.phys)
                    matched += ps
                    i += ps
                    node = child
                    continue
            best_j, best_p = 0, None
            for c in self._kids(node):
                j = _lcp(tokens[i:], c.tokens)
                if j > best_j:
                    best_j, best_p = j, c.phys
            if best_j > 0:
                phys.append(best_p)
                matched += best_j
            return matched, phys

    # -------------------------------------------------------- register
    def register(self, tokens: Sequence[int], pages: Sequence[int],
                 *, est: float = 0.0, protect: float = -1.0) -> List[int]:
        """Index a committed chain: ``tokens`` is the full token-id
        history, ``pages`` the sequence's physical pages (prefix-first;
        non-resident entries stop the walk). When a full-page tuple is
        already indexed under a *different* physical page, the existing
        node wins and the walk recurses into its children — our page
        stays private and offloadable. A partial tail registered under
        the same physical page extends monotonically and promotes to a
        full node when the page fills. Returns the newly indexed
        physical pages (the caller marks them ``cache_held``)."""
        ps = self.page_size
        node = self.root
        newly: List[int] = []
        n_full = len(tokens) // ps
        for k in range(n_full):
            if k >= len(pages) or pages[k] < 0:
                return newly
            phys = pages[k]
            tup = tuple(int(t) for t in tokens[k * ps:(k + 1) * ps])
            child = node.children.get(tup)
            if child is None:
                if node.partial is not None and node.partial.phys == phys:
                    # the partially-committed page filled up: promote
                    self._drop_node(node.partial)
                if phys in self.by_phys:
                    return newly        # indexed elsewhere: stop
                child = _Node(tup, phys, node)
                child.banked_next_use = est
                child.banked_protect = protect
                node.children[tup] = child
                self.by_phys[phys] = child
                newly.append(phys)
            node = child
        rem = len(tokens) - n_full * ps
        if rem > 0 and n_full < len(pages) and pages[n_full] >= 0:
            phys = pages[n_full]
            tup = tuple(int(t) for t in tokens[n_full * ps:])
            p = node.partial
            if p is None:
                if phys not in self.by_phys:
                    p = _Node(tup, phys, node)
                    node.partial = p
                    self.by_phys[phys] = p
                    newly.append(phys)
            elif p.phys == phys and len(tup) > len(p.tokens):
                p.tokens = tup          # same page grew: extend
            # a different phys loses: first registration wins the slot
        return newly

    # ---------------------------------------------------------- forget
    def _drop_node(self, node: _Node) -> List[int]:
        """Unlink a node AND its subtree (descendants become
        unreachable) from the index. Returns every physical page
        dropped."""
        out: List[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            out.append(n.phys)
            del self.by_phys[n.phys]
            stack.extend(n.children.values())
            if n.partial is not None:
                stack.append(n.partial)
        par = node.parent
        if par.partial is node:
            par.partial = None
        else:
            del par.children[node.tokens]
        return out

    def forget_phys(self, phys: Sequence[int]) -> List[int]:
        """The pool is about to offload (or migrate away) these pages:
        remove their nodes and entire subtrees from the index. Returns
        all dropped physical pages — the caller releases the zero-ref
        ones (``PagedPool.cache_release``)."""
        dropped: List[int] = []
        for p in phys:
            n = self.by_phys.get(p)
            if n is not None:
                dropped.extend(self._drop_node(n))
        return dropped

    # -------------------------------------------------------- eviction
    def on_detach(self, phys: Sequence[int], *, est: float,
                  protect: float) -> None:
        """A sharer released/migrated: bank its Eq.4 next-use estimate
        (last detacher wins — with every sharer gone it is the freshest
        min-over-sharers) and extend protection to the max over
        sharers' TTLs."""
        for p in phys:
            n = self.by_phys.get(p)
            if n is not None:
                n.banked_next_use = est
                n.banked_protect = max(n.banked_protect, protect)

    def reclaim(self, n: int, now: float,
                refcount: Dict[int, int]) -> List[int]:
        """Free up to ``n`` orphan pages (refcount 0, protection
        lapsed), leaves-first so chains stay contiguous, farthest
        banked next-use first. Returns the physical pages to free."""
        freed: List[int] = []
        while len(freed) < n:
            best = None
            for node in self.by_phys.values():
                if node.children or node.partial is not None:
                    continue
                if refcount.get(node.phys, 0) != 0:
                    continue
                if now < node.banked_protect:
                    continue
                if best is None \
                        or node.banked_next_use > best.banked_next_use:
                    best = node
            if best is None:
                break
            self._drop_node(best)       # a leaf drops exactly itself
            freed.append(best.phys)
        return freed

    def reclaimable(self, now: float, refcount: Dict[int, int]) -> int:
        """How many pages ``reclaim`` could free right now: nodes whose
        ENTIRE subtree is orphaned and unprotected (leaves-first
        cascade reaches a node only after its descendants drop)."""

        def walk(node: _Node):
            free = refcount.get(node.phys, 0) == 0 \
                and now >= node.banked_protect
            size, drop = 1, 0
            for k in self._kids(node):
                kf, ksz, kd = walk(k)
                free = free and kf
                size += ksz
                drop += kd
            return (True, size, size) if free else (False, size, drop)

        return sum(walk(k)[2] for k in self._kids(self.root))
