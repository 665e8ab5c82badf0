"""Radix-tree shared-prefix KV reuse over the paged block tables
(jax-free).

The port's own copy of ``horovod_tpu/serving/prefix_cache.py`` (plain
Python; the port imports nothing of the JAX package).

Real serving traffic is dominated by shared prompt prefixes — system
prompts, few-shot templates, multi-turn histories. Because the PR 14
paged KV cache already addresses K/V through per-request block tables,
two requests whose prompts agree on a page-aligned prefix can point
their leading block-table entries at the SAME physical pages: the
prefill for those positions happens once, ever. This module is the
index that makes the match cheap: a radix tree whose edges are whole
pages (``page_size`` tokens keyed as a tuple), so lookup walks at most
``prompt_len / page_size`` dict hops.

Invariants (tests/test_serving_scheduler.py pins these):

- **One page per node.** A node's path from the root spells a
  page-aligned token prefix; ``node.page`` holds its K/V. Children are
  keyed by the next page's token tuple, so common prefixes share nodes
  by construction — the tree IS the dedup.
- **The cache is a holder like any other.** Every node owns exactly one
  allocator reference on its page (taken at ``insert``, dropped at
  ``evict``). A page referenced only by the cache has refcount 1;
  requests sharing it push it higher. Conservation
  (``free + distinct-owned == usable``) is unchanged.
- **Strict prefix only.** ``lookup`` never matches the whole prompt:
  the match is capped at ``(prompt_len - 1) // page_size`` pages so at
  least one novel token always remains to prefill — the first output
  token's logits must come from a real forward pass, and a request must
  always own the page it will write its next position into.
- **LRU eviction of unreferenced prefixes only.** ``evict`` frees
  least-recently-touched LEAF nodes whose page refcount is exactly 1
  (cache-only): an interior node's page can be needed by any descendant
  hit, and a page a live request shares must never return to the pool
  under it. Evicting a leaf can expose its parent as the next
  candidate, so eviction peels prefixes back-to-front.
- **Insert after materialization.** The serve loop registers a prompt
  only once its K/V is actually written (post-prefill); inserting at
  admission would let a second request hit pages whose suffix is still
  garbage.
"""


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent, tick):
        self.key = key          # tuple of page_size token ids (root: None)
        self.page = page        # physical KV page (root: -1, unowned)
        self.parent = parent
        self.children = {}      # next-page token tuple -> _Node
        self.last_used = tick


class PrefixCache:
    """Radix tree of page-aligned cached prefixes over a
    :class:`~horovod_tpu_torch.serving.scheduler.PageAllocator`.

    The cache never allocates pages itself — it adopts pages that a
    request already prefilled (``insert`` takes a ``share`` reference)
    and drops them under pressure (``evict``). The scheduler calls
    ``lookup`` at admission and ``evict`` when the free list runs dry.
    """

    def __init__(self, allocator):
        self.alloc = allocator
        self.page_size = allocator.page_size
        self._root = _Node(None, -1, None, 0)
        self._tick = 0
        self.stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                      "inserts": 0, "nodes": 0, "evictions": 0}

    def _touch(self, node):
        self._tick += 1
        node.last_used = self._tick

    def _keys(self, prompt, n_pages):
        ps = self.page_size
        return [tuple(prompt[i * ps:(i + 1) * ps]) for i in range(n_pages)]

    # -- scheduler-facing ------------------------------------------------

    def lookup(self, prompt):
        """Longest cached page-aligned STRICT prefix of ``prompt``.
        Returns ``(pages, n_tokens)`` — the physical pages to share and
        how many prompt tokens they cover (0 on a miss). Touches the
        matched path for LRU but takes NO references; the caller shares
        the pages (or not) atomically with its admission decision."""
        self.stats["lookups"] += 1
        limit = max(0, (len(prompt) - 1) // self.page_size)
        node, pages = self._root, []
        for key in self._keys(prompt, limit):
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            pages.append(child.page)
            node = child
        if pages:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(pages) * self.page_size
        return pages, len(pages) * self.page_size

    def insert(self, prompt, pages):
        """Register a materialized prompt's full pages. Walks existing
        nodes (which already hold these very pages for any shared
        prefix) and adopts only the novel tail, taking one ``share``
        reference per NEW node. Returns the number of nodes added."""
        n_full = min(len(prompt) // self.page_size, len(pages))
        self.stats["inserts"] += 1
        node, added = self._root, 0
        for i, key in enumerate(self._keys(prompt, n_full)):
            child = node.children.get(key)
            if child is None:
                self.alloc.share([pages[i]])
                child = _Node(key, pages[i], node, self._tick)
                node.children[key] = child
                self.stats["nodes"] += 1
                added += 1
            self._touch(child)
            node = child
        return added

    def evict(self, n):
        """Free up to ``n`` pages by dropping least-recently-used leaf
        nodes whose page is referenced ONLY by the cache (refcount 1).
        Freeing a leaf can make its parent evictable, so one call can
        peel a whole cold branch. Returns the number of pages freed."""
        freed = 0
        while freed < max(0, n):
            victim, oldest = None, None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif self.alloc.refcount(node.page) == 1:
                    if oldest is None or node.last_used < oldest:
                        victim, oldest = node, node.last_used
            if victim is None:
                break
            self.alloc.free([victim.page])
            del victim.parent.children[victim.key]
            self.stats["nodes"] -= 1
            self.stats["evictions"] += 1
            freed += 1
        return freed

    # -- introspection ---------------------------------------------------

    def cached_pages(self):
        """Pages currently held by the tree (each exactly one cache
        reference)."""
        out, stack = [], list(self._root.children.values())
        while stack:
            node = stack.pop()
            out.append(node.page)
            stack.extend(node.children.values())
        return out

    def __len__(self):
        return self.stats["nodes"]
