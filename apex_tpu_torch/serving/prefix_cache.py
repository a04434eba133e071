"""Content-hashed, refcounted copy-on-write prefix cache (counterpart of
``apex_tpu/serving/prefix_cache.py``; host side, stdlib only).

A page of K/V is a function of the token prefix that produced it, so two
requests whose prompts share a page-aligned prefix can share the pages:
a shared system prompt is prefilled once per engine, and every later
request's page table points at the cached pages.

Ownership (the invariants :meth:`PrefixCache.check_invariants` checks):

* **Full chain pages** are transferred from the registering request to
  the cache (allocator owner ``("prefix", page)``) and frozen: a holder
  writes only past its prompt, which lies beyond a full prefix page.
  Each page carries a refcount, the live slots whose table holds it;
  reclaim refuses a page with live references.
* **The partial tail page** of a prompt that is not page-aligned is
  written by every holder (its free rows take the first generated K/V),
  so it is shared by copy: registration snapshots it into a cache-owned
  page, and every hit copies that snapshot into the hitting request's
  own first private page at admission, before any write (the engine does
  the device copies; this module is index bookkeeping). Snapshots hold
  no references and are reclaimable at any time.

A hit never covers the whole prompt: the last prompt token is left for
the engine to run, since its logits give the first output token. The
covered suffix runs through the decode program as warm-up steps.

Reclaim walks chains least recently used and frees ref-0 pages from each
chain's tail backward, stopping at the first referenced page, so a chain
stays prefix-valid.

Knob: the engine's ``prefix_cache=`` (a non-bool raises) >
:func:`set_prefix_cache` > ``APEX_SERVE_PREFIX_CACHE`` (a preference) >
off. Chain hashes are JAX's (the same sha1 over the same text), so the
two packages key a prompt alike.
"""

import hashlib

from apex_tpu_torch import _env

_PREFIX = None  # process-wide tri-state preference


def set_prefix_cache(value):
    """Pin the process-wide prefix-cache preference (True/False), or
    un-pin with None. A non-bool raises."""
    global _PREFIX
    if value is not None and not isinstance(value, bool):
        raise ValueError(
            f"set_prefix_cache wants True/False/None, got {value!r}")
    _PREFIX = value


def resolve(per_call=None):
    """The effective prefix-cache decision: per-call (a non-bool raises)
    > setter > ``APEX_SERVE_PREFIX_CACHE`` ("1"/"0"; other values warn
    once and are ignored) > off."""
    if per_call is not None:
        if not isinstance(per_call, bool):
            raise ValueError(
                f"prefix_cache= wants True/False/None, got {per_call!r}")
        return per_call
    if _PREFIX is not None:
        return _PREFIX
    v = _env.env_choice("APEX_SERVE_PREFIX_CACHE", ("1", "0"))
    if v is not None:
        return v == "1"
    return False


def _page_hash(parent_hash, tokens):
    """Chain hash of one page: sha1 over the parent chain hash and this
    page's tokens, so a page is addressable only through the exact
    prefix that produced its K/V."""
    h = hashlib.sha1(parent_hash.encode())
    h.update(repr(tuple(int(t) for t in tokens)).encode())
    return h.hexdigest()


ROOT = "prefix-root"


class PrefixCache:
    """Chain store and refcounts over cache pages. ``allocator`` is the
    engine's one allocator: cached pages live in its accounting under
    cache owners, so its own invariants cover them too."""

    def __init__(self, allocator, page_size):
        self.allocator = allocator
        self.page_size = int(page_size)
        # chain hash -> {"page", "parent", "ntok"}
        self.nodes = {}
        # parent chain hash -> tail snapshot {"page", "tokens"} (first
        # registrant wins)
        self.tails = {}
        self.refs = {}           # page -> live slot reference count
        self._lru = []           # chain-leaf hashes, oldest first
        self.hit_tokens = 0
        self.lookup_tokens = 0

    # ------------------------------------------------------------ lookup

    def lookup(self, prompt):
        """Longest cached cover of ``prompt``: ``(full_pages, covered,
        tail)``: the shared full chain pages, the covered token count,
        and the ``(snapshot_page, ntok)`` copy-on-write source past the
        last full page (None when no tail matched). Never covers the
        whole prompt. Takes no references and counts no hit-rate sample
        (:meth:`acquire` and :meth:`count` do, once admission succeeds,
        so a request blocked at the head of the line and looked up every
        round does not inflate the rate's denominator)."""
        ps = self.page_size
        full_pages, h, covered = [], ROOT, 0
        while covered + ps < len(prompt):  # strict: keep >= 1 token
            page_tokens = prompt[covered:covered + ps]
            if len(page_tokens) < ps:
                break
            nh = _page_hash(h, page_tokens)
            node = self.nodes.get(nh)
            if node is None:
                break
            full_pages.append(node["page"])
            h, covered = nh, covered + ps
        tail = None
        snap = self.tails.get(h)
        if snap is not None:
            ntok = len(snap["tokens"])
            if 0 < ntok < ps and covered + ntok < len(prompt) \
                    and tuple(prompt[covered:covered + ntok]) \
                    == snap["tokens"]:
                tail = (snap["page"], ntok)
                covered += ntok
        if covered and h != ROOT:
            self._touch(h)
        return full_pages, covered, tail

    def count(self, prompt_tokens, covered):
        """Bank one admitted request's hit-rate sample
        (``prefix_hit_rate`` = hit_tokens / lookup_tokens)."""
        self.lookup_tokens += int(prompt_tokens)
        self.hit_tokens += int(covered)

    def acquire(self, pages):
        """One reference per shared full page (the slot holds them)."""
        for p in pages:
            self.refs[p] = self.refs.get(p, 0) + 1

    def release(self, pages):
        """Drop one reference per shared full page. Pages stay cached at
        ref 0 for later hits; :meth:`reclaim` frees them under pressure."""
        for p in pages:
            n = self.refs.get(p, 0) - 1
            assert n >= 0, f"prefix page {p} released below zero refs"
            self.refs[p] = n

    # ---------------------------------------------------------- register

    def register(self, prompt, pages, owner):
        """Adopt a freshly prefilled prompt's pages. New full chain pages
        are transferred to cache ownership (the caller acquires the
        returned pages and releases them at eviction); chain pages that
        exist already leave this request's duplicates alone. The partial
        tail page, when a snapshot page can be allocated, is shared by
        copy: ``copies`` are ``(src_page, dst_page)`` device copies for
        the engine. Returns ``(adopted_pages, copies)``."""
        ps = self.page_size
        nfull = len(prompt) // ps
        adopted, copies = [], []
        h = ROOT
        for i in range(nfull):
            page_tokens = prompt[i * ps:(i + 1) * ps]
            nh = _page_hash(h, page_tokens)
            if nh not in self.nodes:
                page = pages[i]
                self.allocator.transfer(owner, ("prefix", page), [page])
                self.nodes[nh] = {"page": page, "parent": h, "ntok": ps}
                self.refs.setdefault(page, 0)
                adopted.append(page)
            h = nh
        tail_tokens = tuple(int(t) for t in prompt[nfull * ps:])
        if tail_tokens and h not in self.tails:
            snap = self.allocator.alloc(("prefix-tail", h), 1)
            if snap is not None:
                self.tails[h] = {"page": snap[0], "tokens": tail_tokens}
                copies.append((pages[nfull], snap[0]))
        if h != ROOT:
            self._touch(h)
        return adopted, copies

    def _touch(self, leaf_hash):
        if leaf_hash in self._lru:
            self._lru.remove(leaf_hash)
        self._lru.append(leaf_hash)

    # ----------------------------------------------------------- reclaim

    def reclaim(self, n_pages, protect=()):
        """Free up to ``n_pages`` cached pages: tail snapshots first, then
        least recently used chains from the tail backward, refusing any
        page with live references and any page in ``protect`` (the cover
        an admission in flight just matched). Returns the number freed."""
        freed = 0
        protect = set(protect)
        for h in list(self.tails):
            if freed >= n_pages:
                break
            snap = self.tails[h]
            if snap["page"] in protect:
                continue
            del self.tails[h]
            self.allocator.free(("prefix-tail", h))
            self.refs.pop(snap["page"], None)
            freed += 1
        if freed >= n_pages:
            return freed
        children = {}
        for nh, node in self.nodes.items():
            children.setdefault(node["parent"], []).append(nh)
        for leaf in list(self._lru):
            h = leaf
            while freed < n_pages and h != ROOT and h in self.nodes:
                if children.get(h):
                    break  # interior page under a live descendant
                node = self.nodes[h]
                if self.refs.get(node["page"], 0) > 0:
                    break  # never free a page with live refs
                if node["page"] in protect:
                    break  # matched by the admission in flight
                page, parent = node["page"], node["parent"]
                self.allocator.free(("prefix", page))
                self.refs.pop(page, None)
                del self.nodes[h]
                if parent in children and h in children[parent]:
                    children[parent].remove(h)
                self.tails.pop(h, None)
                freed += 1
                h = parent
            if h != leaf:
                self._lru.remove(leaf)
                if h != ROOT and h in self.nodes:
                    self._touch(h)
            if freed >= n_pages:
                break
        return freed

    def flush(self):
        """Drop every cached chain page and tail snapshot back to the
        allocator (for a cache whose device contents are gone). Refuses
        under live references; returns the number of pages freed."""
        held = {p: n for p, n in self.refs.items() if n > 0}
        assert not held, (
            f"prefix flush with live references: {held} — requeue the "
            f"holding slots first")
        freed = 0
        for node in self.nodes.values():
            self.allocator.free(("prefix", node["page"]))
            freed += 1
        for h in list(self.tails):
            self.allocator.free(("prefix-tail", h))
            freed += 1
        self.nodes.clear()
        self.tails.clear()
        self.refs.clear()
        self._lru.clear()
        return freed

    # -------------------------------------------------------- invariants

    def cached_pages(self):
        pages = [n["page"] for n in self.nodes.values()]
        pages += [t["page"] for t in self.tails.values()]
        return pages

    def is_shared(self, page):
        """Whether ``page`` is cache-owned (a write to it must copy)."""
        return page in self.refs \
            or any(t["page"] == page for t in self.tails.values())

    def check_invariants(self):
        """Raise AssertionError on refcount or aliasing drift: every
        cached page allocator-live under a cache owner, refcounts
        non-negative and only on cached full pages, chains
        parent-connected, no page in two nodes."""
        pages = self.cached_pages()
        assert len(pages) == len(set(pages)), (
            f"prefix page aliased across chain nodes: {sorted(pages)}")
        live = set(self.allocator.live_pages())
        for nh, node in self.nodes.items():
            p = node["page"]
            assert p in live, f"cached page {p} not allocator-live"
            assert self.allocator.live_pages(("prefix", p)) == [p], (
                f"cached page {p} not owned by the prefix cache")
            parent = node["parent"]
            assert parent == ROOT or parent in self.nodes, (
                f"chain node {nh} orphaned (parent missing)")
        for h, t in self.tails.items():
            assert t["page"] in live, (
                f"tail snapshot page {t['page']} not allocator-live")
            assert 0 < len(t["tokens"]) < self.page_size
        full = {n["page"] for n in self.nodes.values()}
        for p, n in self.refs.items():
            assert n >= 0, f"negative refcount on page {p}"
            assert p in full, f"refcount on non-cached page {p}"
