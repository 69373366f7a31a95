"""Host-side serving POLICY layer of the port: admission, budgets, pages,
accounting — the counterpart of ``repro.serving.scheduler`` on the paged
layout.

This module decides WHO runs: `Request` intake and validation, FIFO
admission, per-request token budgets, shared-until-written page ownership
(`PageAllocator`: refcounted prefix sharing, block-table forking, the
copy-on-write transition), slot assignment and release, completion
records.  serving/engine.py decides HOW (the device pool and the steps).

Ported here, with the reference's semantics and in its words:

- "worst_case" allocation reserves a request's whole-sequence pages at
  admission; "lazy" reserves the prompt's pages and grows one page at a
  time at page boundaries, PREEMPTING the most preemptible running
  request (lowest priority, then latest/absent deadline, then most
  recently admitted) when the pool is exhausted.  A preempted request is
  requeued at the head WITH its generated tokens; its resume prefills
  prompt + emitted[:-1] and is admitted at its remaining worst case
  (anti-thrash), so its completion is token-for-token what an
  unpreempted run produces;
- `Request.best_of=n` prefills the prompt once and forks n-1 branches
  that share every prompt page (copy-on-write on divergence); the winner
  by cumulative logprob is recorded under the parent rid;
- `preempt(rid)`, `cancel(rid)`, deadline expiry, and the router's
  `RecomputeRecipe` export / import.

Not ported yet (later slices): the dense layout, `PerSlotBatcher`,
telemetry, the frontend and the router.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.sampling import (GREEDY, SamplingParams,
                                          SlotSampling, branch_key,
                                          key_zeros)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list           # token ids (ints)
    max_new: int
    # decode policy; None falls back to the batcher's default_sampling
    sampling: SamplingParams | None = None
    # preemption policy inputs (lazy allocation): a LOWER priority is
    # preempted first; among equal priorities the request with the latest
    # (or no) deadline goes first
    priority: int = 0
    deadline: float | None = None
    # best-of-n decoding: prefill once, fork n-1 branches sharing every
    # prompt page, record the winner by cumulative token logprob
    best_of: int = 1


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list
    prompt_len: int
    # top1-top2 score gap per emitted token: near-zero entries mark
    # numerical ties, where two implementations of the same math may
    # legitimately emit different tokens
    margins: list = dataclasses.field(default_factory=list)
    # per-token log-probability under the RAW (unscaled) distribution
    logprobs: list = dataclasses.field(default_factory=list)


def completions_equivalent(a, b, tie_tol: float = 1e-3) -> bool:
    """Token-for-token equality of two completion sets, tolerating argmax
    ties: sequences may first diverge only at a step whose margin (in
    either engine) is below `tie_tol`; past a tie the trajectories
    legitimately separate, so comparison stops for that sequence."""
    by_a = {c.rid: c for c in a}
    by_b = {c.rid: c for c in b}
    if set(by_a) != set(by_b):
        return False
    for rid, ca in by_a.items():
        cb = by_b[rid]
        if ca.prompt_len != cb.prompt_len:
            return False
        for i, (ta, tb) in enumerate(zip(ca.tokens, cb.tokens)):
            if ta != tb:
                ma = ca.margins[i] if i < len(ca.margins) else float("inf")
                mb = cb.margins[i] if i < len(cb.margins) else float("inf")
                if min(ma, mb) > tie_tol:
                    return False
                break  # diverged at a tie — trajectories separate here
        else:
            if len(ca.tokens) != len(cb.tokens):
                return False
    return True


@dataclasses.dataclass(frozen=True)
class RecomputeRecipe:
    """The portable form of an in-flight request: prompt + already-emitted
    tokens + the effective sampling params.  The destination
    chunk-prefills prompt + emitted[:-1], re-feeds the last emitted token,
    and its next sample folds the same noise key — nothing is re-sampled.
    `margins`/`logps` ride along so the Completion keeps full fidelity."""

    rid: int
    prompt: tuple
    max_new: int
    sampling: SamplingParams | None = None
    priority: int = 0
    deadline: float | None = None
    best_of: int = 1
    emitted: tuple = ()
    margins: tuple = ()
    logps: tuple = ()

    def nbytes(self) -> int:
        """Wire-size estimate: int32 token ids (prompt + emitted), f32
        margin + f32 logprob per emitted token, plus a fixed header."""
        return (4 * (len(self.prompt) + len(self.emitted))
                + 8 * len(self.emitted) + 72)

    def to_request(self) -> Request:
        return Request(rid=self.rid, prompt=list(self.prompt),
                       max_new=self.max_new, sampling=self.sampling,
                       priority=self.priority, deadline=self.deadline,
                       best_of=self.best_of)

    @classmethod
    def from_request(cls, req: Request,
                     default_sampling: SamplingParams | None = None,
                     emitted=(), margins=(), logps=()) -> "RecomputeRecipe":
        """Capture `req` as a recipe, pinning its EFFECTIVE sampling."""
        return cls(rid=req.rid, prompt=tuple(req.prompt),
                   max_new=req.max_new,
                   sampling=req.sampling or default_sampling,
                   priority=req.priority, deadline=req.deadline,
                   best_of=req.best_of, emitted=tuple(emitted),
                   margins=tuple(margins), logps=tuple(logps))


class PageAllocator:
    """Host-side manager of the shared KV page pool.

    A page is SHARED until written.  `share` takes one more reference on a
    live page; `fork` shares a whole block table's worth at a branch
    point; `ensure_private` is the copy-on-write transition — a holder
    about to WRITE a page that other holders still reference gives up its
    reference and gets a private replacement (the engine copies the
    contents in the next tick and repoints only that holder's entry).
    Full prompt pages are registered under a rolling prefix key, so a later
    request with the same prompt prefix shares them.  A page returns to
    the free list when its refcount reaches zero, and its prefix
    registration goes with it.  Page 0 is the null page, permanently
    pinned."""

    def __init__(self, n_pages: int, page_size: int,
                 allocation: str = "worst_case"):
        if n_pages < 2:
            raise ValueError(
                f"n_pages={n_pages}: need at least the null page plus one "
                f"usable page")
        if allocation not in ("worst_case", "lazy"):
            raise ValueError(
                f"allocation={allocation!r}: accepted values are "
                f"('worst_case', 'lazy')")
        self.n_pages = n_pages
        self.page_size = page_size
        self.allocation = allocation
        self._free = list(range(n_pages - 1, 0, -1))  # pop() -> 1, 2, ...
        self.refcount = np.zeros((n_pages,), np.int32)
        self.refcount[0] = 1  # null page: never allocated, never freed
        self._prefix: dict = {}    # chain key -> live page id
        self._page_key: dict = {}  # page id -> chain key (for dereg)
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Allocated pages (null page excluded)."""
        return self.n_pages - 1 - len(self._free)

    def alloc(self) -> int:
        pid = self._free.pop()
        self.refcount[pid] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pid

    def share(self, pid: int):
        """Take another reference on a live page."""
        if self.refcount[pid] <= 0:
            raise ValueError(f"page {pid} is not live")
        self.refcount[pid] += 1

    def fork(self, pages):
        """Share every page of a block table at a branch point."""
        for pid in pages:
            self.share(pid)

    def ensure_private(self, pid: int, reserved: int | None = None):
        """Copy-on-write transition for a holder about to WRITE page
        `pid`: returns ``(page, copied)``.  Sole holder -> (pid, False).
        Other holders remain -> this holder drops its reference and gets
        a private page (`reserved` if pre-allocated, else a fresh one):
        (new_pid, True)."""
        if pid == 0:
            raise ValueError("the null page is never written")
        if self.refcount[pid] <= 0:
            raise ValueError(f"page {pid} is not live")
        if self.refcount[pid] == 1:
            return pid, False
        new = reserved if reserved is not None else self.alloc()
        self.refcount[pid] -= 1
        return new, True

    def release(self, pid: int):
        if pid == 0:
            return
        self.refcount[pid] -= 1
        if self.refcount[pid] < 0:
            raise ValueError(f"page {pid} over-released")
        if self.refcount[pid] == 0:
            key = self._page_key.pop(pid, None)
            if key is not None and self._prefix.get(key) == pid:
                del self._prefix[key]
            self._free.append(pid)

    def lookup_prefix(self, key):
        return self._prefix.get(key)

    def register_prefix(self, key, pid: int):
        """Publish a full prompt page for sharing (first writer wins)."""
        if key not in self._prefix:
            self._prefix[key] = pid
            self._page_key[pid] = key


class ContinuousBatcher:
    """Continuous batching over the paged engine: one decode step per
    tick drives the whole slot pool; prompts take the chunked-prefill
    path (power-of-two blocks up to ``prefill_chunk``, never wrapping the
    logical ring) or, with ``prefill_mode="decode"``, are fed through
    decode ticks.

    ``ContinuousBatcher(cfg, params, ServingConfig(cache_layout="paged",
    ...), device="cuda")``."""

    def __init__(self, cfg: ModelConfig, params,
                 config: ServingConfig | None = None, *, device="cuda"):
        sc = config or ServingConfig()
        if sc.cache_layout != "paged":
            raise NotImplementedError(
                "the port serves cache_layout='paged' only; the dense ring "
                "layout is a later slice (ROADMAP.md)")
        self.config = sc
        self.cfg, self.params = cfg, params
        self.n_slots, self.capacity = sc.n_slots, sc.capacity
        self.bos_token = sc.bos_token
        self.default_sampling = sc.default_sampling or GREEDY
        self.cache_layout = sc.cache_layout
        self.allocation = sc.allocation
        self.prefill_mode = sc.prefill_mode
        self.prefill_chunk = sc.prefill_chunk
        # a freshly admitted/resumed request cannot be a preemption victim
        # until it has run this many decode ticks (0 = off)
        self.min_quantum = sc.min_quantum
        self.slot_req: list = [None] * sc.n_slots
        self.slot_state: list = [None] * sc.n_slots
        self.queue: list = []
        self.done: list = []
        self.active_slot_steps = 0
        self.total_slot_steps = 0
        self.preemptions = 0
        self.decode_ticks = 0
        self.decode_active_slots = 0
        # preempted requests awaiting re-admission: id(request) ->
        # (emitted, margins, logps)
        self._resume: dict = {}
        self._admit_seq = 0
        self._groups: dict = {}
        self.group_results: dict = {}
        self._cow_reserve: list = [[] for _ in range(sc.n_slots)]
        self.cow_copies = 0
        self.fork_shared_pages = 0
        self.page_growths = 0
        self.engine = PagedEngine(cfg, params, n_slots=sc.n_slots,
                                  capacity=sc.capacity,
                                  page_size=sc.page_size,
                                  n_pages=sc.n_pages, kernel=sc.kernel,
                                  device=device)
        self.allocator = PageAllocator(self.engine.n_pages, sc.page_size,
                                       sc.allocation)
        self.slot_pages: list = [[] for _ in range(sc.n_slots)]
        self._ring_cap = self.engine.ring_cap
        # sharing is sound only while the logical ring never wraps
        self._share = sc.share_prefix and self._ring_cap >= sc.capacity
        # skipping the shared tokens outright needs chunked prefill
        self._share_skip = self._share and sc.prefill_mode == "chunked"

    # ------------------------------------------------ engine delegation

    @property
    def decode_dispatches(self) -> int:
        return self.engine.decode_dispatches

    @property
    def prefill_dispatches(self) -> int:
        return self.engine.prefill_dispatches

    def cache_nbytes(self) -> int:
        return self.engine.cache_nbytes()

    # ------------------------------------------------------------- intake

    def submit(self, reqs: Iterable[Request]):
        accepted = []
        for req in reqs:
            if not req.prompt:
                if self.bos_token is None:
                    raise ValueError(
                        f"request {req.rid}: empty prompt — configure "
                        "bos_token to decode from BOS, or send >= 1 token "
                        "(the engine never fabricates a token)")
                req = dataclasses.replace(req, prompt=[self.bos_token])
            if len(req.prompt) >= self.capacity:
                raise ValueError(
                    f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                    f"leaves no room to generate within capacity "
                    f"{self.capacity}")
            if req.max_new < 1:
                raise ValueError(f"request {req.rid}: max_new must be >= 1")
            if req.best_of < 1:
                raise ValueError(f"request {req.rid}: best_of must be >= 1")
            self._admission_check(req)
            accepted.append(req)
        # atomic: a batch with an invalid request enqueues nothing
        self.queue.extend(accepted)

    def _budget(self, req: Request) -> int:
        """Tokens this request may emit: prompt + completion must fit in
        `capacity` cache entries."""
        return min(req.max_new, self.capacity - len(req.prompt))

    def _worst_case_pages(self, req: Request) -> int:
        total = min(len(req.prompt) + self._budget(req), self._ring_cap)
        return -(-total // self.engine.page_size)

    def _fork_page(self, req: Request) -> int:
        """Block-table index of the page holding the last prompt token,
        which every forked branch re-writes on its first tick."""
        return (len(req.prompt) - 1) // self.engine.page_size

    def _group_pages(self, req: Request) -> int:
        """Worst-case pages of a whole best_of=n group: the primary's W,
        per branch its private tail past the fork page and one CoW
        reserve, plus the primary's own CoW reserve when its first decode
        write lands in the shared fork page."""
        W = self._worst_case_pages(req)
        lw = self._fork_page(req)
        rsv = 1 if len(req.prompt) % self.engine.page_size else 0
        return W + (req.best_of - 1) * (W - lw) + rsv

    def _admission_check(self, req: Request):
        """Reject at submit() a request whose worst-case page budget can
        NEVER fit the pool, and best_of requests the layout cannot fork."""
        if req.best_of > 1:
            if self._ring_cap < self.capacity:
                raise ValueError(
                    f"request {req.rid}: best_of>1 is unsupported when "
                    f"the logical ring ({self._ring_cap}) can wrap within "
                    f"capacity {self.capacity} — a wrapped ring would "
                    f"overwrite the shared fork pages")
            if self.prefill_mode != "chunked":
                raise ValueError(
                    f"request {req.rid}: best_of>1 needs "
                    f"prefill_mode='chunked' (the fork point is the end "
                    f"of the primary's prefill)")
            if req.best_of > self.n_slots:
                raise ValueError(
                    f"request {req.rid}: best_of={req.best_of} exceeds "
                    f"the {self.n_slots}-slot pool — branches decode "
                    f"concurrently, one slot each")
            sp = req.sampling or self.default_sampling
            if sp.branch != 0:
                raise ValueError(
                    f"request {req.rid}: best_of>1 derives branch keys "
                    f"itself — submit with sampling.branch=0")
        need = self._group_pages(req) if req.best_of > 1 \
            and self.allocation == "worst_case" else \
            self._worst_case_pages(req)
        if need > self.engine.n_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {need} pages but the pool holds "
                f"{self.engine.n_pages - 1} — raise n_pages or lower "
                f"capacity")

    def _new_slot_state(self, req: Request, fed0: int = 0) -> dict:
        sp = req.sampling or self.default_sampling
        self._admit_seq += 1
        return {"emitted": [], "fed": fed0, "margins": [], "logps": [],
                "sp": sp, "admit_seq": self._admit_seq, "ran": 0,
                "key": branch_key(sp.seed, sp.branch)
                if sp.temperature > 0 else key_zeros()}

    # ----------------------------------------------------- sampling state

    def _sampling_row(self, s: int) -> SlotSampling:
        """Scalar-leaf SlotSampling for slot s (chunked-prefill step);
        `step` is the request's emit index."""
        st = self.slot_state[s]
        sp = st["sp"]
        return SlotSampling(
            key=st["key"], step=np.int32(len(st["emitted"])),
            temperature=np.float32(sp.temperature),
            top_k=np.int32(sp.top_k), top_p=np.float32(sp.top_p))

    def _sampling_batch(self) -> SlotSampling:
        """Per-slot sampling arrays for one decode tick (idle slots ride
        along as greedy don't-cares)."""
        n = self.n_slots
        key = np.zeros((n, 2), np.uint32)
        step = np.zeros((n,), np.int32)
        temp = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        top_p = np.ones((n,), np.float32)
        for s in range(n):
            st = self.slot_state[s]
            if st is None:
                continue
            sp = st["sp"]
            key[s] = st["key"]
            step[s] = len(st["emitted"])
            temp[s] = sp.temperature
            top_k[s] = sp.top_k
            top_p[s] = sp.top_p
        return SlotSampling(key, step, temp, top_k, top_p)

    # ---------------------------------------------------------- lifecycle

    def _finish_if_done(self, s: int):
        req, st = self.slot_req[s], self.slot_state[s]
        if len(st["emitted"]) >= self._budget(req):
            self._complete(req, Completion(
                rid=req.rid, tokens=list(st["emitted"]),
                prompt_len=len(req.prompt), margins=list(st["margins"]),
                logprobs=list(st["logps"])))
            self._release_slot(s)
            self.slot_req[s] = None
            self.slot_state[s] = None

    def _complete(self, req: Request, c: Completion):
        """Record a finished sequence.  best_of group members detour
        through their group: when the last branch finishes, the winner by
        cumulative logprob (ties to the lowest branch) is recorded under
        the parent rid and every branch archived in `group_results`."""
        g = self._groups.get(c.rid)
        if g is None or not any(m is req for m in g["members"]):
            self.done.append(c)
            return
        g["completions"][req.sampling.branch] = c
        if len(g["completions"]) == g["n"]:
            by_branch = dict(g["completions"])
            winner = min(by_branch.items(),
                         key=lambda kv: (-sum(kv[1].logprobs), kv[0]))[1]
            self.group_results[c.rid] = by_branch
            del self._groups[c.rid]
            self.done.append(winner)

    def _release_slot(self, s: int):
        """Reclaim slot s's pages (an unused CoW reserve included); the
        block-table row falls back to the null page."""
        for pid in self.slot_pages[s]:
            self.allocator.release(pid)
        for pid in self._cow_reserve[s]:
            self.allocator.release(pid)
        self.slot_pages[s] = []
        self._cow_reserve[s] = []
        self.engine.release(s)

    def cancel(self, rid: int) -> bool:
        """Drop request `rid` at whatever stage it is in (queued,
        mid-prefill, mid-decode, every branch of a best-of group); its
        slot and pages are reclaimed and no Completion is recorded.
        Returns False when the rid is unknown."""
        hit = False
        for i in range(len(self.queue) - 1, -1, -1):
            req = self.queue[i]
            if req.rid == rid:
                self.queue.pop(i)
                self._resume.pop(id(req), None)
                hit = True
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is not None and req.rid == rid:
                self._release_slot(s)
                self.slot_req[s] = None
                self.slot_state[s] = None
                hit = True
        if hit:
            self._groups.pop(rid, None)
        return hit

    def expire_deadlines(self, now: float) -> list:
        """Cancel every queued or running request whose deadline has
        passed (`now` on the deadlines' clock); returns their rids."""
        expired = []
        live = list(self.queue) + [r for r in self.slot_req if r is not None]
        for req in live:
            if req.deadline is not None and req.deadline <= now \
                    and req.rid not in expired:
                expired.append(req.rid)
        for rid in expired:
            self.cancel(rid)
        return expired

    # --------------------------------------------------------------- loop

    def run(self, max_steps: int = 10_000):
        """Drive the engine until queue and slots drain (or max_steps).
        Returns (completions finished during THIS call, steps)."""
        start = len(self.done)
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.done[start:], steps

    def utilization(self) -> float:
        """Fraction of offered slot-step capacity that carried a
        sequence (a size-S prefill block books S of each)."""
        return self.active_slot_steps / max(1, self.total_slot_steps)

    def mean_occupancy(self) -> float:
        """Mean fraction of the slot pool holding a live request per
        decode tick."""
        return self.decode_active_slots / max(1, self.decode_ticks
                                              * self.n_slots)

    # ---------------------------------------------------------- admission

    def _feed_tokens(self, req: Request) -> list:
        """Tokens whose K/V the slot must hold before decode can (re)start:
        the prompt, plus — on a preemption resume — every emitted token
        except the last (the next decode tick's input)."""
        rs = self._resume.get(id(req))
        if rs is None:
            return req.prompt
        return list(req.prompt) + rs[0][:-1]

    def _fill_slots(self):
        while self.queue:
            if self.queue[0].best_of > 1:
                if not self._admit_group(self.queue[0]):
                    break  # not enough slots/pages yet: FIFO stall
                continue
            s = next((i for i in range(self.n_slots)
                      if self.slot_req[i] is None), None)
            if s is None:
                break
            admitted = self._admit_paged(s)
            if admitted is None:
                break  # pool exhausted: FIFO stall until reclaim
            self._place(s, *admitted)

    def _place(self, s: int, req: Request, fed0: int):
        """Install an admitted request in slot s and run its prefill."""
        feed = self._feed_tokens(req)
        rs = self._resume.pop(id(req), None)
        self.slot_req[s] = req
        st = self._new_slot_state(req, fed0)
        if rs is not None:
            st["emitted"], st["margins"], st["logps"] = rs
        self.slot_state[s] = st
        if self.prefill_mode == "chunked":
            self._prefill_slot(s, feed, fresh=rs is None)
        else:
            # the prompt (and replayed tokens) is fed through decode ticks
            self.engine.mark_reset(s)

    def _admit_group(self, head: Request) -> bool:
        """Admit a best_of=n request: prefill the prompt ONCE into a
        primary slot, then fork n-1 branch slots whose block tables share
        every prompt page.  Each member is a best_of=1 clone with its own
        branch-folded sampling key.  Returns False (FIFO stall) while
        fewer than n slots are free or, under worst-case allocation, the
        pool cannot yet hold the whole group's page budget."""
        n = head.best_of
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        if len(free) < n:
            return False
        p = len(head.prompt)
        ps = self.engine.page_size
        W = self._worst_case_pages(head)
        lw = self._fork_page(head)
        if self.allocation == "worst_case" \
                and self.allocator.n_free < self._group_pages(head):
            return False
        sp = head.sampling or self.default_sampling
        members = [dataclasses.replace(
            head, best_of=1, sampling=dataclasses.replace(sp, branch=b))
            for b in range(n)]
        self._groups[head.rid] = {"n": n, "members": members,
                                  "completions": {}, "head": head}
        self.queue[0] = members[0]
        admitted = self._admit_paged(free[0])
        if admitted is None:  # lazy pool can't hold the prompt pages yet
            self.queue[0] = head
            del self._groups[head.rid]
            return False
        s0 = free[0]
        prim, fed0 = admitted
        # fork BEFORE the primary's prefill: branches only take page
        # references here; the prefill writes the shared pages before any
        # branch's first tick reads them
        shared = list(self.slot_pages[s0][:lw + 1])
        if self.allocation == "worst_case" and p % ps:
            self._cow_reserve[s0] = [self.allocator.alloc()]
        for b in range(1, n):
            sb = free[b]
            self.allocator.fork(shared)
            self.fork_shared_pages += len(shared)
            tail = [self.allocator.alloc() for _ in range(W - 1 - lw)] \
                if self.allocation == "worst_case" else []
            self._cow_reserve[sb] = [self.allocator.alloc()] \
                if self.allocation == "worst_case" else []
            self.slot_pages[sb] = shared + tail
            self.engine.fork_slot(s0, sb)
            for i, pid in enumerate(tail):
                self.engine.set_page(sb, lw + 1 + i, pid)
            # the branch re-feeds the last prompt token at position p-1:
            # its first tick samples its OWN first token (branch key),
            # writing the fork page, which triggers the CoW copy
            self.engine.set_pos(sb, p - 1)
            self.slot_req[sb] = members[b]
            self.slot_state[sb] = self._new_slot_state(members[b],
                                                       fed0=p - 1)
        self._place(s0, prim, fed0)
        return True

    def _prefix_chain(self, prompt, n_pages: int):
        """Rolling prefix keys of the first n_pages full prompt pages."""
        ps, chain, keys = self.engine.page_size, (), []
        for k in range(n_pages):
            chain = (chain, tuple(prompt[k * ps:(k + 1) * ps]))
            keys.append(chain)
        return keys

    def _admit_paged(self, s: int):
        """Try to admit the queue head into slot s, sharing refcounted
        prefix pages.  Worst case reserves every page the sequence can
        touch; lazy reserves only the pages the prefill writes (and a lazy
        RESUME its remaining worst case).  Returns (request,
        first-unshared-token) or None when the pool can't hold it yet."""
        req = self.queue[0]
        ps = self.engine.page_size
        feed = self._feed_tokens(req)
        if self.allocation == "lazy" and id(req) not in self._resume:
            need = -(-min(len(feed), self._ring_cap) // ps)
        else:
            need = self._worst_case_pages(req)
        shared: list = []
        full_pages = len(feed) // ps
        keys = self._prefix_chain(feed, full_pages) if self._share else []
        # skip mode must leave >= 1 token to feed (a fresh admission
        # samples its first generated token from the last fed logits)
        limit = min(full_pages, (len(feed) - 1) // ps) \
            if self._share_skip else full_pages
        for key in keys[:limit]:
            pid = self.allocator.lookup_prefix(key)
            if pid is None:
                break
            shared.append(pid)
        if self.allocator.n_free < need - len(shared):
            return None
        self.queue.pop(0)
        for pid in shared:
            self.allocator.share(pid)
        pages = shared + [self.allocator.alloc()
                          for _ in range(need - len(shared))]
        self.slot_pages[s] = pages
        if self._share:
            for k in range(len(shared), full_pages):
                self.allocator.register_prefix(keys[k], pages[k])
        fed0 = len(shared) * ps if self._share_skip else 0
        self.engine.admit(s, pages, fed0)
        return req, fed0

    # ------------------------------------------------------- preemption

    def preempt(self, rid: int) -> bool:
        """Force the running request `rid` back to the queue head with its
        generated tokens.  Returns False when rid is not in a slot."""
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is not None and req.rid == rid:
                self._preempt(s)
                return True
        return False

    def _preempt(self, s: int):
        """Host-side only: release slot s's pages, stash its emitted tokens
        for a resume prefill, requeue it at the head."""
        req, st = self.slot_req[s], self.slot_state[s]
        self.preemptions += 1
        if st["emitted"]:
            self._resume[id(req)] = (list(st["emitted"]),
                                     list(st["margins"]),
                                     list(st["logps"]))
        self._release_slot(s)
        self.slot_req[s] = None
        self.slot_state[s] = None
        self.queue.insert(0, req)

    def export_recipe(self, rid: int) -> RecomputeRecipe | None:
        """Extract request `rid` as a RecomputeRecipe (it leaves this
        batcher).  A live best-of group exports as a restart of the parent
        request.  None when the rid is unknown here."""
        g = self._groups.get(rid)
        if g is not None:
            self.cancel(rid)
            return RecomputeRecipe.from_request(g["head"],
                                                self.default_sampling)
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is not None and req.rid == rid:
                self._preempt(s)
                break
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                rs = self._resume.pop(id(req), None) or ((), (), ())
                return RecomputeRecipe.from_request(
                    req, self.default_sampling,
                    emitted=rs[0], margins=rs[1], logps=rs[2])
        return None

    def submit_recipe(self, recipe: RecomputeRecipe) -> Request:
        """Admit a migrated-in recipe; emitted tokens seed the resume
        stash, so admission runs the recompute-prefill path."""
        if len(recipe.prompt) + len(recipe.emitted) >= self.capacity:
            raise ValueError(
                f"request {recipe.rid}: recipe carries "
                f"{len(recipe.prompt)} prompt + {len(recipe.emitted)} "
                f"emitted tokens — does not fit capacity {self.capacity}")
        self.submit([recipe.to_request()])
        req = self.queue[-1]
        if recipe.emitted:
            self._resume[id(req)] = (list(recipe.emitted),
                                     list(recipe.margins),
                                     list(recipe.logps))
        return req

    def _victim_order(self, s: int):
        """Sort key: the MOST preemptible running request first."""
        req, st = self.slot_req[s], self.slot_state[s]
        dl = req.deadline if req.deadline is not None else float("inf")
        return (req.priority, -dl, -st["admit_seq"])

    def _alloc_with_preemption(self, s: int) -> bool:
        """Make sure the pool has a free page for slot s, preempting the
        most preemptible running request (possibly s itself) while it is
        exhausted.  Returns False when slot s yielded itself."""
        while self.allocator.n_free == 0:
            live = [v for v in range(self.n_slots)
                    if self.slot_req[v] is not None]
            ripe = [v for v in live
                    if self.slot_state[v]["ran"] >= self.min_quantum]
            victim = min(ripe or live, key=self._victim_order)
            self._preempt(victim)
            if victim == s:
                return False
        return self.slot_req[s] is not None

    def _secure_slot_pages(self):
        """Before the tick, make sure every live slot PRIVATELY owns the
        page its next token lands in: lazy growth at a page boundary
        (preempting on exhaustion), or the copy-on-write transition for a
        page other holders still reference (the copy is queued on the
        engine and runs before the tick's forward)."""
        ps = self.engine.page_size
        for s in range(self.n_slots):
            if self.slot_req[s] is None:
                continue
            pos = int(self.engine.slot_pos[s])
            idx = (pos % self._ring_cap) // ps
            if idx >= len(self.slot_pages[s]):
                if self.allocation != "lazy":
                    continue  # worst case owns every page up front
                if not self._alloc_with_preemption(s):
                    continue
                pid = self.allocator.alloc()
                self.slot_pages[s].append(pid)
                self.engine.set_page(s, idx, pid)
                self.page_growths += 1
                continue
            pid = self.slot_pages[s][idx]
            if pid == 0 or self.allocator.refcount[pid] <= 1:
                continue  # sole holder: write in place
            reserved = None
            if self._cow_reserve[s]:
                reserved = self._cow_reserve[s].pop()
            elif not self._alloc_with_preemption(s):
                continue  # the writer itself yielded
            new, _ = self.allocator.ensure_private(pid, reserved)
            self.slot_pages[s][idx] = new
            self.engine.set_page(s, idx, new)
            self.engine.queue_copy(s, pid, new)
            self.cow_copies += 1

    # ------------------------------------------------------------ prefill

    def _chunk_size(self, pos: int, remaining: int) -> int:
        """Prefill block size: <= prefill_chunk, power-of-two bucketed, and
        never wrapping the logical ring."""
        size = min(self.prefill_chunk, remaining)
        if pos + size > self._ring_cap:
            size = self._ring_cap - pos if pos < self._ring_cap else 1
        p = 1
        while p * 2 <= size:
            p *= 2
        return p

    def _prefill_slot(self, s: int, feed, fresh: bool = True):
        """Write `feed` into slot s in blocks, from st["fed"].  On a fresh
        admission the last block's logits give the first generated token;
        on a resume the block outputs are discarded."""
        st = self.slot_state[s]
        tokens = np.asarray(feed, np.int32)
        n, off, reset = len(tokens), st["fed"], True
        row = self._sampling_row(s)
        tok = margin = logp = None
        while off < n:
            size = self._chunk_size(off, n - off)
            tok, margin, logp = self.engine.prefill_block(
                s, tokens[None, off:off + size], off, reset, row)
            reset = False
            off += size
        self.active_slot_steps += n - st["fed"]
        self.total_slot_steps += n - st["fed"]
        self.engine.set_pos(s, n)
        st["fed"] = n
        if fresh:
            st["emitted"].append(tok)
            st["margins"].append(margin)
            st["logps"].append(logp)
            self._finish_if_done(s)

    # --------------------------------------------------------------- step

    def step(self):
        """One engine tick: secure each live slot's write page, then ONE
        decode step advances every active slot by one token (prompt feed
        in decode prefill mode, a replayed token on a decode-mode resume,
        or a generated one)."""
        self._fill_slots()
        self._secure_slot_pages()
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return False
        toks = np.zeros((self.n_slots, 1), np.int32)
        emit = np.zeros((self.n_slots,), bool)
        for s in active:
            req, st = self.slot_req[s], self.slot_state[s]
            p = len(req.prompt)
            if st["fed"] < p:
                toks[s, 0] = req.prompt[st["fed"]]
            else:
                toks[s, 0] = st["emitted"][st["fed"] - p]
            # only the feed of the last known token produces a NEW token
            emit[s] = st["fed"] == p + len(st["emitted"]) - 1
        active_mask = np.zeros((self.n_slots,), bool)
        active_mask[active] = True
        nxt, margins, logps = self.engine.decode(toks, active_mask,
                                                 self._sampling_batch())
        self.decode_ticks += 1
        self.decode_active_slots += len(active)
        self.active_slot_steps += len(active)
        self.total_slot_steps += self.n_slots
        for s in active:
            st = self.slot_state[s]
            st["fed"] += 1
            st["ran"] += 1
            if emit[s]:
                st["emitted"].append(int(nxt[s]))
                st["margins"].append(float(margins[s]))
                st["logps"].append(float(logps[s]))
                self._finish_if_done(s)
        return True
