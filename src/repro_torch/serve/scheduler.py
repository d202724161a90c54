"""Continuous-batching scheduler: admission control + slot lifecycle
(port of ``repro/serve/scheduler.py``, pure Python; DESIGN.md §11).

Requests move QUEUED -> PREFILL -> DECODE -> DONE.  The scheduler owns the
queue and the slot map; the engine owns the device step.  Admission is
two-gated: a free batch slot AND the paged cache able to cover the request's
*worst-case* footprint (prompt + max_new_tokens) — reserving up front means
a running request can never hit OutOfBlocks mid-decode, so there is no
preemption path to get wrong.

Joins and retires happen mid-loop between decode steps: ``admit()`` fills
free slots from the queue each engine step, ``retire()`` frees a finished
request's slot immediately, so the next ``admit()`` can reuse it — the
continuous-batching property the tests pin down.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"
CANCELLED = "cancelled"


@dataclasses.dataclass
class Request:
    """One generation request and its measured lifecycle."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    state: str = QUEUED
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    t_enqueue: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    # Per-request deadline, seconds after t_enqueue (0 = none).  An expired
    # request is cancelled wherever it is — queued or mid-decode — and its
    # slot + KV reservation are released immediately.
    deadline_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_budget(self) -> int:
        """Worst-case cache footprint in tokens (reserved at admission)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def decode_pos(self) -> int:
        """Cache position the next decode step writes — the last generated
        token's position (prefill wrote 0..prompt_len-1; generated token i
        sits at prompt_len+i).  Meaningful once prefill produced a token."""
        return self.prompt_len + len(self.generated) - 1

    @property
    def finished(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def latency_ms(self) -> float:
        return (self.t_done - self.t_enqueue) * 1e3

    def first_token_ms(self) -> float:
        return (self.t_first_token - self.t_enqueue) * 1e3


class Scheduler:
    """Admission-control queue over ``max_slots`` concurrent batch slots.

    ``can_cover(tokens)`` is the cache's admission gate (how many tokens of
    KV the pool can still reserve); ``reserve(slot, tokens)`` performs the
    reservation.  Both are injected so the scheduler stays a pure
    policy/bookkeeping object the tests can drive without a device.
    """

    def __init__(self, *, max_slots: int,
                 can_cover: Callable[[int], bool],
                 reserve: Callable[[int, int], None],
                 release: Callable[[int], None],
                 clock: Callable[[], float] = time.perf_counter):
        self.max_slots = max_slots
        self._can_cover = can_cover
        self._reserve = reserve
        self._release = release
        self._clock = clock
        self._queue: Deque[Request] = deque()
        self._slots: Dict[int, Request] = {}      # slot -> running request
        self._rid = itertools.count()
        self.completed: List[Request] = []
        self.cancelled: List[Request] = []

    # -- queue side ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int,
               deadline_s: float = 0.0) -> Request:
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=int(max_new_tokens),
                      t_enqueue=self._clock(),
                      deadline_s=float(deadline_s))
        self._queue.append(req)
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel a request wherever it is.  A queued request leaves the
        queue; an active one releases its slot AND its KV reservation (the
        fix for the stuck-client leak: before this, only retirement
        released, so an abandoned request held its worst-case footprint
        forever).  Returns False if the request already finished."""
        if req.state == DONE or req.state == CANCELLED:
            return False
        if req.state == QUEUED:
            try:
                self._queue.remove(req)
            except ValueError:
                return False
        else:
            self._release(req.slot)
            del self._slots[req.slot]
        req.state = CANCELLED
        req.t_done = self._clock()
        self.cancelled.append(req)
        return True

    def expire_deadlines(self) -> List[Request]:
        """Cancel every request (queued or active) past its deadline."""
        now = self._clock()
        expired = [r for r in list(self._queue) + self.active
                   if r.deadline_s and now - r.t_enqueue > r.deadline_s]
        return [r for r in expired if self.cancel(r)]

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> List[Request]:
        return [self._slots[s] for s in sorted(self._slots)]

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._slots)

    def slot_of(self, slot: int) -> Optional[Request]:
        return self._slots.get(slot)

    # -- engine side --------------------------------------------------------

    def admit(self) -> List[Request]:
        """Move queue heads into free slots while both gates pass.  FIFO —
        a too-big head blocks the queue rather than starving large requests
        behind small ones.  Admitted requests enter PREFILL with their full
        footprint reserved."""
        admitted: List[Request] = []
        free = sorted(set(range(self.max_slots)) - set(self._slots))
        while free and self._queue \
                and self._can_cover(self._queue[0].total_budget):
            req = self._queue.popleft()
            slot = free.pop(0)
            self._reserve(slot, req.total_budget)
            req.slot = slot
            req.state = PREFILL
            req.t_admitted = self._clock()
            self._slots[slot] = req
            admitted.append(req)
        return admitted

    def mark_decoding(self, req: Request, first_token: int) -> None:
        """Prefill produced the request's first generated token."""
        req.generated.append(int(first_token))
        req.t_first_token = self._clock()
        req.state = DECODE

    def append_token(self, req: Request, token: int) -> None:
        req.generated.append(int(token))

    def retire_finished(self) -> List[Request]:
        """Retire every request that hit its token budget: free the slot and
        its cache blocks so this step's ``admit()`` can reuse them."""
        done: List[Request] = []
        for slot in sorted(self._slots):
            req = self._slots[slot]
            if req.state == DECODE and req.finished:
                req.state = DONE
                req.t_done = self._clock()
                self._release(slot)
                del self._slots[slot]
                self.completed.append(req)
                done.append(req)
        return done
