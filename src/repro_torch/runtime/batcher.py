"""Continuous batching over the graph-native serving executors, as
``repro.runtime.batcher``.

Requests stream into the fixed batch slots of ONE decode executor: a free
slot gets a B=1 prefill graph whose per-layer caches are copied into the
decode state along the batch *storage* axis of whatever layout the decode
plan chose (AoS and AoSoA keep batch leading; SoA puts it behind the
component axis), while ``tokens``/``pos``/``active`` are per-slot vectors,
so every slot sits at its own sequence depth.

Retirement is host-side: after each step the harvested token is matched
against ``eos_token`` / ``max_new_tokens`` / the cache capacity and the
slot's ``active`` flag drops (an inactive slot keeps overwriting one stale
cache row, which is harmless: its logits are discarded and the slot is
prefilled anew at admission).

Fault tolerance: ``StepStats`` straggler detection per decode step, and
transient retries through :class:`~repro_torch.runtime.faults.RetryPolicy`
under ``max_failures``/``max_retries_per_step`` budgets, with the fault
sites ``batcher.step`` and ``batcher.admit``.  Recovery needs no
checkpoint: greedy decode is a pure function of the request log, so
``_recover()`` rebuilds the decode state by prefilling every in-flight
request's prompt + generated tokens anew.

On the GPU a decode step's kernels are queued and the call returns
before they finish, so ``prefill_ahead`` queues the queue head's prefills
behind the step before the batcher reads the step's tokens.

The decode executor takes the executor's defaults, as the reference's
does (``regions=True, donate=True``), and ``executor_opts`` override them
(``{"regions": False}``: per-segment dispatch).  Under the defaults the
decode step replays one captured CUDA graph, and ``self.state`` holds
aliases of its static buffers, so admission's in-place writes land in
them.  The prefill executors, one per prompt length, run eagerly
(``regions=False``): a capture per length pays only where exact prompt
lengths repeat many times, and costs a few tenths of a second and a
static copy of the prefill's state a length, where an eager prefill
costs tens of milliseconds and keeps nothing on the device between
calls (``PERF.md``).  :meth:`cache_stats` reports the executors'
relayout counts and, under ``regions=True``, the decode executor's
executable-cache counters.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.executor import Executor
from ..core.layout import Layout, relayout_data
from ..launch.steps import make_decode_graph, make_prefill_graph
from ..models import kvcache as kvc
from ..models.config import ModelConfig
from .faults import RetryPolicy, trip as _fault_trip
from .supervisor import StepStats

__all__ = ["Request", "Batcher"]


@dataclass
class Request:
    """One generation request moving queued -> active -> done/evicted."""

    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int
    generated: list = field(default_factory=list)
    status: str = "queued"
    slot: int = -1
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    token_times: list = field(default_factory=list)   # wall time per token

    @property
    def text_tokens(self) -> list:
        """The generated token ids."""
        return list(self.generated)


def _batch_axis(layout: Layout) -> int:
    """Storage axis of the batch space dim (only SoA's leading component
    axis shifts it)."""
    return 1 if layout is Layout.SOA else 0


def _scatter_slot(dst: torch.Tensor, src: torch.Tensor, slot: int,
                  axis: int) -> None:
    """Copy the batch-1 ``src`` into batch slot ``slot`` of ``dst``, in
    place."""
    dst.narrow(axis, slot, 1).copy_(src.to(dst.dtype))


class Batcher:
    """Admit/evict requests into the fixed batch slots of one decode
    executor; every admitted slot advances one greedy token per
    :meth:`step`.  The executors run on the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int,
                 max_seq: int, eos_token: Optional[int] = None,
                 max_failures: int = 10, max_retries_per_step: int = 3,
                 straggler_zscore: float = 3.0,
                 prefill_ahead: bool = True,
                 executor_opts: Optional[dict] = None,
                 retry: Optional[RetryPolicy] = None,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.params = params
        self.device = next(params.parameters()).device
        self.batch = batch
        self.max_seq = max_seq
        self.eos_token = eos_token
        self.max_failures = max_failures
        self.max_retries_per_step = max_retries_per_step
        self.straggler_zscore = straggler_zscore
        self.retry = retry if retry is not None \
            else RetryPolicy(base_delay=0.01, max_delay=0.25)
        self.log = log
        self._exec_opts = dict(executor_opts or {})
        self.dg = make_decode_graph(cfg, params, batch=batch,
                                    max_seq=max_seq)
        self.executor = Executor(self.dg.graph, self.device,
                                 **self._exec_opts)
        self.state = self.executor.init_state()
        self.slots: list = [None] * batch
        self.queue: deque = deque()
        self.retired: list = []
        self.stats = StepStats()
        self.steps = 0
        self.failures = 0
        self._next_rid = 0
        self._prefill: dict = {}   # prompt_len -> (PrefillGraph, Executor)
        self.prefill_ahead = bool(prefill_ahead)
        self._prepared: dict = {}  # rid -> (PrefillGraph, Executor, state)

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64) -> Request:
        """Queue a prompt (1-d token ids) for up to ``max_new_tokens``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq {self.max_seq}")
        req = Request(self._next_rid, prompt, max_new_tokens,
                      t_submit=time.perf_counter())
        self._next_rid += 1
        self.queue.append(req)
        return req

    def evict(self, rid: int) -> bool:
        """Drop a request wherever it is (queue or live slot)."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                self._prepared.pop(rid, None)
                req.status = "evicted"
                self.retired.append(req)
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self._retire(slot, status="evicted")
                return True
        return False

    @property
    def active_count(self) -> int:
        """Requests in a batch slot."""
        return sum(r is not None for r in self.slots)

    def pending(self) -> int:
        """Requests still queued."""
        return len(self.queue)

    # -- admission ---------------------------------------------------------
    def _prefill_for(self, prompt_len: int):
        if prompt_len not in self._prefill:
            pg = make_prefill_graph(self.cfg, self.params,
                                    prompt_len=prompt_len,
                                    max_seq=self.max_seq)
            self._prefill[prompt_len] = (pg, Executor(
                pg.graph, self.device, regions=False))
        return self._prefill[prompt_len]

    def _admit_ready(self) -> None:
        for slot in range(self.batch):
            if not self.queue:
                return
            if self.slots[slot] is None:
                # peek-admit-pop: a failure mid-admission leaves the
                # request at the queue head, so the retry re-admits it
                self._admit(self.queue[0], slot)
                self.queue.popleft()

    def _prefill_state(self, prompt: np.ndarray):
        pg, exp = self._prefill_for(len(prompt))
        pst = exp.init_state(prompt=torch.from_numpy(
            np.asarray(prompt, np.int32))[None])
        return pg, exp, exp(pst)

    def _prefill_ahead(self) -> None:
        """Queue prefills for the queue head behind the decode step in
        flight; :meth:`_admit` consumes them.  Recovery replays
        (``req.generated`` non-empty) never use them: their prefill
        includes the generated tokens."""
        for req in list(self.queue)[:self.batch]:
            if req.generated or req.rid in self._prepared:
                continue
            self._prepared[req.rid] = self._prefill_state(req.prompt)

    def _admit(self, req: Request, slot: int) -> None:
        # trips before any state changes: a failed admission is retryable
        _fault_trip("batcher.admit", detail=f"rid{req.rid}",
                    step=self.steps)
        prompt = np.concatenate([req.prompt,
                                 np.asarray(req.generated[:-1], np.int32)])
        prepared = self._prepared.pop(req.rid, None)
        if prepared is not None and not req.generated:
            pg, exp, pst = prepared
        else:
            pg, exp, pst = self._prefill_state(prompt)
        if req.generated:
            # recovery replay: the last generated token is the next input
            first = int(req.generated[-1])
        else:
            first = int(pst["first"][0])
        for cslot in pg.slots:
            if cslot.kind in ("A", "L"):
                name = cslot.tensors[0].name
                src = pst[name]
                src_lay = exp.plan.initial[name]
                dst_lay = self.executor.plan.initial[name]
                if src_lay is not dst_lay:
                    src = relayout_data(src, kvc.kv_spec(self.cfg.head_dim),
                                        src_lay, dst_lay)
                _scatter_slot(self.state[name], src, slot,
                              _batch_axis(dst_lay))
            else:
                for t in cslot.tensors:
                    _scatter_slot(self.state[t.name], pst[t.name], slot, 0)
        pos = len(prompt)
        self.state["tokens"][slot] = first
        self.state["pos"][slot] = pos
        self.state["active"][slot] = True
        req.slot = slot
        req.status = "active"
        now = time.perf_counter()
        if not req.t_admit:
            req.t_admit = now
        self.slots[slot] = req
        if not req.generated:
            req.generated.append(first)
            req.token_times.append(now)
            self._maybe_finish(slot, first, pos)

    def _retire(self, slot: int, status: str = "done") -> None:
        req = self.slots[slot]
        if req is None:
            return
        req.status = status
        req.t_done = time.perf_counter()
        req.slot = -1
        self.slots[slot] = None
        self.retired.append(req)
        self.state["active"][slot] = False

    def _maybe_finish(self, slot: int, token: int, pos: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        if (self.eos_token is not None and token == self.eos_token) \
                or len(req.generated) >= req.max_new_tokens \
                or pos + 1 >= self.max_seq:
            self._retire(slot)

    # -- decode steps ------------------------------------------------------
    def step(self) -> bool:
        """Admit what fits, advance every active slot one token.  Returns
        False when nothing was active.

        Admission runs inside the retried block, so a failure during
        admission recovers like a failed decode step: backoff per the
        :class:`RetryPolicy`, then request-log replay (``_recover``), whose
        own faults consume the same retry budget."""
        retries = 0
        need_recover = False
        while True:
            try:
                if need_recover:
                    need_recover = False
                    self._recover()
                self._admit_ready()
                if self.active_count == 0:
                    return False
                t0 = time.perf_counter()
                _fault_trip("batcher.step", step=self.steps)
                self.state = self.executor(self.state)
                t_dispatch = time.perf_counter() - t0
                if self.prefill_ahead:
                    self._prefill_ahead()
                # completion time: the step's tokens on the host
                tokens = self.state["tokens"].cpu().numpy()
                dt = time.perf_counter() - t0
                if self.stats.update(dt, self.steps,
                                     self.straggler_zscore,
                                     dispatch=t_dispatch):
                    self.log(f"[batcher] straggler step {self.steps}: "
                             f"{dt * 1e3:.1f}ms "
                             f"(mean {self.stats.mean * 1e3:.1f})")
                break
            except Exception as e:
                if not self.retry.is_transient(e):
                    raise
                self.failures += 1
                retries += 1
                if self.failures > self.max_failures:
                    raise RuntimeError(
                        f"exceeded max_failures={self.max_failures}") from e
                if retries > self.max_retries_per_step:
                    raise RuntimeError(
                        f"decode step failed {retries} times") from e
                self.log(f"[batcher] transient failure ({e}); replaying "
                         f"{self.active_count} in-flight request(s) "
                         f"(retry {retries}, backoff "
                         f"{self.retry.backoff(retries) * 1e3:.0f}ms)")
                self.retry.backoff_sleep(retries)
                need_recover = True
        self.steps += 1
        self._harvest(tokens)
        return True

    def _harvest(self, tokens: np.ndarray) -> None:
        pos = self.state["pos"].cpu().numpy()
        now = time.perf_counter()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(tokens[slot])
            req.generated.append(tok)
            req.token_times.append(now)
            self._maybe_finish(slot, tok, int(pos[slot]))

    def _recover(self) -> None:
        """Rebuild the decode state from the request log: prefill every
        live request's prompt + generated tokens anew (greedy decode is
        deterministic); the last generated token becomes the next input.
        Requests stay in ``self.slots`` throughout, so a fault during
        recovery leaves every live request for the retry."""
        live = [(slot, req) for slot, req in enumerate(self.slots)
                if req is not None]
        self.state = self.executor.init_state()
        for slot, req in live:
            self._admit(req, slot)

    def run(self, max_steps: Optional[int] = None) -> list:
        """Drain: admit + step until every request retired (or the step
        budget runs out).  Returns the retired requests."""
        while self.queue or self.active_count:
            if max_steps is not None and self.steps >= max_steps:
                break
            if not self.step():
                if not self.queue:
                    break
        return self.retired

    # -- introspection -----------------------------------------------------
    def cache_stats(self) -> dict[str, Any]:
        """Relayouts the decode and prefill executors made, and the decode
        executor's executable-cache counters when it compiles regions."""
        decode = {"steps": self.steps,
                  "relayouts": self.executor.eager_relayouts}
        if self.executor.regions:
            decode.update(self.executor.cache_stats())
        return {"decode": decode,
                "prefill": {S: {"relayouts": ex.eager_relayouts}
                            for S, (_, ex) in sorted(self._prefill.items())}}
