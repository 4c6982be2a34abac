"""Coloring-as-a-service: the session-pool serving layer (port of
``repro.launch.coloring_service``).

``ColoringService`` turns the port's coloring engines into a long-lived
server loop with explicit capacity contracts, as ``repro``'s does:

* **Session pool.**  The service owns a pool of live ``ColoringSession``
  objects keyed by caller-chosen ids, LRU-ordered.  Admission past
  ``pool_size`` evicts the least-recently-used session: with a
  ``spill_dir`` the victim is checkpointed through the durable journal
  (``attach_durable``) and transparently ``restore()``d on its next touch;
  without one the eviction is permanent and later touches raise the
  structured ``SessionEvicted``.  Spill directories are ``repro``'s: one
  written by either service restores in the other.

* **Bounded queue + backpressure.**  Every request enters one bounded FIFO
  queue.  A full queue REJECTS at submit time with ``Overloaded`` (payload:
  depth, limit, a retry-after hint from the recent per-request service
  time).

* **Micro-batching.**  One-shot ``color()`` requests drained in the same
  cycle are bucketed by ``(distance2, pow2 n class, pow2 width class,
  ColorOptions)`` and dispatched as ONE ``color_batch_fused`` call per
  bucket over a packed ``GraphBatch``, padded as ``repro`` pads it: one
  edge-free graph of the pow2 ``n`` (it fixes ``n_max``), zero-vertex
  graphs up to a pow2 graph count and the pow2 width (``width=``).  The
  port has no jit cache to pin; it keeps the padding so that every result
  field (``padded_work`` charges ``n_max × W`` a global step) equals
  ``repro``'s service, and keeps ``bucket_jit_hits`` / ``_misses`` as host
  bookkeeping of the ``(bucket, pow2 B)`` keys presented.  Requests the
  batched engine cannot host (other algorithms, ``ensure_valid``,
  ``trace``, ``validate_input``, extra knobs) take the per-request
  ``repro_torch.color`` inside the worker — same results, no bucketing.

* **Deferred maintenance.**  Pooled sessions run with
  ``defer_maintenance=True``; the worker runs ``session.maintain()`` in
  idle slots (after ~0.25 s of silence) instead.

* **One device.**  The service runs every micro-batch, slow-path call and
  session on the device it was built with (``device=None`` means
  ``"cuda"`` and raises without a card; ``device="cpu"`` runs the kernels'
  plain versions).  A per-request ``device=`` is refused with
  ``ValueError``.  Results are host numpy arrays, read back by the worker
  before a ticket finishes; an error raised in the worker (a kernel's
  launch error included) reaches the caller through its ticket and is
  never retried elsewhere.

Synchronous calls block on a ``Ticket`` (a thread-safe future-lite that
also timestamps enqueue/start/finish); pass ``wait=False`` to get the
ticket itself and overlap request submission, as
``benchmarks/port_serve.py`` does for Poisson traffic.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from repro_torch.errors import Overloaded, SessionEvicted
from repro_torch.obs.spans import SpanRecorder, span
from repro_torch.options import ColorOptions

__all__ = ["ColoringService", "Ticket"]


class Ticket:
    """One queued request's completion handle (thread-safe future-lite).

    ``wait()`` blocks until the worker finished the request, re-raising the
    worker-side exception verbatim.  Timestamps (``enqueued_at``,
    ``started_at``, ``done_at``; monotonic seconds) make queueing delay and
    service time separable: ``latency`` is the full submit→finish wall time
    a client observes.
    """

    __slots__ = ("kind", "sid", "payload", "options", "result", "error",
                 "enqueued_at", "started_at", "done_at", "_event")

    def __init__(self, kind: str, sid: str | None = None, payload=None,
                 options: ColorOptions | None = None):
        self.kind = kind
        self.sid = sid
        self.payload = payload
        self.options = options
        self.result = None
        self.error: BaseException | None = None
        self.enqueued_at = time.perf_counter()
        self.started_at: float | None = None
        self.done_at: float | None = None
        self._event = threading.Event()

    def wait(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.kind!r} did not finish within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency(self) -> float:
        """Submit→finish wall seconds (queueing + service time)."""
        if self.done_at is None:
            raise RuntimeError("request has not finished")
        return self.done_at - self.enqueued_at

    def _finish(self, result=None, error: BaseException | None = None):
        self.result = result
        self.error = error
        self.done_at = time.perf_counter()
        self._event.set()


def _safe_name(sid: str) -> str:
    """A filesystem-safe spill directory name for a caller-chosen sid
    (``repro``'s rule, so spill directories cross between the services)."""
    return "".join(c if (c.isalnum() or c in "-_.") else "_" for c in sid)


class ColoringService:
    """Session-pool coloring server: see the module doc for the contract.

    Parameters
    ----------
    pool_size:
        Live ``ColoringSession`` capacity; admission past it evicts LRU.
    queue_limit:
        Bounded request queue depth; a full queue raises ``Overloaded`` at
        submit time.
    max_batch:
        Requests drained per worker cycle (the micro-batch window).
    spill_dir:
        Directory for durable eviction spill (session journals); ``None``
        makes evictions permanent (``SessionEvicted`` on later touch).
    options:
        Service-wide default ``ColorOptions`` (or ``None``); per-call
        options/kwargs override it.
    trace:
        Keep a live ``SpanRecorder`` over the worker loop; drained via
        ``take_spans()`` (per-request / micro-batch / maintenance spans).
    device:
        Where every request runs (default ``"cuda"``; raises without a
        card).
    """

    def __init__(self, *, pool_size: int = 8, queue_limit: int = 64,
                 max_batch: int = 32, spill_dir: str | None = None,
                 options: ColorOptions | None = None,
                 idle_maintenance: bool = True, trace: bool = False,
                 device=None):
        from repro_torch.kernels.dispatch import resolve_backend

        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self._device = resolve_backend(None, device)
        self._pool_size = int(pool_size)
        self._queue_limit = int(queue_limit)
        self._max_batch = max(1, int(max_batch))
        self._spill_dir = spill_dir
        self._default_options = _no_device(
            ColorOptions() if options is None else ColorOptions.normalize(options))
        self._idle_maintenance = bool(idle_maintenance)
        self._recorder = SpanRecorder() if trace else None

        self._lock = threading.Lock()        # queue + counters
        self._pool_lock = threading.Lock()   # pool/spill/bucket structures
        self._not_empty = threading.Condition(self._lock)
        self._queue: deque[Ticket] = deque()
        self._pool: "OrderedDict[str, object]" = OrderedDict()
        self._spilled: set[str] = set()      # sids durable on disk, not live
        self._evicted: set[str] = set()      # sids dropped with no spill
        self._jit_keys: set = set()          # (bucket, pow2 B) keys presented
        self._bucket_stats: dict = {}
        self._counters = {
            "admitted": 0, "rejected": 0, "completed": 0, "failed": 0,
            "evictions": 0, "spills": 0, "restores": 0, "maintenance": 0,
            "microbatches": 0, "batched_requests": 0, "slow_requests": 0,
            "bucket_jit_hits": 0, "bucket_jit_misses": 0,
        }
        self._ewma_req_s = 0.0
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="coloring-service", daemon=True)
        self._worker.start()

    # -- context manager ----------------------------------------------------
    def __enter__(self) -> "ColoringService":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    # -- submission (any thread) --------------------------------------------
    def _submit(self, ticket: Ticket) -> Ticket:
        with self._not_empty:
            if self._closed:
                raise RuntimeError("ColoringService is shut down")
            depth = len(self._queue)
            if depth >= self._queue_limit:
                self._counters["rejected"] += 1
                raise Overloaded(
                    f"request queue full ({depth}/{self._queue_limit}); "
                    "retry after the backlog drains",
                    queue_depth=depth, limit=self._queue_limit,
                    retry_after=round(depth * self._ewma_req_s, 6))
            self._queue.append(ticket)
            self._counters["admitted"] += 1
            self._not_empty.notify()
        return ticket

    def _normalize(self, options, opts) -> ColorOptions:
        base = self._default_options if options is None else options
        return _no_device(ColorOptions.normalize(base, **opts))

    # -- public API ---------------------------------------------------------
    def open_session(self, sid: str, graph, *, options=None, wait=True,
                     **opts):
        """Admit a session for ``graph`` under id ``sid`` (evicting LRU).

        Returns a summary dict (n, num_colors, converged, evicted victim if
        any).  Re-using a live ``sid`` replaces that session.
        """
        o = self._normalize(options, opts)
        t = Ticket("open", sid=sid, payload=graph, options=o)
        self._submit(t)
        return t.wait() if wait else t

    def apply_delta(self, sid: str, *, wait=True, **delta):
        """Mutate session ``sid``; returns the dirtied vertex ids."""
        t = Ticket("delta", sid=sid, payload=delta)
        self._submit(t)
        return t.wait() if wait else t

    def recolor(self, sid: str, *, full: bool = False, wait=True):
        """Repair session ``sid`` after pending deltas (``ColoringResult``).

        Back-to-back recolors of one session drained in the same cycle
        coalesce naturally: the first clears the frontier, the rest are
        zero-work no-ops returning the committed coloring.
        """
        t = Ticket("recolor", sid=sid, payload={"full": bool(full)})
        self._submit(t)
        return t.wait() if wait else t

    def colors(self, sid: str, *, wait=True):
        """The committed coloring of session ``sid`` (a host copy)."""
        t = Ticket("colors", sid=sid)
        self._submit(t)
        return t.wait() if wait else t

    def color(self, graph, *, options=None, wait=True, **opts):
        """One-shot coloring through the micro-batcher (``ColoringResult``).

        Requests sharing a ``(shape class, ColorOptions)`` bucket in a
        drain cycle run as one batched call (see module doc); every field
        equals ``repro_torch.color(graph, options=..., device=...)``'s.
        """
        o = self._normalize(options, opts)
        t = Ticket("color", payload=graph, options=o)
        self._submit(t)
        return t.wait() if wait else t

    def session_metrics(self, sid: str, *, wait=True):
        """The session's own ``metrics()`` dict."""
        t = Ticket("session_metrics", sid=sid)
        self._submit(t)
        return t.wait() if wait else t

    def close_session(self, sid: str, *, wait=True):
        """Drop session ``sid`` from the pool (spilled state stays on disk)."""
        t = Ticket("close", sid=sid)
        self._submit(t)
        return t.wait() if wait else t

    def maintain(self, sid: str | None = None, *, wait=True):
        """Run due deferred maintenance NOW (compaction / snapshot).

        ``sid=None`` sweeps every live session.  Idle-slot maintenance only
        fires after a sustained silence, so a service under continuous load
        should call this in a known lull.  Returns ``{sid: [actions...]}``.
        """
        t = Ticket("maintain", sid=sid)
        self._submit(t)
        return t.wait() if wait else t

    def metrics(self) -> dict:
        """Service-level counters: queue, pool, buckets, key accounting.

        ``bucket_jit_misses`` counts micro-batch dispatches whose ``(bucket,
        pow2 batch size)`` key was never presented before, as ``repro``'s
        service counts its jit cache misses; the port compiles nothing per
        key, so it is bookkeeping that equals ``repro``'s count.
        """
        with self._lock:
            out = dict(self._counters)
            out["queue_depth"] = len(self._queue)
            out["queue_limit"] = self._queue_limit
            out["ewma_request_seconds"] = self._ewma_req_s
        with self._pool_lock:
            out["pool_occupancy"] = len(self._pool)
            out["pool_size"] = self._pool_size
            out["spilled_sessions"] = len(self._spilled)
            out["buckets"] = {k: dict(v) for k, v in
                              self._bucket_stats.items()}
            sessions = list(self._pool.values())
        hits = misses = 0
        for s in sessions:
            c = s._counters
            hits += c["engine_cache_hits"]
            misses += c["engine_cache_misses"]
        out["session_engine_cache_hits"] = hits
        out["session_engine_cache_misses"] = misses
        return out

    def take_spans(self) -> list:
        """Drain the service recorder's span events (``trace=True`` only)."""
        if self._recorder is None:
            return []
        events, self._recorder.events = self._recorder.events, []
        return events

    def shutdown(self, *, wait: bool = True) -> None:
        """Stop accepting requests; drain the queue, then stop the worker."""
        with self._not_empty:
            if self._closed:
                return
            self._closed = True
            self._not_empty.notify_all()
        if wait:
            self._worker.join()

    # -- worker loop ---------------------------------------------------------
    def _run(self) -> None:
        if self._recorder is not None:
            with self._recorder:
                self._loop()
        else:
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._not_empty:
                # Hysteresis: a maintenance slice (compaction/snapshot) can
                # stall the worker for a while, so a gap between Poisson
                # arrivals must NOT trigger one — only a sustained silence
                # (several full poll intervals, ~0.25 s) counts as idle.
                idle = 0
                while not self._queue and not self._closed:
                    if (idle >= 5 and self._idle_maintenance
                            and self._maintenance_target()):
                        break  # leave the lock to run one maintenance slice
                    idle = 0 if self._not_empty.wait(timeout=0.05) else idle + 1
                if self._closed and not self._queue:
                    return
                cycle = [self._queue.popleft()
                         for _ in range(min(len(self._queue),
                                            self._max_batch))]
            if not cycle:
                self._run_maintenance()
                continue
            self._dispatch(cycle)

    def _dispatch(self, cycle: list[Ticket]) -> None:
        t0 = time.perf_counter()
        # Arrival order, batching maximal CONSECUTIVE runs of one-shot
        # colors: hoisting session ops ahead of the colors would make a
        # color enqueued first wait on session ops that arrived after it.
        i = 0
        while i < len(cycle):
            if cycle[i].kind == "color":
                j = i
                while j < len(cycle) and cycle[j].kind == "color":
                    cycle[j].started_at = time.perf_counter()
                    j += 1
                self._dispatch_colors(cycle[i:j])
                i = j
            else:
                cycle[i].started_at = time.perf_counter()
                self._run_session_op(cycle[i])
                i += 1
        # retry-after hint: EWMA of per-request service time this cycle
        per_req = (time.perf_counter() - t0) / len(cycle)
        self._ewma_req_s = (per_req if self._ewma_req_s == 0.0
                            else 0.8 * self._ewma_req_s + 0.2 * per_req)

    # -- session ops ---------------------------------------------------------
    def _run_session_op(self, t: Ticket) -> None:
        try:
            with span("serve_request", kind=t.kind, sid=t.sid):
                result = getattr(self, f"_op_{t.kind}")(t)
            self._counters["completed"] += 1
            t._finish(result=result)
        except BaseException as e:  # cross the thread boundary verbatim
            self._counters["failed"] += 1
            t._finish(error=e)

    def _touch(self, sid: str):
        """The live session for ``sid``, restoring a spilled one (LRU bump)."""
        with self._pool_lock:
            sess = self._pool.get(sid)
            if sess is not None:
                self._pool.move_to_end(sid)
                return sess
        if sid in self._spilled:
            from repro_torch.dynamic import ColoringSession

            with span("serve_restore", sid=sid):
                sess = ColoringSession.restore(self._spill_path(sid),
                                               device=self._device)
            with self._pool_lock:
                self._spilled.discard(sid)
                self._counters["restores"] += 1
                self._admit(sid, sess)
            return sess
        if sid in self._evicted:
            raise SessionEvicted(
                f"session {sid!r} was evicted from the pool (no spill_dir "
                "was configured); re-open it from the source graph",
                session_id=sid)
        raise KeyError(f"unknown session id {sid!r}")

    def _spill_path(self, sid: str) -> str:
        return os.path.join(self._spill_dir, _safe_name(sid))

    def _admit(self, sid: str, sess) -> str | None:
        """Insert ``sess`` under ``sid``, evicting LRU victims past capacity."""
        victim = None
        while len(self._pool) >= self._pool_size:
            vsid, vsess = self._pool.popitem(last=False)
            self._counters["evictions"] += 1
            if self._spill_dir is not None:
                with span("serve_spill", sid=vsid):
                    vsess.attach_durable(self._spill_path(vsid))
                self._spilled.add(vsid)
                self._counters["spills"] += 1
            else:
                self._evicted.add(vsid)
            victim = vsid
        self._pool[sid] = sess
        return victim

    def _op_open(self, t: Ticket):
        from repro_torch.core.csr import CSRGraph
        from repro_torch.dynamic import ColoringSession

        graph = t.payload
        if not isinstance(graph, CSRGraph):
            raise TypeError(
                "open_session takes a CSRGraph; build one first (e.g. "
                f"csr_from_edges) — got {type(graph).__name__}")
        kwargs = t.options.session_kwargs()
        kwargs.setdefault("defer_maintenance", True)
        sess = ColoringSession(graph, **kwargs, device=self._device)
        with self._pool_lock:
            self._evicted.discard(t.sid)
            self._spilled.discard(t.sid)
            self._pool.pop(t.sid, None)  # re-open replaces
            victim = self._admit(t.sid, sess)
        return {"sid": t.sid, "n": int(sess.n),
                "num_colors": int(sess.num_colors),
                "converged": bool(sess.result.converged),
                "evicted": victim}

    def _op_delta(self, t: Ticket):
        return self._touch(t.sid).apply_delta(**t.payload)

    def _op_recolor(self, t: Ticket):
        return self._touch(t.sid).recolor(full=t.payload["full"])

    def _op_colors(self, t: Ticket):
        return np.asarray(self._touch(t.sid).colors).copy()

    def _op_session_metrics(self, t: Ticket):
        return self._touch(t.sid).metrics()

    def _op_close(self, t: Ticket):
        with self._pool_lock:
            existed = self._pool.pop(t.sid, None) is not None
            existed = (t.sid in self._spilled) or existed
            self._spilled.discard(t.sid)
            self._evicted.discard(t.sid)
        return bool(existed)

    def _op_maintain(self, t: Ticket):
        if t.sid is not None:
            sids = [t.sid]
        else:
            with self._pool_lock:
                sids = list(self._pool.keys())
        out = {}
        for sid in sids:
            sess = self._touch(sid)
            with span("serve_maintenance", sid=sid):
                actions = sess.maintain()
            out[sid] = actions
            if actions:
                self._counters["maintenance"] += 1
        return out

    # -- one-shot micro-batching ---------------------------------------------
    def _bucket_key(self, graph, o: ColorOptions):
        """The micro-batch bucket, or None for the per-request slow path."""
        from repro_torch.core.csr import CSRGraph, next_pow2

        if not isinstance(graph, CSRGraph):
            return None
        algorithm = o.algorithm or "fused"
        if (algorithm not in ("fused", "distance2")
                or o.engine not in (None, "batch") or o.ensure_valid
                or o.trace or o.validate_input is not None or o.extra):
            return None
        d2 = algorithm == "distance2"
        wb = graph.two_hop_degree_bound() if d2 else graph.max_degree
        canon = dataclasses.replace(o, algorithm=algorithm, engine=None)
        return (d2, next_pow2(max(graph.n, 1)), next_pow2(max(wb, 1)), canon)

    def _dispatch_colors(self, tickets: list[Ticket]) -> None:
        buckets: dict = {}
        for t in tickets:
            key = self._bucket_key(t.payload, t.options)
            if key is None:
                self._run_slow_color(t)
            else:
                buckets.setdefault(key, []).append(t)
        for key, ts in buckets.items():
            self._run_bucket(key, ts)

    def _run_slow_color(self, t: Ticket) -> None:
        from repro_torch import api

        try:
            with span("serve_request", kind="color_slow"):
                result = api.color(t.payload, options=t.options,
                                   device=self._device)
            self._counters["completed"] += 1
            self._counters["slow_requests"] += 1
            t._finish(result=result)
        except BaseException as e:
            self._counters["failed"] += 1
            t._finish(error=e)

    def _run_bucket(self, key, tickets: list[Ticket]) -> None:
        from repro_torch.core.batch import _EMPTY, GraphBatch, color_batch_fused
        from repro_torch.core.csr import CSRGraph, next_pow2

        d2, n2, w2, o = key
        try:
            real = [t.payload for t in tickets]
            # repro's padding: one edge-free graph of n2 vertices fixes
            # n_max, _EMPTY graphs a pow2 batch count, width= the pow2 W;
            # per-graph colours do not depend on it, padded_work does
            shape_pad = CSRGraph(np.zeros(n2 + 1, np.int64),
                                 np.zeros(0, np.int32))
            Bp = next_pow2(len(real) + 1)
            batch = GraphBatch.from_graphs(
                real + [shape_pad] + [_EMPTY] * (Bp - len(real) - 1),
                width=w2, distance2=d2, device=self._device)
            kw = {k: v for k, v in o.engine_kwargs().items()
                  if k in ("heuristic", "firstfit", "max_iters",
                           "tail_serial", "backend")}
            jkey = (d2, Bp, n2, w2, o)
            with self._pool_lock:
                stats = self._bucket_stats.setdefault(
                    repr((d2, n2, w2, o.describe())),
                    {"requests": 0, "dispatches": 0, "jit_hits": 0,
                     "jit_misses": 0})
                hit = jkey in self._jit_keys
                self._jit_keys.add(jkey)
                self._counters["bucket_jit_hits" if hit else
                               "bucket_jit_misses"] += 1
                stats["jit_hits" if hit else "jit_misses"] += 1
                stats["requests"] += len(real)
                stats["dispatches"] += 1
            # vertices / slots: the share of the flat ids that are real
            with span("serve_microbatch", B=len(real), padded_B=Bp,
                      d2=d2, jit_hit=hit, vertices=sum(g.n for g in real),
                      slots=batch.B * (batch.n_max + 1)):
                results = color_batch_fused(batch, distance2=d2, **kw)
            self._counters["microbatches"] += 1
            self._counters["batched_requests"] += len(real)
            self._counters["completed"] += len(tickets)
            for t, r in zip(tickets, results):
                t._finish(result=r)
        except BaseException as e:
            self._counters["failed"] += len(tickets)
            for t in tickets:
                t._finish(error=e)

    # -- idle maintenance ----------------------------------------------------
    def _maintenance_target(self) -> str | None:
        for sid, sess in self._pool.items():
            due = sess.maintenance_due()
            if due["compact"] or due["snapshot"]:
                return sid
        return None

    def _run_maintenance(self) -> None:
        """One deferred-maintenance slice (one session), preemptible."""
        with self._pool_lock:
            sid = self._maintenance_target()
            sess = self._pool.get(sid) if sid is not None else None
        if sess is None:
            return
        with span("serve_maintenance", sid=sid):
            done = sess.maintain()
        if done:
            self._counters["maintenance"] += 1


def _no_device(o: ColorOptions) -> ColorOptions:
    """Refuse a ``device`` riding in ``o``: the service picks the device."""
    if "device" in o.extra_dict():
        raise ValueError(
            "device= is the service's (ColoringService(device=...)); a "
            "request cannot pick its own")
    return o
