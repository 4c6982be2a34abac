"""Host-side phase spans with first-dispatch attribution (port of
``repro.obs.spans``).

The engines wrap their host-visible phases (CSR build, partition planning,
the super-step loop, the serial tail, validation, the guarantee ladder) in
``span("name")`` context managers.  A span is a no-op unless a recorder is
active: the engines pay one truthiness check per phase and nothing else.

To collect, open a recorder around any engine call::

    from repro_torch.obs import recorder
    with recorder() as spans:
        result = color(g, algorithm="fused", device="cpu")
    # spans.events -> [SpanEvent(name="csr_build", ...), ...]

Engines called with ``trace=True`` open their own recorder and attach the
captured events to ``ColoringResult.trace.spans``; an outer recorder still
sees every span (each event goes to the whole active stack).

First dispatch against warm dispatch: ``jit_span(name, key)`` wraps an
engine dispatch whose ``key`` is the tuple of options and shapes that
``repro`` keys its jit cache on.  PyTorch runs eagerly and has no jit cache,
so here ``cat="compile"`` means the first dispatch of that key in the
process, and ``cat="execute"`` every later one.  On the card the first
dispatch also builds or loads the kernel library and warms PyTorch's
allocator, which is the one-off cost the label separates from steady-state
time.  The key registry is process-wide, as in ``repro``.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager

__all__ = [
    "SpanEvent",
    "SpanRecorder",
    "recorder",
    "span",
    "jit_span",
    "recording",
    "jit_key_seen",
]

# stack of active recorders; module-level so `span` can bail with a single
# truthiness test when nobody is listening
_ACTIVE: list = []

# process-wide registry of dispatch keys already seen once
_SEEN_JIT_KEYS: set = set()


@dataclasses.dataclass
class SpanEvent:
    """One closed phase span (monotonic clock, seconds)."""

    name: str
    start: float
    duration: float
    cat: str = "phase"      # "phase" | "compile" | "execute"
    meta: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "start": self.start,
                "duration": self.duration, "cat": self.cat,
                "meta": dict(self.meta)}


class SpanRecorder:
    """Accumulates every ``SpanEvent`` closed while it is on the stack."""

    def __init__(self):
        self.events: list = []

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    def total(self, name: str | None = None, cat: str | None = None) -> float:
        """Summed duration of matching spans (seconds)."""
        return sum(e.duration for e in self.events
                   if (name is None or e.name == name)
                   and (cat is None or e.cat == cat))

    def by_name(self) -> dict:
        out: dict = {}
        for e in self.events:
            agg = out.setdefault(e.name, {"count": 0, "seconds": 0.0,
                                          "compile_seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += e.duration
            if e.cat == "compile":
                agg["compile_seconds"] += e.duration
        return out


def recorder() -> SpanRecorder:
    """A fresh recorder; use as ``with recorder() as r: ...``."""
    return SpanRecorder()


def recording() -> bool:
    """True when at least one recorder is active (spans are being kept)."""
    return bool(_ACTIVE)


@contextmanager
def span(name: str, cat: str = "phase", **meta):
    """Time a phase; no-op (one list truthiness check) without a recorder."""
    if not _ACTIVE:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ev = SpanEvent(name, t0, time.perf_counter() - t0, cat, meta)
        for rec in _ACTIVE:
            rec.events.append(ev)


def jit_key_seen(key) -> bool:
    """Register ``key``; True when it was already dispatched in this process."""
    if key in _SEEN_JIT_KEYS:
        return True
    _SEEN_JIT_KEYS.add(key)
    return False


@contextmanager
def jit_span(name: str, key, **meta):
    """``span`` for an engine dispatch, tagged ``compile`` on the first
    dispatch of ``key`` in the process and ``execute`` afterwards."""
    if not _ACTIVE:
        # the registry advances even while nobody records, so the first
        # recorded dispatch of a warm key is not mislabeled compile
        jit_key_seen(key)
        yield
        return
    cat = "execute" if jit_key_seen(key) else "compile"
    with span(name, cat=cat, **meta):
        yield
