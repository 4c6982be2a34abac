"""``ColorOptions`` — the frozen options object (port of ``repro.options``).

``repro_torch.color`` accepts options as loose keyword arguments or as one
frozen ``ColorOptions``; both spellings normalize into the same object
before any engine runs, so they cannot drift.  Engine-specific knobs
(``mode``, ``tiling``, ``buckets``, ``device``, …) ride in ``extra`` as a
sorted tuple of pairs.

A field left at its default is *unset*: ``engine_kwargs()`` omits it, so
the engine's own default applies.  ``tail_serial`` uses the ``UNSET``
sentinel because ``None`` is meaningful there (disable the tail).

``repro``'s deprecated ``use_kernel=`` knob is not carried over: the port's
wrappers pick the kernel by the tensor's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ColorOptions", "UNSET"]


class _Unset:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNSET"

    def __reduce__(self):  # pickling round-trips to the singleton
        return (_Unset, ())


UNSET = _Unset()


def _freeze(value):
    """Recursively tuple-ify lists/dicts so ColorOptions stays hashable."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    return value


@dataclasses.dataclass(frozen=True)
class ColorOptions:
    """Frozen, hashable options for one coloring request (see module doc)."""

    algorithm: str | None = None
    engine: str | None = None
    backend: str | None = None
    heuristic: str | None = None
    firstfit: str | None = None
    validate_input: str | None = None
    ensure_valid: bool = False
    trace: Any = False
    tail_serial: Any = UNSET
    max_iters: int | None = None
    extra: tuple = ()

    def __post_init__(self):
        extra = self.extra if isinstance(self.extra, dict) else dict(self.extra or ())
        object.__setattr__(self, "extra", _freeze(extra))
        if self.tail_serial is not UNSET:
            object.__setattr__(self, "tail_serial", _freeze(self.tail_serial))
        object.__setattr__(self, "trace", _freeze(self.trace))

    _FIELDS = ("algorithm", "engine", "backend", "heuristic", "firstfit",
               "validate_input", "ensure_valid", "trace", "tail_serial",
               "max_iters")

    @classmethod
    def normalize(cls, options: "ColorOptions | None" = None, /,
                  **kwargs) -> "ColorOptions":
        """Merge loose ``kwargs`` over ``options`` into one ColorOptions.

        Kwargs win over fields already set on ``options``; unknown kwargs
        land in ``extra``.
        """
        if options is None:
            options = cls()
        elif not isinstance(options, ColorOptions):
            raise TypeError(
                f"options must be a ColorOptions, got {type(options).__name__}")
        if not kwargs:
            return options
        if "options" in kwargs:
            raise TypeError(
                "options= must be passed positionally or as the dedicated "
                "keyword of the entry point, not inside the loose kwargs")
        fields = {}
        extra = dict(options.extra)
        for key, value in kwargs.items():
            if key in cls._FIELDS:
                if key == "algorithm" and value is None:
                    continue  # positional default: keep options' value
                fields[key] = value
            else:
                extra[key] = value
        merged = {f.name: getattr(options, f.name)
                  for f in dataclasses.fields(cls)}
        merged.update(fields)
        merged["extra"] = extra
        return cls(**merged)

    def merged(self, **kwargs) -> "ColorOptions":
        """A copy with ``kwargs`` merged over this object (kwargs win)."""
        return ColorOptions.normalize(self, **kwargs)

    def extra_dict(self) -> dict:
        return dict(self.extra)

    def engine_kwargs(self) -> dict:
        """The kwargs an algorithm adapter receives: set knobs only.

        ``algorithm``, ``validate_input`` and ``ensure_valid`` are consumed
        by the entry point and never appear here.
        """
        out: dict = {}
        for key in ("engine", "backend", "heuristic", "firstfit", "max_iters"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        if self.tail_serial is not UNSET:
            out["tail_serial"] = self.tail_serial
        if self.trace:
            out["trace"] = self.trace
        out.update(self.extra)
        return out

    def session_kwargs(self) -> dict:
        """The kwargs ``ColoringSession`` accepts (``open_session``).

        Set knobs only, as ``engine_kwargs``.  A session runs its own
        engine (ragged frontier recolors), so ``engine`` is refused, and
        ``ensure_valid=True`` becomes ``on_fail="ladder"`` unless an
        explicit ``on_fail`` rides in ``extra``.
        """
        if self.engine is not None:
            raise ValueError(
                f"engine={self.engine!r} does not apply to sessions; the "
                "streaming engine is fixed (ragged frontier recolors)")
        if self.algorithm not in (None, "dynamic"):
            raise ValueError(
                f"algorithm={self.algorithm!r} does not apply to sessions "
                "(sessions ARE the 'dynamic' algorithm)")
        out: dict = {}
        for key in ("backend", "heuristic", "firstfit", "max_iters",
                    "validate_input"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        if self.tail_serial is not UNSET:
            out["tail_serial"] = self.tail_serial
        if self.trace:
            out["trace"] = self.trace
        out.update(self.extra)
        if self.ensure_valid:
            out.setdefault("on_fail", "ladder")
        return out

    def describe(self) -> str:
        """Compact one-line rendering of the set knobs (for logs/metrics);
        ``repro``'s string character for character, so the service's bucket
        names match."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "extra":
                parts.extend(f"{k}={val!r}" for k, val in self.extra)
            elif f.name == "tail_serial":
                if v is not UNSET:
                    parts.append(f"tail_serial={v!r}")
            elif v not in (None, False):
                parts.append(f"{f.name}={v!r}")
        return "ColorOptions(" + ", ".join(parts) + ")"
