"""Input-file parser compatible with the reference's key-value format.

Copied from ludwig_tpu/runtime.py (pure Python).  Equivalent of the
reference runtime module (ref: src/runtime.c,
src/runtime.h:28-47).  Input files are flat ``key value`` lines with ``#``
comments; vector values use ``_`` separators (``size 64_64_64``).  Typed
getters mirror rt_int_parameter / rt_double_parameter_vector / rt_switch,
with required-key errors and an unused-key report (ref: ludwig.c:1022).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class RunTimeError(RuntimeError):
    pass


class RunTime:
    """Parsed input file with typed access and usage tracking."""

    def __init__(self, text: str = ""):
        self._kv: Dict[str, str] = {}
        self._used: set = set()
        self._lineno: Dict[str, int] = {}
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue  # reference silently skips malformed lines
            key, value = parts
            self._kv[key] = value.strip()
            self._lineno[key] = lineno

    @classmethod
    def from_file(cls, path: str) -> "RunTime":
        with open(path) as fh:
            return cls(fh.read())

    # -- basic access ------------------------------------------------------

    def has_key(self, key: str) -> bool:
        return key in self._kv

    def peek(self, key: str) -> Optional[str]:
        """The value, without marking the key used (the input check reads
        a key's value before the code that consumes it)."""
        return self._kv.get(key)

    def string(self, key: str, default: Optional[str] = None) -> Optional[str]:
        if key in self._kv:
            self._used.add(key)
            return self._kv[key]
        return default

    def int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.string(key)
        return int(v) if v is not None else default

    def double(self, key: str,
               default: Optional[float] = None) -> Optional[float]:
        v = self.string(key)
        return float(v) if v is not None else default

    def int_vector(self, key: str,
                   default: Optional[Sequence[int]] = None) -> Optional[List[int]]:
        v = self.string(key)
        if v is None:
            return list(default) if default is not None else None
        return [int(x) for x in v.split("_")]

    def double_vector(self, key: str,
                      default: Optional[Sequence[float]] = None
                      ) -> Optional[List[float]]:
        v = self.string(key)
        if v is None:
            return list(default) if default is not None else None
        return [float(x) for x in v.split("_")]

    def switch(self, key: str, default: bool = False) -> bool:
        """on/yes/1/true -> True (ref: rt_switch semantics)."""
        v = self.string(key)
        if v is None:
            return default
        return v.lower() in ("on", "yes", "1", "true")

    # -- required variants -------------------------------------------------

    def required(self, key: str) -> str:
        v = self.string(key)
        if v is None:
            raise RunTimeError(f"Please set key '{key}' in the input")
        return v

    def int_required(self, key: str) -> int:
        return int(self.required(key))

    def double_required(self, key: str) -> float:
        return float(self.required(key))

    # -- bookkeeping ---------------------------------------------------------

    @property
    def nkeys(self) -> int:
        """User-parameter count: harness hint keys (leading '_') are
        not part of the reference input surface (ref: runtime.c
        rt_read_input_file counts every key = value line)."""
        return sum(1 for k in self._kv if not k.startswith("_"))

    def mark_used(self, *keys: str) -> None:
        """Mark keys consumed without reading them (parity helper: the
        reference consumes some keys on paths we fold away, e.g. `grid`
        in the serial build, ref: coords_rt.c:46)."""
        self._used.update(keys)

    def lineno(self, key: str) -> int:
        return self._lineno.get(key, 0)

    def unused_keys(self) -> List[str]:
        """Input-order unused keys, hint keys excluded (ref:
        rt_report_unused_keys, runtime.c:167-189 prints in input line
        order with the 1-based line number)."""
        return sorted((k for k in self._kv
                       if k not in self._used and not k.startswith("_")),
                      key=lambda k: self._lineno.get(k, 0))
