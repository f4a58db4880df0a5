"""Name → class registries.

Analog of the reference's recursive-subclass task discovery
(ref: SeqRec/tasks/__init__.py:16-18, SeqRec/utils/func_util.py:47-55) made
explicit: components register themselves with a decorator instead of being
found by subclass scanning, which keeps import order irrelevant and lookup O(1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple, TypeVar

T = TypeVar("T")


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str | None = None) -> Callable[[T], T]:
        def deco(cls: T) -> T:
            key = name or getattr(cls, "name", None) or cls.__name__  # type: ignore[attr-defined]
            if key in self._entries:
                raise ValueError(f"Duplicate {self.kind} registration: {key!r}")
            self._entries[key] = cls
            return cls

        return deco

    def get(self, name: str) -> Any:
        if name not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"Unknown {self.kind} {name!r}. Known: {known}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._entries.items())

    def names(self) -> list[str]:
        return sorted(self._entries)


# Global registries.
TASKS = Registry("task")
MODELS = Registry("model")
DATASETS = Registry("dataset")
