"""Generic LIFO stack.

The port's copy of ``dag_rider_tpu/core/stack.py``.

Counterpart of the reference's ``stack/stack.go`` (29 LoC): slice-backed,
generic, used by the commit rule to unwind the retroactive leader chain
oldest-first (reference ``process/process.go:84,341,412``).

Unlike the reference, ``pop`` on an empty stack raises a proper error
instead of panicking on a slice underflow (SURVEY.md D11,
``stack/stack.go:23-29``).
"""

from __future__ import annotations

from typing import Generic, Iterator, List, TypeVar

T = TypeVar("T")


class Stack(Generic[T]):
    """A simple LIFO stack over a Python list."""

    __slots__ = ("_items",)

    def __init__(self) -> None:
        self._items: List[T] = []

    def push(self, item: T) -> None:
        self._items.append(item)

    def pop(self) -> T:
        if not self._items:
            raise IndexError("pop from empty Stack")
        return self._items.pop()

    def peek(self) -> T:
        if not self._items:
            raise IndexError("peek of empty Stack")
        return self._items[-1]

    def is_empty(self) -> bool:
        return not self._items

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[T]:
        """Iterate in pop order (top first)."""
        return reversed(self._items)

    def __repr__(self) -> str:
        return f"Stack({self._items!r})"
