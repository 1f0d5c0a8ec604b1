"""Torch-style Table (the port of ``bigdl_tpu/utils/table.py``, reference
``utils/Table.scala:34``): an int-keyed (by convention 1-based)
heterogeneous container.

The port's layers take and give Python lists where the reference's take
Tables; this class is kept for the reference's API (``T(a, b)`` has keys
1..n). It is a plain dict: torch needs no pytree registration.
"""

from __future__ import annotations


class Table(dict):
    """Int-keyed (by convention, 1-based) heterogeneous container."""

    def insert(self, *args):
        """``insert(value)`` appends; ``insert(index, value)`` inserts at key."""
        if len(args) == 1:
            self[len(self) + 1] = args[0]
        elif len(args) == 2:
            idx, value = args
            if idx in self:
                # shift existing entries up, torch-style
                keys = sorted((k for k in self if isinstance(k, int) and k >= idx),
                              reverse=True)
                for k in keys:
                    self[k + 1] = self[k]
            self[idx] = value
        else:
            raise ValueError("insert takes (value) or (index, value)")
        return self

    def length(self):
        return len(self)

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in sorted_items(self))
        return "Table{" + inner + "}"


def sorted_items(t):
    # int keys numerically first (Torch 1..n convention), then others by str
    return sorted(t.items(),
                  key=lambda kv: (0, kv[0], "") if isinstance(kv[0], int)
                  else (1, 0, str(kv[0])))


def T(*elements, **named):
    """Table constructor matching the reference's ``T()`` (``utils/Table.scala:318``)."""
    t = Table()
    for i, e in enumerate(elements):
        t[i + 1] = e
    for k, v in named.items():
        t[k] = v
    return t
