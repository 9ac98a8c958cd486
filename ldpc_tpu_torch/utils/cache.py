"""Bounded LRU mapping (copy of ``ldpc_tpu.utils.cache``).

A code search mutates the code at every step, so a cache keyed on the code
(decode plans, the kernel's edge tables on the card) grows with every
candidate.  ``BoundedCache`` is a drop-in dict replacement that evicts the
least-recently-used entry past ``maxsize``; eviction merely drops the Python
reference, so a re-request rebuilds the entry (correct, just slower) and
live callers holding a returned value are unaffected.
"""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["BoundedCache"]


class BoundedCache(OrderedDict):
    """dict with LRU eviction past ``maxsize`` entries."""

    def __init__(self, maxsize: int = 64):
        super().__init__()
        self.maxsize = int(maxsize)

    def __getitem__(self, key):
        val = super().__getitem__(key)
        self.move_to_end(key)
        return val

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)
