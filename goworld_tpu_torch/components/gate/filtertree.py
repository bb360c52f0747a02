"""Filter-prop index: per-key ordered multimap value -> client proxies.

Reference: components/gate/FilterTree.go (LLRB tree with =, !=, <, <=, >, >=
range visits for CallFilteredClients).  Here a bisect-maintained sorted list
of (value, seq) keys -- same asymptotics for visits, O(n) insert which is
fine at gate scale; values compare as strings like the reference.

The port's copy of the JAX package's ``components/gate/filtertree.py``.
"""

from __future__ import annotations

import bisect
from itertools import count

from ...proto import msgtypes as MT


class FilterTree:
    def __init__(self):
        self._keys: list[tuple[str, int]] = []  # sorted (value, seq)
        self._vals: list[object] = []  # client proxy per key
        self._by_client: dict[int, tuple[str, int]] = {}  # id(proxy) -> key
        self._seq = count()

    def insert(self, proxy, value: str):
        self.remove(proxy)
        key = (value, next(self._seq))
        i = bisect.bisect_left(self._keys, key)
        self._keys.insert(i, key)
        self._vals.insert(i, proxy)
        self._by_client[id(proxy)] = key

    def remove(self, proxy) -> bool:
        key = self._by_client.pop(id(proxy), None)
        if key is None:
            return False
        i = bisect.bisect_left(self._keys, key)
        del self._keys[i]
        del self._vals[i]
        return True

    def visit(self, op: int, value: str):
        """Yield client proxies matching ``<op> value``."""
        lo = bisect.bisect_left(self._keys, (value, -1))
        hi = bisect.bisect_right(self._keys, (value, 1 << 62))
        if op == MT.FILTER_OP_EQ:
            rng = range(lo, hi)
        elif op == MT.FILTER_OP_NE:
            yield from (self._vals[i] for i in range(0, lo))
            yield from (self._vals[i] for i in range(hi, len(self._vals)))
            return
        elif op == MT.FILTER_OP_LT:
            rng = range(0, lo)
        elif op == MT.FILTER_OP_LTE:
            rng = range(0, hi)
        elif op == MT.FILTER_OP_GT:
            rng = range(hi, len(self._vals))
        elif op == MT.FILTER_OP_GTE:
            rng = range(lo, len(self._vals))
        else:
            raise ValueError(f"unknown filter op {op}")
        yield from (self._vals[i] for i in rng)

    def __len__(self):
        return len(self._keys)
