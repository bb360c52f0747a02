"""Hierarchical entity attributes with automatic client-delta plumbing.

Entities hold a tree of MapAttr / ListAttr nodes.  Every mutation records a
delta (path, op, value) on the owning entity so the runtime can replicate
changes to the entity's own client and/or AOI neighbors without diffing.

Attr *classes* (mirroring the reference's attr-flag semantics,
reference engine/entity/EntityManager.go:61-97 and the delta push at
Entity.go:814-917):

  * ``persistent`` -- included in the saved snapshot;
  * ``client``     -- replicated to the entity's own client;
  * ``all_clients``-- replicated to the own client and to every client whose
                      entity is interested in this one (AOI neighbors).

Classes are declared per *top-level key* on the entity type (idiomatic
declaration via ``EntityType.attrs`` -- see manager.py), not inferred from
reflection.  A nested node inherits the class of its top-level key.

Design difference from the reference: the reference pushes one wire packet per
mutation immediately; here deltas accumulate per tick and flush in the sync
phase -- batched like everything else in this framework, with the same
observable per-tick result.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

# Delta ops
SET = "set"
DEL = "del"
APPEND = "append"
POP = "pop"


class _AttrNode:
    """Shared parent/path machinery for MapAttr and ListAttr."""

    __slots__ = ("_parent", "_pkey", "_owner")

    def __init__(self):
        self._parent: _AttrNode | None = None
        self._pkey: Any = None  # key (in parent map) or index (in parent list)
        self._owner: Any = None  # the owning entity once attached

    def _attach(self, parent: "_AttrNode | None", pkey: Any, owner: Any):
        if self._parent is not None or self._owner is not None:
            if parent is not None or owner is not self._owner:
                raise ValueError(
                    "attr node already attached; a node can live in one tree only"
                )
        self._parent = parent
        self._pkey = pkey
        self._owner = owner

    def _detach(self):
        self._parent = None
        self._pkey = None
        self._owner = None

    def path(self) -> tuple:
        """Root-to-node path of keys/indices (excluding the root itself)."""
        parts: list[Any] = []
        node: _AttrNode | None = self
        while node is not None and node._parent is not None:
            parts.append(node._pkey)
            node = node._parent
        return tuple(reversed(parts))

    def _record(self, op: str, key: Any, value: Any):
        owner = self._root_owner()
        if owner is not None:
            owner._on_attr_delta(self.path() + (key,), op, value)

    def _root_owner(self):
        node: _AttrNode = self
        while node._parent is not None:
            node = node._parent
        return node._owner

    @staticmethod
    def _wrap(value: Any) -> Any:
        """Uniformize plain containers into attr nodes (reference:
        attr.go:39-75 type uniformization).

        Hot/cold boundary (engine/ecs.py): live column VIEWS (an object
        exposing ``__attr_plain__``, e.g. Entity.position's PositionView)
        are snapshotted BY VALUE here.  The attr tree is the COLD path --
        it serializes, diffs and replicates; aliasing mutable column
        state into it would make saved/replicated attrs drift with every
        batched move."""
        plain = getattr(value, "__attr_plain__", None)
        if plain is not None:
            value = plain()
        if isinstance(value, dict):
            m = MapAttr()
            for k, v in value.items():
                m._data[str(k)] = _AttrNode._adopt_child(m, str(k), v)
            return m
        if isinstance(value, (list, tuple)):
            l = ListAttr()
            for i, v in enumerate(value):
                l._data.append(_AttrNode._adopt_child(l, i, v))
            return l
        return value

    @staticmethod
    def _adopt_child(parent: "_AttrNode", key: Any, value: Any) -> Any:
        value = _AttrNode._wrap(value)
        if isinstance(value, _AttrNode):
            value._attach(parent, key, None)
        return value

    @staticmethod
    def _plain(value: Any) -> Any:
        if isinstance(value, MapAttr):
            return {k: _AttrNode._plain(v) for k, v in value._data.items()}
        if isinstance(value, ListAttr):
            return [_AttrNode._plain(v) for v in value._data]
        plain = getattr(value, "__attr_plain__", None)
        if plain is not None:
            return plain()
        return value


class MapAttr(_AttrNode):
    """String-keyed attribute map (reference: MapAttr.go)."""

    __slots__ = ("_data",)

    def __init__(self, initial: dict | None = None):
        super().__init__()
        self._data: dict[str, Any] = {}
        if initial:
            for k, v in initial.items():
                self._data[str(k)] = _AttrNode._adopt_child(self, str(k), v)

    # -- reads ------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __len__(self) -> int:
        return len(self._data)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._data.get(key, default)
        return int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._data.get(key, default)
        return float(v)

    def get_str(self, key: str, default: str = "") -> str:
        v = self._data.get(key, default)
        return str(v)

    def get_map(self, key: str) -> "MapAttr":
        """Get-or-create a nested MapAttr."""
        v = self._data.get(key)
        if v is None:
            v = MapAttr()
            self.set(key, v)
        elif not isinstance(v, MapAttr):
            raise TypeError(f"attr {key!r} is {type(v).__name__}, not MapAttr")
        return v

    def get_list(self, key: str) -> "ListAttr":
        v = self._data.get(key)
        if v is None:
            v = ListAttr()
            self.set(key, v)
        elif not isinstance(v, ListAttr):
            raise TypeError(f"attr {key!r} is {type(v).__name__}, not ListAttr")
        return v

    # -- writes -----------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        key = str(key)
        old = self._data.get(key)
        if isinstance(old, _AttrNode):
            old._detach()
        value = _AttrNode._adopt_child(self, key, value)
        self._data[key] = value
        self._record(SET, key, _AttrNode._plain(value))

    def set_default(self, key: str, value: Any) -> Any:
        if key not in self._data:
            self.set(key, value)
        return self._data[key]

    def delete(self, key: str) -> None:
        old = self._data.pop(key, None)
        if isinstance(old, _AttrNode):
            old._detach()
        self._record(DEL, key, None)

    def pop(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        v = self._data[key]
        plain = _AttrNode._plain(v)
        self.delete(key)
        return plain

    def to_dict(self) -> dict:
        return _AttrNode._plain(self)

    def assign(self, d: dict) -> None:
        for k, v in d.items():
            self.set(k, v)

    def __repr__(self):
        return f"MapAttr({self.to_dict()!r})"


class ListAttr(_AttrNode):
    """Index-addressed attribute list (reference: ListAttr.go)."""

    __slots__ = ("_data",)

    def __init__(self, initial: list | None = None):
        super().__init__()
        self._data: list[Any] = []
        if initial:
            for i, v in enumerate(initial):
                self._data.append(_AttrNode._adopt_child(self, i, v))

    def __getitem__(self, i: int) -> Any:
        return self._data[i]

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._data)

    def append(self, value: Any) -> None:
        value = _AttrNode._adopt_child(self, len(self._data), value)
        self._data.append(value)
        self._record(APPEND, len(self._data) - 1, _AttrNode._plain(value))

    def set(self, i: int, value: Any) -> None:
        old = self._data[i]
        if isinstance(old, _AttrNode):
            old._detach()
        value = _AttrNode._adopt_child(self, i, value)
        self._data[i] = value
        self._record(SET, i, _AttrNode._plain(value))

    def pop(self, i: int = -1) -> Any:
        if i < 0:
            i += len(self._data)
        v = self._data.pop(i)
        if isinstance(v, _AttrNode):
            plain = _AttrNode._plain(v)
            v._detach()
        else:
            plain = v
        self._reindex()
        self._record(POP, i, None)
        return plain

    def _reindex(self):
        for i, v in enumerate(self._data):
            if isinstance(v, _AttrNode):
                v._pkey = i

    def to_list(self) -> list:
        return _AttrNode._plain(self)

    def __repr__(self):
        return f"ListAttr({self.to_list()!r})"


def apply_delta(root: MapAttr, path: tuple, op: str, value: Any) -> None:
    """Apply a recorded delta to another attr tree (client-side mirror).

    The bot client and gate use this to maintain entity mirrors from the
    delta stream (reference client behavior: ClientEntity attr sync).
    """
    node: Any = root
    for part in path[:-1]:
        node = node[part]
    key = path[-1]
    if op == SET:
        node.set(key, value)
    elif op == DEL:
        node.delete(key)
    elif op == APPEND:
        node.append(value)
    elif op == POP:
        node.pop(key)
    else:
        raise ValueError(f"unknown delta op {op!r}")
