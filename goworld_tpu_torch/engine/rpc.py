"""Entity RPC exposure -- declarative, no reflection-by-naming.

The reference encodes who may call a method in its *name suffix* (``Foo``
server-only, ``Foo_Client`` own client, ``Foo_AllClients`` any client --
reference engine/entity/rpc_desc.go:8-46, enforced at
Entity.go:499-512).  Name-suffix reflection is a Go-ism; here exposure is
declared with a decorator and collected at registration time into a per-type
descriptor table:

    class Avatar(Entity):
        @rpc(expose=OWN_CLIENT)
        def say(self, text: str): ...

Exposure levels:
  * SERVER      -- only other server entities may call (the default);
  * OWN_CLIENT  -- the entity's own client may call (reference ``_Client``);
  * ALL_CLIENTS -- any client may call (reference ``_AllClients``).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable

SERVER = "server"
OWN_CLIENT = "own_client"
ALL_CLIENTS = "all_clients"

_EXPOSURES = (SERVER, OWN_CLIENT, ALL_CLIENTS)
_MARK = "_gw_rpc_expose"


def rpc(fn: Callable | None = None, *, expose: str = SERVER):
    """Mark an entity method as remotely callable."""
    if expose not in _EXPOSURES:
        raise ValueError(f"unknown exposure {expose!r}")

    def deco(f):
        setattr(f, _MARK, expose)
        return f

    return deco(fn) if fn is not None else deco


@dataclass(frozen=True)
class RpcDesc:
    name: str
    expose: str
    func: Callable
    min_args: int  # required positional arity excluding self
    max_args: int | None  # None = *args (unbounded)

    def arity_ok(self, n: int) -> bool:
        if n < self.min_args:
            return False
        return self.max_args is None or n <= self.max_args


def collect_rpc_descs(cls: type) -> dict[str, RpcDesc]:
    """Walk a class (MRO-aware) and build its RPC descriptor table."""
    descs: dict[str, RpcDesc] = {}
    for name in dir(cls):
        if name.startswith("_"):
            continue
        fn = getattr(cls, name, None)
        expose = getattr(fn, _MARK, None)
        if expose is None or not callable(fn):
            continue
        min_args, max_args = 0, 0
        try:
            for p in list(inspect.signature(fn).parameters.values())[1:]:  # skip self
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                    if max_args is not None:
                        max_args += 1
                    if p.default is p.empty:
                        min_args += 1
                elif p.kind == p.VAR_POSITIONAL:
                    max_args = None
        except (TypeError, ValueError):
            min_args, max_args = 0, None
        descs[name] = RpcDesc(name, expose, fn, min_args, max_args)
    return descs


def may_call(desc: RpcDesc, *, from_client: bool, is_owner: bool) -> bool:
    """Access check mirroring the reference's flag test (Entity.go:499-512)."""
    if not from_client:
        return True
    if desc.expose == ALL_CLIENTS:
        return True
    if desc.expose == OWN_CLIENT:
        return is_owner
    return False
