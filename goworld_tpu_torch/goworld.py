"""The facade API: the whole dev-facing surface behind one import.

Reference role: goworld.go:34-231 -- re-exports Run, RegisterSpace/Entity/
Service, CreateSpace*/CreateEntity*/LoadEntity*, Call/CallService/
CallNilSpaces, KVDB helpers and timers so that user game code needs exactly
one package.  Here the functions bind to the current process's GameService
(set automatically by the game entry point before the user script's
``setup(game)`` runs, or by :func:`run`).

Usage (reference model: a user main package calling goworld.Run()):

    from goworld_tpu_torch import goworld

    class MySpace(goworld.Space): ...
    class Avatar(goworld.Entity): ...

    def setup(game):                 # called by the game process entry
        goworld.register_space(MySpace)
        goworld.register_entity(Avatar)
        goworld.register_service(MailService)

All functions must be called from the game logic thread (entity callbacks,
timers, posted functions) -- same threading contract as the reference
(cn/goworld_cn.go threading notes).
"""

from __future__ import annotations

from typing import Callable

from .engine.entity import Entity  # noqa: F401  (re-export)
from .engine.rpc import ALL_CLIENTS, OWN_CLIENT, rpc  # noqa: F401
from .engine.space import Space  # noqa: F401
from .engine.vector import Vector3  # noqa: F401
from .services import ServiceManager

_game = None


def bind(game) -> None:
    """Bind the facade to this process's GameService.  Called by the game
    entry point; tests may call it directly."""
    global _game
    _game = game


def current_game():
    if _game is None:
        raise RuntimeError(
            "goworld facade not bound -- run inside a game process "
            "(components.game) or call goworld.bind(game) first"
        )
    return _game


def run(argv=None) -> int:
    """Boot a game process from the command line (reference: goworld.Run(),
    goworld.go:34-36 -> components/game Run).  Lets a user script be its own
    executable: ``python server.py -gid 1 -configfile goworld.ini``.  The
    calling script is used as the game logic module (it must define
    ``setup(game)`` and guard the run() call with ``__main__``); pass
    ``-script other.py`` to boot a different module."""
    import sys

    from .components.game.__main__ import main

    return main(argv, default_script=sys.argv[0])


# -- registration ----------------------------------------------------------

def register_entity(cls: type, name: str | None = None):
    """Reference: goworld.RegisterEntity (goworld.go:139-147)."""
    return current_game().register_entity_type(cls, name)


def register_space(cls: type, name: str | None = None):
    """Reference: goworld.RegisterSpace (goworld.go:55-58)."""
    return current_game().register_entity_type(cls, name)


def register_service(cls: type, name: str | None = None):
    """Cluster-singleton service entity (reference: goworld.RegisterService,
    goworld.go:149-166; engine/service)."""
    game = current_game()
    services = getattr(game, "services", None)
    if services is None:
        services = ServiceManager(game)
        game.services = services
        services.setup()
    return services.register(cls, name)


# -- creation --------------------------------------------------------------

def create_space_locally(cls_name: str, kind: int = 1):
    """Reference: goworld.CreateSpaceLocally (goworld.go:71-77)."""
    return current_game().rt.entities.create_space(cls_name, kind=kind)


def create_space_anywhere(cls_name: str, kind: int = 1) -> str:
    """Reference: goworld.CreateSpaceAnywhere (goworld.go:60-69) -- LBC
    least-loaded placement; returns the new space's entity id."""
    return current_game().create_entity_anywhere(cls_name, {"_space_kind_": kind})


def create_entity_locally(type_name: str, **kwargs) -> Entity:
    """Reference: goworld.CreateEntityLocally (goworld.go:84-87)."""
    return current_game().rt.entities.create(type_name, **kwargs)


def create_entity_anywhere(type_name: str, attrs: dict | None = None) -> str:
    """Reference: goworld.CreateEntityAnywhere (goworld.go:79-82)."""
    return current_game().create_entity_anywhere(type_name, attrs)


def load_entity_anywhere(type_name: str, eid: str):
    """Reference: goworld.LoadEntityAnywhere (goworld.go:89-93): load from
    storage onto some game; calls made during the load are queued by the
    dispatcher, not lost."""
    current_game().load_entity_anywhere(type_name, eid)


# -- calls -----------------------------------------------------------------

def call(eid: str, method: str, *args):
    """Entity RPC by id, local-call fast path included (reference:
    goworld.Call, goworld.go:168-171; EntityManager.go:429-442)."""
    current_game().call_entity(eid, method, *args)


def call_service(type_name: str, method: str, *args) -> bool:
    """Reference: goworld.CallServiceAny/CallServiceShardKey
    (goworld.go:173-190)."""
    game = current_game()
    services = getattr(game, "services", None)
    if services is None:
        return False
    return services.call_service(type_name, method, *args)


def get_service_entity_id(type_name: str) -> str | None:
    """Reference: goworld.GetServiceProviders (goworld.go:192-196)."""
    services = getattr(current_game(), "services", None)
    return services.service_entity_id(type_name) if services else None


def call_nil_spaces(method: str, *args):
    """Run a method on every game's nil space (reference:
    goworld.CallNilSpaces, goworld.go:198-202)."""
    current_game().call_nil_spaces(method, *args)


def nil_space():
    """This game's nil space (reference: goworld.GetNilSpaceID/GetNilSpace,
    goworld.go:204-216)."""
    return current_game().nil_space


def get_entity(eid: str) -> Entity | None:
    """Reference: goworld.GetEntity (goworld.go:223-226)."""
    return current_game().rt.entities.get(eid)


def get_game_id() -> int:
    """Reference: goworld.GetGameID (goworld.go:228-231)."""
    return current_game().id


def post(fn: Callable[[], None]):
    """Enqueue onto the logic thread (reference: post.Post) -- the only safe
    cross-thread entry."""
    current_game().rt.post.post(fn)


# -- KVDB ------------------------------------------------------------------

def kvdb_get(key: str, callback):
    """Reference: goworld.GetKVDB (goworld.go:?; engine/kvdb.Get)."""
    current_game().kvdb.get(key, callback)


def kvdb_put(key: str, val: str, callback=None):
    current_game().kvdb.put(key, val, callback)


def kvdb_get_or_put(key: str, val: str, callback=None):
    current_game().kvdb.get_or_put(key, val, callback)


# -- crontab ---------------------------------------------------------------

def register_crontab(minute: int, hour: int, day: int, month: int,
                     dayofweek: int, cb: Callable[[], None]) -> int:
    """Register a minute-resolution cron callback on the game's crontab
    (reference: goworld.RegisterCrontab, goworld.go:224-231;
    engine/crontab/crontab.go:95-185).  Non-negative fields must match the
    wall-clock value; ``-N`` means "every N".  Returns a handle for
    :func:`unregister_crontab`.  Callbacks run panicless on the logic
    thread."""
    return current_game().rt.crontab.register(
        minute, hour, day, month, dayofweek, cb)


def unregister_crontab(handle: int) -> bool:
    """Remove a crontab entry registered via :func:`register_crontab`."""
    return current_game().rt.crontab.unregister(handle)


# -- storage ---------------------------------------------------------------

def exists_entity(type_name: str, eid: str, callback):
    """Reference: goworld.Exists (goworld.go:218-221)."""
    current_game().storage.exists(type_name, eid, callback)


def list_entity_ids(type_name: str, callback):
    """Reference: goworld.ListEntityIDs (goworld.go:95-101)."""
    current_game().storage.list_entity_ids(type_name, callback)
