"""Cluster-singleton services.

Reference: engine/service/service.go -- each registered service entity type
is instantiated exactly once across the cluster.  Placement is negotiated
through the dispatcher-resident srvdis registry (first-writer-wins,
DispatcherService.go:737-751): every game periodically reconciles
(checkServices, service.go:66-213):

  * service unregistered -> try to claim it after a random delay (the delay
    de-races concurrent claims; the dispatcher's first-write-wins settles it);
  * registered to me but no local entity -> create it (load from storage
    first if persistent);
  * registered elsewhere but a local copy exists -> destroy the local copy.

``call_service`` routes to the singleton wherever it lives.
"""

from __future__ import annotations

import random

from .engine.ids import gen_id
from .utils import gwlog, gwutils
from .utils.asyncjobs import JobError

SRVID_PREFIX = "service/"
CHECK_INTERVAL = 1.0
CLAIM_DELAY_MAX = 0.5


class ServiceManager:
    def __init__(self, game):
        self.game = game
        self.log = gwlog.logger(f"service.game{game.id}")
        self.registered: dict[str, type] = {}  # service type name -> class
        self._claiming: set[str] = set()
        self._check_timer = None
        game.on_srvdis_update = self._on_srvdis_update

    # -- registration ------------------------------------------------------
    def register(self, cls, type_name: str | None = None):
        """Register a service entity type (reference: RegisterService)."""
        desc = self.game.register_entity_type(cls, type_name)
        self.registered[desc.type_name] = cls
        return desc

    def setup(self):
        """Start periodic reconciliation (called at game boot)."""
        rt = self.game.rt
        self._check_timer = rt.timers.add(
            CHECK_INTERVAL, self._check_services, repeat=True,
            interval=CHECK_INTERVAL,
        )

    # -- reconciliation ----------------------------------------------------
    def _check_services(self):
        if not self.game.deployment_ready:
            return
        for type_name in self.registered:
            srvid = SRVID_PREFIX + type_name
            info = self.game.srvmap.get(srvid)
            if info is None:
                if srvid not in self._claiming:
                    self._claiming.add(srvid)
                    delay = random.uniform(0, CLAIM_DELAY_MAX)
                    self.game.rt.timers.add(
                        delay, self._try_claim, args=(srvid, type_name)
                    )
                continue
            game_id, eid = self._parse(info)
            # every local instance of the type that is NOT the registered
            # one is a stray (e.g. a stale claim kept through a dispatcher
            # link drop) and must go -- matching only the registered eid
            # would leave strays with other ids alive forever.  The
            # per-type index makes this O(live instances), so it runs on
            # every reconcile tick.
            em = self.game.rt.entities
            for stray_id in list(em.by_type.get(type_name, ())):
                if game_id == self.game.id and stray_id == eid:
                    continue
                stray = em.get(stray_id)
                if stray is not None:
                    self.log.info("destroying duplicate service %s (%s)",
                                  type_name, stray_id)
                    stray.destroy()
            if game_id == self.game.id and em.get(eid) is None:
                self._instantiate(type_name, eid)

    def _try_claim(self, srvid: str, type_name: str):
        self._claiming.discard(srvid)
        if srvid in self.game.srvmap:
            return  # someone else won while we waited
        # if we already host a live instance (e.g. the registry was purged
        # while our dispatcher link was down), re-register IT -- claiming a
        # fresh id would duplicate the entity locally
        ids = self.game.rt.entities.by_type.get(type_name)
        eid = next(iter(ids)) if ids else gen_id()
        self.game.declare_service(srvid, f"{self.game.id}/{eid}")

    def _instantiate(self, type_name: str, eid: str):
        cls = self.registered[type_name]
        persistent = bool(getattr(cls, "persistent", False))
        storage = self.game.storage
        if persistent and storage is not None:
            def on_loaded(data, type_name=type_name, eid=eid):
                if isinstance(data, JobError):
                    self.log.error("service %s load failed: %r",
                                   type_name, data.exception)
                    return
                if self.game.rt.entities.get(eid) is None:
                    self.game.rt.entities.create(
                        type_name, eid=eid, attrs=data or {}
                    )
                    self.log.info("service %s loaded at %s", type_name, eid)
            storage.load(type_name, eid, on_loaded)
        else:
            self.game.rt.entities.create(type_name, eid=eid)
            self.log.info("service %s created at %s", type_name, eid)

    def _on_srvdis_update(self, srvid: str, info: str):
        # reconcile promptly on registry changes
        if srvid.startswith(SRVID_PREFIX):
            gwutils.run_panicless(self._check_services, logger=self.log)

    # -- calls -------------------------------------------------------------
    def call_service(self, type_name: str, method: str, *args) -> bool:
        """Route a call to the singleton (reference: CallService).  Returns
        False if the service is not (yet) registered."""
        info = self.game.srvmap.get(SRVID_PREFIX + type_name)
        if info is None:
            return False
        _game_id, eid = self._parse(info)
        self.game.call_entity(eid, method, *args)
        return True

    def service_entity_id(self, type_name: str) -> str | None:
        info = self.game.srvmap.get(SRVID_PREFIX + type_name)
        return self._parse(info)[1] if info else None

    @staticmethod
    def _parse(info: str) -> tuple[int, str]:
        game_id, eid = info.split("/", 1)
        return int(game_id), eid
