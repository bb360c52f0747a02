"""Entity storage backends: the port's copy of the JAX package's
``EntityStorageBackend`` and ``FilesystemEntityStorage``
(``storage/backends.py``).

Backend interface: ``write(type, eid, data)``, ``read(type, eid) -> dict
| None``, ``exists(type, eid) -> bool``, ``list_entity_ids(type) ->
list[str]``, ``close()``.  ``FilesystemEntityStorage`` keeps one msgpack
file an entity under ``<dir>/<type>/<eid>``, replaced atomically (a
temporary file, then ``os.replace``).
"""

from __future__ import annotations

import os

import msgpack


class EntityStorageBackend:
    def write(self, type_name: str, eid: str, data: dict) -> None:
        raise NotImplementedError

    def read(self, type_name: str, eid: str) -> dict | None:
        raise NotImplementedError

    def exists(self, type_name: str, eid: str) -> bool:
        raise NotImplementedError

    def list_entity_ids(self, type_name: str) -> list[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FilesystemEntityStorage(EntityStorageBackend):
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, type_name: str, eid: str) -> str:
        return os.path.join(self.dir, type_name, eid)

    def write(self, type_name: str, eid: str, data: dict) -> None:
        d = os.path.join(self.dir, type_name)
        os.makedirs(d, exist_ok=True)
        tmp = self._path(type_name, eid) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(data, use_bin_type=True))
        os.replace(tmp, self._path(type_name, eid))  # atomic

    def read(self, type_name: str, eid: str) -> dict | None:
        try:
            with open(self._path(type_name, eid), "rb") as f:
                return msgpack.unpackb(f.read(), raw=False)
        except FileNotFoundError:
            return None

    def exists(self, type_name: str, eid: str) -> bool:
        return os.path.exists(self._path(type_name, eid))

    def list_entity_ids(self, type_name: str) -> list[str]:
        d = os.path.join(self.dir, type_name)
        try:
            return sorted(n for n in os.listdir(d) if not n.endswith(".tmp"))
        except FileNotFoundError:
            return []
