"""Key-value store backends of the port: the part of the JAX package's
``kvdb/`` that the checkpoint manifest opens (:class:`KVDBBackend`,
:class:`FilesystemKVDB`).  The service, the other backends and
``new_kvdb_backend`` come with ROADMAP.md queue 1, item 10b (the
game service's storage half)."""

from .backends import FilesystemKVDB, KVDBBackend

__all__ = ["FilesystemKVDB", "KVDBBackend"]
