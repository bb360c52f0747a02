"""Entity storage backends of the port: the part of the JAX package's
``storage/`` that the checkpoint journal opens
(:class:`EntityStorageBackend`, :class:`FilesystemEntityStorage`).  The
service, the SQL, Redis and Mongo backends and ``new_entity_storage``
come with ROADMAP.md queue 1, item 10b."""

from .backends import EntityStorageBackend, FilesystemEntityStorage

__all__ = ["EntityStorageBackend", "FilesystemEntityStorage"]
