"""Async entity persistence.

Reference: engine/storage (storage.go -- one background worker drains an op
queue; save failures retry forever; completion callbacks re-enter the logic
thread via post).  Backend interface mirrors
storage_common.EntityStorage{List,Write,Read,Exists,Close}.  The port's
copy of the JAX package's ``storage/``.
"""

from .backends import (EntityStorageBackend, FilesystemEntityStorage,
                       new_entity_storage)
from .service import EntityStorageService

__all__ = ["EntityStorageBackend", "EntityStorageService",
           "FilesystemEntityStorage", "new_entity_storage"]
