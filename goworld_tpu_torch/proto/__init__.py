"""Wire protocol: message-type space and typed connection wrapper.

The port's copy of the JAX package's ``proto/__init__.py``."""

from .msgtypes import *  # noqa: F401,F403
from .connection import GWConnection  # noqa: F401
