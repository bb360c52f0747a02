"""Space sharding over several torch devices (the port of the JAX
package's ``parallel/``): a 1-D mesh of devices, per-shard tensors, and
the sharded AOI step with no cross-device collectives."""

from .mesh import SpaceMesh, make_sharded_aoi_step, multichip_devices

__all__ = ["SpaceMesh", "make_sharded_aoi_step", "multichip_devices"]
