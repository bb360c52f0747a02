"""Host-side engine of the port: entity/space runtime, AOI seam, attrs,
timers, RPC.  All entity logic runs on one thread; the AOI visibility pass
runs on the device through :mod:`goworld_tpu_torch.engine.aoi`."""
