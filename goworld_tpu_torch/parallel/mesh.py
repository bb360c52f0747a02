"""Space sharding across torch devices.

Port of the JAX package's ``parallel/mesh.py``.  The framework's unit of
parallelism is the Space: the AOI arrays of S spaces have a leading batch
(space) axis, and a :class:`SpaceMesh` splits it into one contiguous
block per shard, each block a tensor on its shard's device.  Every
space's [C] rows live wholly on one shard, so the per-tick AOI step needs
no cross-device collective: where the JAX step ends in a ``psum`` of the
event counts, each shard here yields one count scalar and the host adds
them after every shard's work is enqueued.

A device may appear more than once in a mesh.  Such *virtual shards* are
the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count``: eight shards on ``cpu`` for
the tests, four or eight shards of one card in ``chip_smoke.py``.  Virtual
shards of one card take turns on it; their times are one card's.  They
are only ever asked for explicitly: :func:`multichip_devices` returns
distinct CUDA devices or raises, and never falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import aoi_cuda as AK
from ..ops import events as EV
from ..ops.aoi_stage import h2d

_LANES = 128


def multichip_devices(n: int, device: str = "cuda") -> list[torch.device]:
    """``n`` distinct CUDA devices, ``cuda:0`` .. ``cuda:n-1``; raises when
    torch sees fewer.  (Shards of one device are made explicitly:
    ``SpaceMesh([dev] * n)``.)"""
    if device != "cuda":
        raise ValueError(f"distinct devices are CUDA devices, got "
                         f"{device!r}; for shards of one device build "
                         f"SpaceMesh([device] * n)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"need {n} CUDA devices; torch sees no CUDA "
                           f"device")
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"need {n} CUDA devices; torch sees {have}")
    return [torch.device("cuda", i) for i in range(n)]


class SpaceMesh:
    """A 1-D mesh over an explicit list of torch devices; arrays with a
    leading space axis split into one equal block per shard."""

    def __init__(self, devices):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"mesh devices must all be cuda or all cpu, "
                             f"got {[str(d) for d in devs]}")
        if "cuda" in kinds:
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh but torch sees no CUDA "
                                   "device")
            devs = [d if d.index is not None else
                    torch.device("cuda", torch.cuda.current_device())
                    for d in devs]
            for d in devs:
                if d.index >= torch.cuda.device_count():
                    raise RuntimeError(f"{d}: torch sees "
                                       f"{torch.cuda.device_count()} CUDA "
                                       f"devices")
        self.devices = devs
        self.n_devices = len(devs)
        self.platform = devs[0].type
        # distinct devices (cards) the shards live on
        self.n_distinct = len(set(devs))

    def block(self, n_rows: int) -> int:
        """Rows of a leading axis of ``n_rows`` per shard."""
        if n_rows % self.n_devices:
            raise ValueError(f"leading axis {n_rows} is not a multiple of "
                             f"the mesh size {self.n_devices}")
        return n_rows // self.n_devices

    def device_put(self, arr: np.ndarray) -> list[torch.Tensor]:
        """Split a numpy array's leading axis into one block per shard,
        each a fresh contiguous tensor on its shard's device (uint32 words
        carry as int32, the port's word dtype)."""
        arr = np.asarray(arr)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        b = self.block(arr.shape[0])
        return [h2d(arr[d * b:(d + 1) * b], dev)
                for d, dev in enumerate(self.devices)]

    def gather(self, parts) -> np.ndarray:
        """The whole array of per-shard tensors as one numpy array (int32
        words come back as int32: view them as uint32 to compare with the
        JAX package)."""
        return np.concatenate([p.cpu().numpy() for p in parts])


def _extract(words: torch.Tensor, max_chunks: int, chunk_k: int):
    """One shard's chunk extraction of its diff words (the JAX step's
    ``_extract``): ``(vals, idx, n_words, n_dirty, max_ccnt)`` with
    shard-local flat word indices, -1 in empty slots."""
    vals, _aux, lane, csel, ccnt, nd, mcc = EV.extract_chunks(
        words, max_chunks, chunk_k, lanes=_LANES)
    idx = torch.where(lane >= 0,
                      csel[:, None].to(torch.int64) * _LANES
                      + lane.clamp(min=0), -1)
    n_words = ccnt.clamp(max=chunk_k).sum(dtype=torch.int64)
    return vals, idx, n_words, nd, mcc


def make_sharded_aoi_step(space_mesh: SpaceMesh, *, max_words: int = 0,
                          chunk_k: int = 8):
    """The sharded AOI tick over ``space_mesh``:

        step(x, z, r, act, prev) -> (new, enter, leave, total_events)

    Each argument is a list of per-shard tensors (``SpaceMesh.device_put``
    of an [S, C] or [S, C, W] array, S a multiple of the mesh size).  Each
    shard runs ``ops/aoi_cuda.aoi_step_entlv`` on its own device (the
    kernel on a CUDA shard, the plain version on a CPU shard); ``new``,
    ``enter`` and ``leave`` are per-shard lists, ``total_events`` the
    popcount of enter and leave over all shards, an int.  Every shard's
    work is enqueued before the first wait (the host sum).

    With ``max_words > 0`` each shard also compacts its own enter and
    leave words (``ops/events.extract_chunks``), and the step returns
    ``(new, enter_streams, leave_streams, total_events)`` where each
    stream list holds per shard ``(vals [max_chunks, kk], idx [max_chunks,
    kk] int64, n_words, n_dirty, max_ccnt)``: ``kk = min(chunk_k, 128)``,
    ``max_chunks = max(1, max_words // 128)``, ``idx`` the shard-local
    flat word index (-1 = empty slot; global space = shard * S_local +
    local space), ``n_words`` the words extracted, and ``n_dirty`` /
    ``max_ccnt`` the exact dirty-chunk count and words-per-chunk peak:
    ``n_dirty > max_chunks`` or ``max_ccnt > chunk_k`` means that shard's
    stream is incomplete (the overflow contract of ``extract_chunks``)."""
    n = space_mesh.n_devices
    max_chunks = max(1, max_words // _LANES)

    def step(x, z, r, act, prev):
        for name, a in (("x", x), ("z", z), ("r", r), ("act", act),
                        ("prev", prev)):
            if len(a) != n:
                raise ValueError(f"{name}: want {n} shards, got {len(a)}")
        news, ents, lvs, counts = [], [], [], []
        for d, dev in enumerate(space_mesh.devices):
            if x[d].device != dev:
                raise ValueError(f"shard {d} lies on {x[d].device}, the mesh "
                                 f"puts it on {dev}")
            new, ent, lv = AK.aoi_step_entlv(x[d], z[d], r[d], act[d],
                                             prev[d])
            counts.append(EV.popcount_total(ent) + EV.popcount_total(lv))
            news.append(new)
            if max_words:
                ents.append(_extract(ent, max_chunks, chunk_k))
                lvs.append(_extract(lv, max_chunks, chunk_k))
            else:
                ents.append(ent)
                lvs.append(lv)
        total = sum(int(c) for c in counts)
        return news, ents, lvs, total

    return step
