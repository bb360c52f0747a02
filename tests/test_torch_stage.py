"""The port's delta staging (goworld_tpu_torch.ops.aoi_stage) against the
JAX package's: ``pad_packet`` must pad identically, and the in-place
``apply_packet`` must leave the persistent tensors exactly where JAX's
donated scatter leaves its arrays (bit patterns compared, so -0.0 and NaN
payloads count)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from goworld_tpu.ops import aoi_stage as JS
from goworld_tpu_torch.ops import aoi_stage as TS


@pytest.mark.parametrize("k", [1, 63, 64, 65, 300, 4097])
def test_pad_packet_matches_jax(k):
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 4, k)
    cols = rng.integers(0, 256, k)
    xv = rng.uniform(-5, 5, k)
    zv = rng.uniform(-5, 5, k)
    got = TS.pad_packet(rows, cols, xv, zv)
    want = JS.pad_packet(rows, cols, xv, zv)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TS.packet_nbytes(*got) == JS.packet_nbytes(*want)
    with pytest.raises(ValueError):
        TS.pad_packet(rows[:0], cols[:0], xv[:0], zv[:0])


def test_apply_packet_in_place_matches_jax():
    rng = np.random.default_rng(5)
    s, c = 4, 256
    x0 = rng.uniform(0, 100, (s, c)).astype(np.float32)
    z0 = rng.uniform(0, 100, (s, c)).astype(np.float32)
    k = 90
    rows = rng.integers(0, s, k)
    cols = rng.permutation(c)[:k]
    xv = rng.uniform(0, 100, k).astype(np.float32)
    zv = rng.uniform(0, 100, k).astype(np.float32)
    xv[:3] = [-0.0, np.nan, np.inf]
    pkt = TS.pad_packet(rows, cols, xv, zv)
    dx, dz = torch.from_numpy(x0.copy()), torch.from_numpy(z0.copy())
    px, pz = dx.data_ptr(), dz.data_ptr()
    TS.apply_packet(dx, dz, *pkt)
    assert (dx.data_ptr(), dz.data_ptr()) == (px, pz)  # in place
    jx, jz = JS.apply_packet(jnp.asarray(x0), jnp.asarray(z0),
                             *JS.pad_packet(rows, cols, xv, zv))
    np.testing.assert_array_equal(dx.numpy().view(np.uint32),
                                  np.asarray(jx).view(np.uint32))
    np.testing.assert_array_equal(dz.numpy().view(np.uint32),
                                  np.asarray(jz).view(np.uint32))
