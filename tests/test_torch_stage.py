"""The port's delta staging (goworld_tpu_torch.ops.aoi_stage) against the
JAX package's: ``pad_packet`` must pad identically, and the in-place
``apply_packet`` must leave the persistent tensors exactly where JAX's
donated scatter leaves its arrays (bit patterns compared, so -0.0 and NaN
payloads count).  Then the delta scatter's hand kernel (csrc/stage.cu,
bound in goworld_tpu_torch.ops.stage_cuda) as far as the CPU reaches it:
its plain version against JAX's ``delta_scatter`` on edge packets
(indices past either end, negative indices, NaN payloads, -0.0,
subnormals, the padding's repeats, a one-row view), the one int32 [4, n]
packet, the wrapper's checks (it raises before anything builds or
launches), the CPU entry and the kernel's constants."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from goworld_tpu.ops import aoi_stage as JS
from goworld_tpu_torch.ops import aoi_stage as TS
from goworld_tpu_torch.ops import stage_cuda as SC
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# -- the scatter's kernel (csrc/stage.cu) as far as the CPU reaches it -------


@pytest.fixture
def no_kernel(monkeypatch):
    """Nothing may build or launch: the binding raises if reached, and the
    launch count stays 0."""
    def refuse():
        raise AssertionError("reached the CUDA library")

    monkeypatch.setattr(SC, "_fn", refuse)
    SC.reset_launches()
    yield
    assert SC.launches == {"scatter_packet": 0}


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _edge_packet(s, c, seed):
    """A packet over [s, c] with every kind of entry the scatter must
    treat: in range, negative indices that count from the end, rows and
    cols past either end (dropped), NaN payloads, -0.0, +-inf,
    subnormals, and the padding's repeats of the last entry (identical
    bits).  Distinct landing cells carry the only write to them."""
    rng = np.random.default_rng(seed)
    k = 3 * s * c // 4
    cells = rng.permutation(s * c)[:k]
    rows, cols = (cells // c).astype(np.int32), (cells % c).astype(np.int32)
    # some landing cells addressed from the end (the reference normalises)
    neg = rng.random(k) < 0.2
    rows[neg] -= s
    cols[neg & (rng.random(k) < 0.5)] -= c
    xv = rng.uniform(-50, 50, k).astype(np.float32)
    zv = rng.uniform(-50, 50, k).astype(np.float32)
    specials = np.array([0x7FC00001, 0xFFC12345, 0x80000000, 0x00000001,
                         0x807FFFFF, 0x7F800000, 0xFF800000, 0x00400000],
                        np.uint32).view(np.float32)
    xv[:8], zv[8:16] = specials, specials
    # out-of-range entries, each with its own value
    bad_r = np.array([s, s + 7, -s - 1, -2**31, 2**31 - 1, 0, 1, 0],
                     np.int32)
    bad_c = np.array([0, 1, 0, 0, 1, c, -c - 1, 2**31 - 1], np.int32)
    rows = np.concatenate([rows, bad_r])
    cols = np.concatenate([cols, bad_c])
    xv = np.concatenate([xv, np.float32(rng.uniform(1, 2, 8))])
    zv = np.concatenate([zv, np.float32(rng.uniform(1, 2, 8))])
    order = rng.permutation(len(rows))
    return rows[order], cols[order], xv[order], zv[order]


def _jax_scatter(x0, z0, rows, cols, xv, zv):
    jx, jz = JS.delta_scatter(jnp.asarray(x0), jnp.asarray(z0),
                              jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(xv), jnp.asarray(zv))
    return np.asarray(jx), np.asarray(jz)


@pytest.mark.parametrize("s,c,seed", [(4, 256, 1), (3, 96, 2), (1, 1024, 3),
                                      (8, 64, 4)])
def test_plain_scatter_matches_jax_delta_scatter(s, c, seed, no_kernel):
    rng = np.random.default_rng(seed + 100)
    x0 = rng.uniform(0, 100, (s, c)).astype(np.float32)
    z0 = rng.uniform(0, 100, (s, c)).astype(np.float32)
    rows, cols, xv, zv = TS.pad_packet(*_edge_packet(s, c, seed))
    assert len(rows) > 3 * s * c // 4 + 8  # the padding repeats entries
    want_x, want_z = _jax_scatter(x0, z0, rows, cols, xv, zv)
    dx, dz = torch.from_numpy(x0.copy()), torch.from_numpy(z0.copy())
    pkt = torch.from_numpy(TS.packet_arrays(rows, cols, xv, zv))
    TS.scatter_packet_plain(dx, dz, pkt)
    np.testing.assert_array_equal(_bits(dx.numpy()), _bits(want_x))
    np.testing.assert_array_equal(_bits(dz.numpy()), _bits(want_z))
    # the entry on CPU tensors is the plain version, and counts nothing
    dx2, dz2 = torch.from_numpy(x0.copy()), torch.from_numpy(z0.copy())
    TS.scatter_packet(dx2, dz2, pkt)
    assert torch.equal(dx2.view(torch.int32), dx.view(torch.int32))
    assert torch.equal(dz2.view(torch.int32), dz.view(torch.int32))
    # something landed, something was dropped, specials kept their bits
    assert not np.array_equal(_bits(want_x), _bits(x0))
    assert {0x7FC00001, 0x80000000, 0x00000001} <= set(
        _bits(dx.numpy()).ravel().tolist())


def test_scatter_into_a_one_row_view(no_kernel):
    """The row-sharded bucket's form: a [C] tensor seen as [1, C]; rows
    other than 0 and -1 drop, as JAX's delta_scatter drops them on a
    (1, C) array, and the result is delta_scatter_1d's."""
    c = 512
    rng = np.random.default_rng(9)
    x0 = rng.uniform(0, 10, c).astype(np.float32)
    z0 = rng.uniform(0, 10, c).astype(np.float32)
    cols = rng.permutation(c)[:200].astype(np.int32)
    rows = np.zeros(200, np.int32)
    rows[:5] = [1, 2, -2, 5, -1]  # -1 lands on row 0, the rest drop
    xv = rng.uniform(0, 10, 200).astype(np.float32)
    xv[10:13] = [np.float32(-0.0), np.nan, np.float32(1e-45)]
    zv = rng.uniform(0, 10, 200).astype(np.float32)
    rows, cols, xv, zv = TS.pad_packet(rows, cols, xv, zv)
    xs, zs = torch.from_numpy(x0.copy()), torch.from_numpy(z0.copy())
    pkt = torch.from_numpy(TS.packet_arrays(rows, cols, xv, zv))
    TS.scatter_packet(xs.view(1, -1), zs.view(1, -1), pkt)
    want_x, want_z = _jax_scatter(x0[None], z0[None], rows, cols, xv, zv)
    np.testing.assert_array_equal(_bits(xs.numpy()), _bits(want_x[0]))
    np.testing.assert_array_equal(_bits(zs.numpy()), _bits(want_z[0]))
    ok = (rows == 0) | (rows == -1)
    jx, jz = JS.delta_scatter_1d(jnp.asarray(x0), jnp.asarray(z0),
                                 jnp.asarray(cols[ok]), jnp.asarray(xv[ok]),
                                 jnp.asarray(zv[ok]))
    np.testing.assert_array_equal(_bits(xs.numpy()), _bits(jx))
    np.testing.assert_array_equal(_bits(zs.numpy()), _bits(jz))


@pytest.mark.parametrize("k", [1, 64, 300, 65536])
def test_packet_is_one_int32_array_that_round_trips(k):
    rng = np.random.default_rng(k)
    rows = rng.integers(-3, 9, k)
    cols = rng.integers(-5, 16384, k)
    xv = rng.uniform(-5, 5, k).astype(np.float32)
    zv = rng.uniform(-5, 5, k).astype(np.float32)
    xv[0] = np.float32(-0.0)
    zv[-1] = np.array(0x7FA00001, np.uint32).view(np.float32)
    pkt = TS.pad_packet(rows, cols, xv, zv)
    arr = TS.packet_arrays(*pkt)
    n = len(pkt[0])
    assert arr.dtype == np.int32 and arr.shape == (4, n)
    assert arr.flags.c_contiguous
    np.testing.assert_array_equal(arr[0], pkt[0])
    np.testing.assert_array_equal(arr[1], pkt[1])
    np.testing.assert_array_equal(arr[2].view(np.uint32), _bits(pkt[2]))
    np.testing.assert_array_equal(arr[3].view(np.uint32), _bits(pkt[3]))
    # the wire is the packet's own bytes: h2d_bytes counts it unchanged
    assert arr.nbytes == TS.packet_nbytes(*pkt) == 16 * n
    t = TS.h2d(arr, torch.device("cpu"))
    assert t.dtype == torch.int32 and torch.equal(t, torch.from_numpy(arr))
    assert t.data_ptr() != arr.ctypes.data  # a copy, never an alias


def _planes(s=2, c=64, dtype=torch.float32):
    return torch.zeros((s, c), dtype=dtype), torch.zeros((s, c), dtype=dtype)


def _pkt(n=64):
    return torch.zeros((4, n), dtype=torch.int32)


BAD = {
    "int32 planes": lambda: (*_planes(dtype=torch.int32), _pkt()),
    "float64 planes": lambda: (*_planes(dtype=torch.float64), _pkt()),
    "1-D planes": lambda: (torch.zeros(64), torch.zeros(64), _pkt()),
    "planes differ": lambda: (torch.zeros(2, 64), torch.zeros(2, 32),
                              _pkt()),
    "strided planes": lambda: (torch.zeros(64, 2).t(),
                               torch.zeros(64, 2).t(), _pkt()),
    "int64 packet": lambda: (*_planes(), torch.zeros((4, 64),
                                                     dtype=torch.int64)),
    "float packet": lambda: (*_planes(), torch.zeros((4, 64))),
    "packet [2, n]": lambda: (*_planes(), _pkt().view(2, 128)),
    "packet 1-D": lambda: (*_planes(), _pkt().view(-1)),
    "strided packet": lambda: (*_planes(), torch.zeros(
        (64, 4), dtype=torch.int32).t()),
    "devices differ": lambda: (*_planes(), torch.zeros(
        (4, 64), dtype=torch.int32, device="meta")),
    "cpu": lambda: (*_planes(), _pkt()),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_raises_before_launch(case, no_kernel):
    dx, dz, pkt = BAD[case]()
    with pytest.raises(ValueError):
        SC.scatter_packet_cuda(dx, dz, pkt)
    if case != "cpu":  # the plain version checks the same
        with pytest.raises(ValueError):
            TS.scatter_packet_plain(dx, dz, pkt)


def test_launch_plan_and_kernel_constants():
    assert [SC.scatter_plan(n) for n in (0, 1, 64, 256, 257, 8192, 2**16,
                                         2**18, 2**30)] == [
        1, 1, 1, 1, 2, 32, 256, 1024, 1024]
    src = open(os.path.join(ROOT, "goworld_tpu_torch", "csrc",
                            "stage.cu")).read()
    for name, v in (("THREADS", SC.THREADS), ("MAX_BLOCKS", SC.MAX_BLOCKS)):
        assert f"constexpr int {name} = {v};" in src, name
