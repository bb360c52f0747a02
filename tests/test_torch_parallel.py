"""The port's space-sharded step (goworld_tpu_torch.parallel) and entry
points against the JAX package's, on 8 shards: the port's virtual CPU
shards, JAX's 8 virtual CPU devices (tests/conftest.py).  Tolerance:
exact equality -- words are integers, the predicate IEEE f32 compares."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from goworld_tpu.ops.aoi_dense import aoi_step_dense_batched
from goworld_tpu.parallel import SpaceMesh as JaxMesh
from goworld_tpu.parallel import make_sharded_aoi_step as jax_sharded_step
from goworld_tpu.parallel import multichip_devices as jax_devices
from goworld_tpu_torch import entry as PE
from goworld_tpu_torch.ops import aoi_cuda as AK
from goworld_tpu_torch.ops import aoi_predicate as TP
from goworld_tpu_torch.parallel import (SpaceMesh, make_sharded_aoi_step,
                                        multichip_devices)
from torch_threads import one_intra_op_thread  # noqa: F401

N_DEV = 8


def batch(seed, s=16, cap=128):
    """tests/test_parallel.py's inputs, with random prev words (bit 31
    included) so enter and leave both fire."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 300, (s, cap)).astype(np.float32)
    z = rng.uniform(0, 300, (s, cap)).astype(np.float32)
    r = np.full((s, cap), 30, np.float32)
    act = rng.random((s, cap)) < 0.8
    prev = rng.integers(0, 2**32, (s, cap, cap // 32),
                        dtype=np.uint64).astype(np.uint32)
    prev[rng.random(s) < 0.5] = 0
    return x, z, r, act, prev


def port_mesh():
    return SpaceMesh(["cpu"] * N_DEV)


def words(mesh, parts):
    return mesh.gather(parts).view(np.uint32)


def test_sharded_step_matches_jax():
    args = batch(0)
    mesh = port_mesh()
    new, ent, lv, total = make_sharded_aoi_step(mesh)(
        *(mesh.device_put(a) for a in args))
    assert len(new) == N_DEV and all(t.shape[0] == 2 for t in new)
    jm = JaxMesh(jax_devices(N_DEV))
    jn, je, jl, jt = jax_sharded_step(jm)(*(jm.device_put(a) for a in args))
    for got, want in ((new, jn), (ent, je), (lv, jl)):
        np.testing.assert_array_equal(words(mesh, got), np.asarray(want))
    assert total == int(jt) > 0
    dn, de, dl = aoi_step_dense_batched(*map(jnp.asarray, args))
    np.testing.assert_array_equal(words(mesh, ent), np.asarray(de))
    np.testing.assert_array_equal(words(mesh, lv), np.asarray(dl))


@pytest.mark.parametrize("max_words,chunk_k", [(4096, 128), (256, 2)])
def test_sharded_streams_match_jax(max_words, chunk_k):
    """Shard-local extraction: vals, word indices, word counts and the
    exact overflow scalars equal JAX's chip-local streams, element for
    element (the second case overflows its caps)."""
    args = batch(1)
    mesh = port_mesh()
    new, ent, lv, total = make_sharded_aoi_step(
        mesh, max_words=max_words, chunk_k=chunk_k)(
        *(mesh.device_put(a) for a in args))
    jm = JaxMesh(jax_devices(N_DEV))
    jn, jent, jlv, jt = jax_sharded_step(
        jm, max_words=max_words, chunk_k=chunk_k)(
        *(jm.device_put(a) for a in args))
    assert total == int(jt)
    np.testing.assert_array_equal(words(mesh, new), np.asarray(jn))
    mc = max(1, max_words // 128)
    for port_s, jax_s in ((ent, jent), (lv, jlv)):
        jv, ji, jw, jnd, jmcc = (np.asarray(a) for a in jax_s)
        for d, (vals, idx, n_words, nd, mcc) in enumerate(port_s):
            sl = slice(d * mc, (d + 1) * mc)
            np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                          jv[sl])
            np.testing.assert_array_equal(idx.numpy(), ji[sl])
            assert (int(n_words), int(nd), int(mcc)) == (
                int(jw[d]), int(jnd[d]), int(jmcc[d]))
    overflow = any(int(s[3]) > mc or int(s[4]) > chunk_k for s in ent)
    assert overflow == (chunk_k == 2)


def test_shard_streams_expand_to_their_enter_pairs():
    """Each shard's complete stream expands (shard-local spaces, then
    offset) to exactly the enter bits of its block of the plain step."""
    from goworld_tpu_torch.ops.events import expand_words_host

    args = batch(2)
    mesh = port_mesh()
    new, ent, _lv, _t = make_sharded_aoi_step(
        mesh, max_words=4096, chunk_k=128)(*(mesh.device_put(a) for a in args))
    _n, want_e, _l = AK.aoi_step_entlv(
        *(torch.from_numpy(a) for a in args[:4]),
        TP.words_to_torch(args[4], "cpu"))
    cap = 128
    got = []
    for d, (vals, idx, _nw, _nd, _mcc) in enumerate(ent):
        pairs = expand_words_host(vals.numpy().view(np.uint32),
                                  idx.numpy(), cap)
        pairs[:, 0] += d * 2
        got.append(pairs)
    got = np.concatenate(got)
    assert len(got) > 0
    m = np.zeros((16, cap, cap), bool)
    m[got[:, 0], got[:, 1], got[:, 2]] = True
    want = TP.words_to_numpy(want_e)
    for s in range(16):
        np.testing.assert_array_equal(TP.pack_rows(m[s]), want[s])


def test_entry_matches_jax_entry():
    from __graft_entry__ import entry as jax_entry

    jfn, jargs = jax_entry()
    fn, args = PE.entry(device="cpu")
    for a, ja in zip(args[:4], jargs[:4]):
        np.testing.assert_array_equal(a.numpy(), ja)
    want = jfn(*map(jnp.asarray, jargs))
    for got, w in zip(fn(*args), want):
        np.testing.assert_array_equal(TP.words_to_numpy(got), np.asarray(w))


def test_dryrun_multichip_on_8_cpu_shards():
    PE.dryrun_multichip(N_DEV, device="cpu")


def test_multichip_devices_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        multichip_devices(2)
    with pytest.raises(ValueError, match="SpaceMesh"):
        multichip_devices(2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PE.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpaceMesh(["cuda:0"])


def test_space_mesh_layout():
    mesh = port_mesh()
    a = np.arange(16 * 3, dtype=np.uint32).reshape(16, 3) | np.uint32(1 << 31)
    parts = mesh.device_put(a)
    assert [p.shape for p in parts] == [(2, 3)] * N_DEV
    assert parts[0].dtype == torch.int32
    np.testing.assert_array_equal(mesh.gather(parts).view(np.uint32), a)
    with pytest.raises(ValueError, match="multiple"):
        mesh.device_put(np.zeros((12, 3)))
    with pytest.raises(ValueError):
        SpaceMesh([])
