"""Boundaries of the port: goworld_tpu_torch and chip_smoke.py import
neither jax nor the goworld_tpu package; the default device is CUDA and
its absence raises (no quiet CPU carry-on); the CPU path launches no
kernel."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forbidden(name: str) -> bool:
    """jax*, or the goworld_tpu package itself (goworld_tpu_torch shares
    its prefix and is allowed)."""
    return name.startswith("jax") or name == "goworld_tpu" \
        or name.startswith("goworld_tpu.")


def test_port_modules_import_no_jax_and_no_goworld_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import goworld_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True).stdout.split()
    assert int(out[0]) >= 52  # every module of the nine slices
    loaded = out[1:]
    for mod in ("engine.runtime", "ops.aoi_grid", "ops.cadence",
                "ops.events", "parallel.mesh", "engine.aoi_mesh",
                "engine.aoi_rowshard", "entry", "faults", "ops.aoi_oracle",
                "ops.aoi_native", "ops.interest_kernels", "ops.interest_cuda",
                "interest", "interest.field", "interest.oracle",
                "interest.device", "interest.policy", "ingest",
                "ingest.movement", "load", "load.clients", "load.harness",
                "telemetry", "telemetry.metrics", "telemetry.trace",
                "netutil", "netutil.packet", "consts"):
        assert "goworld_tpu_torch." + mod in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_chip_smoke_imports_no_jax_and_no_goworld_tpu():
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "goworld_tpu_torch.engine.runtime" in names
    assert sorted(n for n in names if _forbidden(n)) == []


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and r.stdout == ""


def test_default_device_raises_without_cuda():
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch.engine.runtime import Runtime

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for make in (Runtime, AOIEngine, lambda: Runtime(device="cuda:0")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_mesh_engine_raises_without_cuda():
    """A mesh of CUDA devices needs them: no quiet carry-on on the CPU or
    on the plain version."""
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.parallel import SpaceMesh, multichip_devices

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for make in (lambda: AOIEngine(mesh=2),
                 lambda: AOIEngine(device="cpu", mesh=2),
                 lambda: AOIEngine(mesh=SpaceMesh(multichip_devices(2))),
                 lambda: Runtime(aoi_mesh=4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_cpu_path_launches_no_kernel():
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch.ops import aoi_cuda as AK
    from goworld_tpu_torch.ops import aoi_grid as AG
    from goworld_tpu_torch.ops import cadence as CD

    AK.reset_launches()
    AG.reset_launches()
    eng = AOIEngine(device="cpu")
    h = eng.create_space(128)
    x = np.arange(128, dtype=np.float32)
    eng.submit(h, x, x, np.full(128, 3.0, np.float32), np.ones(128, bool))
    eng.flush()
    assert len(eng.take_events(h)[0]) > 0
    t = [torch.from_numpy(a).reshape(1, 128) for a in
         (x, x, np.full(128, 3.0, np.float32), np.ones(128, bool))]
    grid = CD.FixedOrderGrid(*t, 200.0)
    grid.step(np.ones((1, 128), np.int8), np.zeros((1, 128), np.int8))
    CD.RowBlock(*t, 200.0, rows=64, row0=32)
    from goworld_tpu_torch.entry import dryrun_multichip
    from goworld_tpu_torch.parallel import SpaceMesh

    dryrun_multichip(2, device="cpu")
    mesh_eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 2),
                         rowshard_min_capacity=256)
    for cap in (128, 256):
        hm = mesh_eng.create_space(cap)
        mesh_eng.submit(hm, x, x, np.full(128, 3.0, np.float32),
                        np.ones(128, bool))
    mesh_eng.flush()
    assert len(mesh_eng.take_events(hm)[0]) > 0
    from goworld_tpu_torch.interest import TieredRatePolicy
    from goworld_tpu_torch.ops import interest_cuda as IC

    IC.reset_launches()
    stack = eng.attach_interest(h, [TieredRatePolicy()])
    eng.submit(h, x, x, np.full(128, 3.0, np.float32), np.ones(128, bool))
    stack.submit(x, x, np.full(128, 3.0, np.float32), np.ones(128, bool),
                 np.ones(128, np.uint32), np.ones(128, np.uint32))
    eng.flush()
    assert stack.stats["steps"] == 1 and stack.near.any()
    assert AK.launches == {"aoi_step": 0, "aoi_step_entlv": 0}
    assert AG.launches == {"aoi_words_culled": 0, "aoi_step_culled": 0}
    assert IC.launches == {"interest_step": 0}
