"""The port's deployment on real processes: ``python -m
goworld_tpu_torch.cli`` (start / status / reload / stop / kill / build)
over the port's dispatcher, game (``components/game/__main__``) and gate,
driven by the port's strict bot client; and the host-failover driver
(``engine/failover.py``: two worker processes, one of them SIGKILLed)
against the JAX package's oracle.

The games run ``aoi_backend = cuda`` on ``aoi_device = cpu`` (the step's
plain version): such a config starts without calling ``nvcc``, while a
config on a CUDA device fails ``build`` and ``start`` when ``nvcc`` is
missing.  Every subprocess has a timeout."""

import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "goworld_tpu_torch", "examples", "unity_demo.py")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def env(path=None):
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    if path is not None:
        e["PATH"] = path
    return e


def cli(args, timeout=120, path=None):
    return subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.cli", *args], cwd=REPO,
        env=env(path), capture_output=True, text=True, timeout=timeout)


def ini(tmp_path, device="cpu"):
    disp_port, gate_port = free_port(), free_port()
    cfg = tmp_path / f"goworld_{device}.ini"
    cfg.write_text(f"""
[deployment]
dispatchers = 1
games = 1
gates = 1

[dispatcher1]
host = 127.0.0.1
port = {disp_port}

[game_common]
boot_entity = Player
aoi_backend = cuda
aoi_device = {device}
position_sync_interval_ms = 50

[gate1]
host = 127.0.0.1
port = {gate_port}

[storage]
backend = sqlite
directory = entity_storage

[kvdb]
backend = filesystem
directory = kvdb
""")
    return str(cfg), gate_port


@pytest.fixture()
def fake_nvcc(tmp_path):
    """A PATH whose first ``nvcc`` records each call and fails."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    mark = tmp_path / "nvcc_called"
    nvcc = bindir / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho called >> {mark}\nexit 1\n")
    nvcc.chmod(0o755)
    return str(bindir) + os.pathsep + os.environ.get("PATH", ""), mark


def logs(run):
    out = []
    for fn in sorted(os.listdir(run)):
        if fn.endswith(".log"):
            with open(os.path.join(run, fn)) as f:
                out.append(f"--- {fn} ---\n" + f.read()[-3000:])
    return "\n".join(out)


def test_cli_start_bots_reload_stop(tmp_path, fake_nvcc):
    cfg, gate_port = ini(tmp_path)
    run = str(tmp_path / "run")
    path, nvcc_mark = fake_nvcc
    try:
        r = cli(["start", "-c", cfg, "-s", SCRIPT, "-d", run], path=path)
        assert r.returncode == 0, f"start failed:\n{r.stdout}\n{r.stderr}"
        assert not nvcc_mark.exists(), "a cpu-device config called nvcc"
        r = cli(["status", "-d", run])
        assert r.returncode == 0 and r.stdout.count("RUNNING") == 3, r.stdout
        from goworld_tpu_torch.client import GameClientConnection

        keeper = GameClientConnection(("127.0.0.1", gate_port))
        assert keeper.wait_for(lambda c: c.player is not None, 30), logs(run)
        keeper.call_player("enter_game", "keeper")
        assert keeper.wait_for(
            lambda c: c.player.attrs.get("name") == "keeper", 30), logs(run)
        # in a space (the scene's monsters mirrored): the space service is
        # up before the bots start
        assert keeper.wait_for(lambda c: len(c.entities) > 1, 30), logs(run)
        bots = subprocess.run(
            [sys.executable, "-m", "goworld_tpu_torch.examples.test_client",
             "--gate", f"127.0.0.1:{gate_port}", "-N", "16", "--duration",
             "8", "--strict"], cwd=REPO, env=env(), capture_output=True,
            text=True, timeout=120)
        assert bots.returncode == 0, bots.stdout + bots.stderr + logs(run)
        assert "16/16 bots OK" in bots.stdout
        m = re.search(r"visibility checks: (\d+)", bots.stdout)
        assert m and int(m.group(1)) > 0, bots.stdout

        r = cli(["reload", "-c", cfg, "-s", SCRIPT, "-d", run])
        assert r.returncode == 0, r.stdout + r.stderr + logs(run)
        keeper.call_player("whoami")
        assert keeper.wait_for(lambda c: any(
            ("on_whoami", ("keeper",)) in e.calls
            for e in c.entities.values()), 30), logs(run)
        kid = keeper.player.id
        keeper.close()
        r = cli(["stop", "-d", run])
        assert r.returncode == 0
        r = cli(["status", "-d", run])
        assert "RUNNING" not in r.stdout
    finally:
        cli(["kill", "-d", run])
    from goworld_tpu_torch.storage.backends import SqliteEntityStorage

    be = SqliteEntityStorage(os.path.join(run, "entity_storage"))
    assert be.read("Player", kid)["name"] == "keeper"
    be.close()


def test_cli_build(tmp_path, fake_nvcc):
    cfg, _ = ini(tmp_path)
    r = cli(["build", "-c", cfg, "-s", SCRIPT])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "build OK" in r.stdout and "kernels:" not in r.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    r = cli(["build", "-s", str(bad)])
    assert r.returncode == 1 and "build FAILED" in r.stdout
    # a config on a CUDA device needs the kernels: a failing nvcc fails
    # build and start with its message, and start spawns nothing
    cuda_cfg, _ = ini(tmp_path, device="cuda")
    path, nvcc_mark = fake_nvcc
    r = cli(["build", "-c", cuda_cfg, "-s", SCRIPT], path=path)
    assert r.returncode == 1 and "build FAILED" in r.stdout
    assert "CUDA kernels failed to build" in r.stderr
    run = str(tmp_path / "run")
    r = cli(["start", "-c", cuda_cfg, "-s", SCRIPT, "-d", run], path=path)
    assert r.returncode == 1 and "did not build" in r.stderr
    assert nvcc_mark.exists()
    assert not os.path.exists(run) or not [
        f for f in os.listdir(run) if f.endswith(".pid")]


def test_host_failover_kill9_loses_no_events(tmp_path):
    """kill -9 of one of two worker processes: the survivor adopts the
    dead worker's space from the shared checkpoints and replays the
    dispatcher's buffered moves; the merged stream equals the unkilled
    oracle, and that oracle is the JAX scenario's for the same seed."""
    from goworld_tpu.engine import failover as jfo
    from goworld_tpu_torch.engine import failover as fo
    from goworld_tpu_torch.engine.checkpoint import _walk_frames

    res = fo.host_failover_scenario(str(tmp_path), cap=16, ticks=24,
                                    kill_at=12, pace_s=0.005,
                                    lease_ttl_s=2.0, tier="cpu")
    assert res["events_lost"] == 0, res
    assert res["parity_ok"] and res["replay_parity_ok"], res
    assert res["survivor_space_ok"], res
    assert res["clu_stats"]["failovers"] >= 1
    assert res["clu_stats"]["leases"] > 0
    assert 0 <= res["restored_tick"] <= res["killed_tick"]
    for gid in (1, 2):  # the scenario's seeds: 17 + gid
        frames = _walk_frames(16, 200.0, 24, 17 + gid)
        got = fo._oracle_crcs(16, frames)
        assert got == jfo._oracle_crcs(16, frames)
        assert got == fo._oracle_crcs(16, frames, oracle_tier="cpp")
