"""The port's gwvar and debug HTTP server against the JAX package's
(tests/test_debug_http.py's scenarios on goworld_tpu_torch): the expvar
roundtrip, ``/debug/vars``, ``/debug/opmon``, ``/debug/stacks``,
``/debug/health``, the 404, ``/debug/metrics`` (Prometheus text 0.0.4)
and ``/debug/trace`` (windowed, 400 on a garbage parameter).  The
opmon series the exposition shows for one operation are held to the
JAX package's: the same names, kinds and labels."""

import json
import urllib.request

from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import telemetry
from goworld_tpu_torch.telemetry import trace as gwtrace
from goworld_tpu_torch.utils import binutil, gwvar, opmon


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read()


def opmon_series(text):
    """An exposition's opmon series of ``unit_test_op``: each sample's name
    and labels (values aside: they are times) and its family's ``# TYPE``
    line."""
    lines = text.splitlines()
    samples = sorted(ln.split(" ")[0] for ln in lines
                     if ln.startswith("gw_opmon_")
                     and 'op="unit_test_op"' in ln)
    families = {x.split("{")[0] for x in samples}
    return samples, sorted(ln for ln in lines if ln.startswith("# TYPE ")
                           and ln.split()[2] in families)


def jax_metrics():
    """The JAX package's ``/debug/metrics`` after the same operation."""
    from goworld_tpu.utils import binutil as jax_binutil
    from goworld_tpu.utils import opmon as jax_opmon

    jax_opmon.reset()
    jax_opmon.start_operation("unit_test_op").finish()
    srv = jax_binutil.setup_http_server(0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/metrics", timeout=5) as r:
            return r.read().decode()
    finally:
        srv.shutdown()


def test_gwvar_roundtrip():
    gwvar.reset()
    gwvar.set_var("is_deployment_ready", False)
    gwvar.set_var("is_deployment_ready", True)
    gwvar.add("packets", 3)
    gwvar.add("packets")
    snap = gwvar.snapshot()
    assert snap["is_deployment_ready"] is True
    assert snap["packets"] == 4
    assert gwvar.get_var("missing", 7) == 7


def test_debug_http_endpoints():
    gwvar.reset()
    gwvar.set_var("component", "test")
    op = opmon.start_operation("unit_test_op")
    op.finish()

    srv = binutil.setup_http_server(0)
    try:
        port = srv.server_address[1]

        status, body = _get(port, "/debug/vars")
        assert status == 200
        vars_ = json.loads(body)
        assert vars_["component"] == "test"
        assert vars_["debug_http_addr"].endswith(str(port))

        status, body = _get(port, "/debug/opmon")
        assert status == 200
        assert "unit_test_op" in json.loads(body)

        status, body = _get(port, "/debug/stacks")
        assert status == 200
        assert b"--- thread" in body

        status, body = _get(port, "/debug/health")
        assert (status, body) == (200, b"ok")

        try:
            _get(port, "/nope")
            raise AssertionError("404 expected")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        srv.shutdown()


def test_debug_metrics_and_trace_endpoints():
    """/debug/metrics serves Prometheus text 0.0.4 (even though only the
    collectors have data); /debug/trace serves Perfetto-loadable JSON with
    ?ticks=N windowing and a 400 on a garbage param."""
    opmon.reset()
    opmon.start_operation("unit_test_op").finish()
    telemetry.enable()
    try:
        gwtrace.reset()
        gwtrace.mark_tick(1)
        with gwtrace.span("tick.aoi"):
            pass
        gwtrace.mark_tick(2)
        with gwtrace.span("tick.sync"):
            pass
        srv = binutil.setup_http_server(0)
        try:
            port = srv.server_address[1]
            url = f"http://127.0.0.1:{port}"

            with urllib.request.urlopen(f"{url}/debug/metrics", timeout=5) as r:
                assert r.status == 200
                assert r.headers["Content-Type"].startswith(
                    "text/plain; version=0.0.4")
                text = r.read().decode()
            assert 'gw_opmon_count_total{op="unit_test_op"} 1' in text
            assert opmon_series(text) == opmon_series(jax_metrics())
            # /debug/opmon and /debug/metrics agree on the same op table
            with urllib.request.urlopen(f"{url}/debug/opmon", timeout=5) as r:
                assert json.loads(r.read())["unit_test_op"]["count"] == 1

            with urllib.request.urlopen(f"{url}/debug/trace?ticks=1",
                                        timeout=5) as r:
                assert r.status == 200
                doc = json.loads(r.read())
            names = [e["name"] for e in doc["traceEvents"]]
            assert "tick.sync" in names and "tick 2" in names
            assert "tick 1" not in names  # windowed to the last tick

            try:
                urllib.request.urlopen(f"{url}/debug/trace?ticks=nope",
                                       timeout=5)
                raise AssertionError("400 expected")
            except urllib.error.HTTPError as e:
                assert e.code == 400
        finally:
            srv.shutdown()
    finally:
        telemetry.disable()
