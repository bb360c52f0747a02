"""The port's linter (``goworld_tpu_torch.analysis``): each of its 15
rules flags a seeded violation in a fixture tree and passes the fixed
one (the JAX package's ``tests/test_gwlint.py`` cases, in torch's
idiom); the port's tree has no finding under the port's own
``suppressions.txt``; every entry there has a reason and still matches
a finding; and an ``.item()`` put into a copy of the mesh bucket's
``_dispatch_fused`` is flagged by ``fused-dispatch``.

Stdlib-only where it lints: the linter must run where torch is absent.
The port's tree is linted once for the module (about 5 s)."""

from __future__ import annotations

import shutil
import textwrap
from pathlib import Path

import pytest

from goworld_tpu.analysis import RULES as JAX_RULES
from goworld_tpu_torch.analysis import RULES
from goworld_tpu_torch.analysis.__main__ import main as gwlint_main
from goworld_tpu_torch.analysis.core import (DEFAULT_SUPPRESSIONS,
                                             Suppressions, run)

REPO = Path(__file__).resolve().parents[1]
TREE = REPO / "goworld_tpu_torch"


def _mk(root: Path, files: dict[str, str]) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return root


def _ln(text: str, frag: str) -> int:
    """1-based line of the first line containing ``frag``."""
    for i, line in enumerate(textwrap.dedent(text).splitlines(), 1):
        if frag in line:
            return i
    raise AssertionError(f"fragment {frag!r} not in fixture")


def _lint(root: Path, rule: str):
    empty = root / "empty.suppressions"
    empty.write_text("")
    findings, errors = run([str(root)], root=str(root),
                           checkers=[RULES[rule]],
                           suppressions=str(empty))
    assert errors == []
    return [f for f in findings if f.rule == rule]


# -- per rule: a tree that must be flagged, and its fixed twin ---------------

HOT = """\
    import numpy as np
    import torch

    def tick(x, w):
        a = x.item()
        b = x.cpu()
        c = x.tolist()
        d = torch.nonzero(w)
        torch.cuda.synchronize()
        e = int(x)
        return a, b, c, d, e
"""
HOT_OK = """\
    import numpy as np
    import torch

    def tick(x, w, n):
        d = torch.nonzero(w, size=n)  # a fixed size: no wait
        e = int(np.uint32(7).view(np.int32))  # a host value
        f = int(n is not None)
        return d, e, f

    def drain(x):  # gwlint: allow[host-sync] -- fixture drain point
        return x.item()
"""

DISPATCH = """\
    class _Bucket:
        pass


    class Bucket(_Bucket):
        def dispatch(self):
            self._stage()

        def _stage(self):
            return self.count.cpu()
"""
DISPATCH_OK = """\
    class _Bucket:
        pass


    class Bucket(_Bucket):
        def dispatch(self):
            self._stage()  # gwlint: allow[flush-phase] -- fixture boundary

        def _stage(self):
            return self.count.cpu()
"""

FUSED = """\
    class Bucket:
        def _dispatch_fused(self):
            self.fz.run(0)
            return self.prev.item()
"""
FUSED_OK = """\
    class Bucket:
        def _dispatch_fused(self):
            self.fz.run(0)
            return self.prev
"""

H2D = """\
    import torch
    from ..ops import aoi_stage as AS


    class Bucket:
        def dispatch(self):
            x = AS.h2d(self._hx, self.device)
            z = torch.from_numpy(self._hz).to(self.device)
            return x, z
"""
H2D_OK = """\
    import torch
    from ..ops import aoi_stage as AS


    class Bucket:
        def dispatch(self):
            self._h2d("x", self._hx)
            return torch.from_numpy(self._hz).to(torch.float32)

        def _h2d(self, role, arr):
            return AS.h2d(arr, self.device)
"""

SEAMS = """\
    SEAMS = {
        "aoi.kernel": "the step",
    }
"""

TELE_CATALOG = '''\
    """The catalog.

    ``aoi.flushes``  counter  flushes
    """
'''

THREAD = """\
    import threading


    class Writer:
        def __init__(self):
            self.last = 0
            self._t = threading.Thread(target=self._run)

        def _run(self):
            self.last = 1

        def read(self):
            return self.last
"""
THREAD_OK = """\
    import threading


    class Writer:
        def __init__(self):
            self.last = 0
            self._lock = threading.Lock()
            self._t = threading.Thread(target=self._run)

        def _run(self):
            with self._lock:
                self.last = 1

        def read(self):
            with self._lock:
                return self.last
"""

POLICY = """\
    class InterestPolicy:
        pass


    @register
    class Team(InterestPolicy):
        name = "team"
"""
POLICY_OK = """\
    class InterestPolicy:
        pass


    @register
    class Team(InterestPolicy):
        name = "team"

        def oracle(self, x):
            return x
"""

CHURN = """\
    import torch


    def tick(key):
        g = torch.cuda.CUDAGraph()
        g.replay()


    def keyed(s, c, plen, tick, n):
        return capture_key(s, c, plen, tick, n)
"""
CHURN_OK = """\
    import torch


    class Graphs:
        def get(self, key):
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = torch.cuda.CUDAGraph()
            return g


    def keyed(s, c, plen, parity, n):
        return capture_key(s, c, plen, parity, n)
"""

CASES = {
    "host-sync": ({"ops/hot.py": HOT}, {"ops/hot.py": HOT_OK}, 6),
    "dtype": ({"ops/k.py": "import torch\nA = torch.arange(4)\n"
                           "B = torch.zeros(3, 4)\n"},
              {"ops/k.py": "import torch\n"
                           "A = torch.arange(4, dtype=torch.int64)\n"
                           "B = torch.zeros(3, 4, dtype=torch.int32)\n"}, 2),
    "wire": ({"proto/msgtypes.py": "MT_B = 2\nMT_A = 1\n"},
             {"proto/msgtypes.py": "MT_A = 1\nMT_B = 2\n"}, 1),
    "iter-order": ({"proto/snap.py": "def snap(reg, p):\n"
                                     "    for k in {1, 2}:\n"
                                     "        p.append_u16(k)\n"},
                   {"proto/snap.py": "def snap(reg, p):\n"
                                     "    for k in sorted({1, 2}):\n"
                                     "        p.append_u16(k)\n"}, 1),
    "gate-coverage": (
        {"pkg/gate.py": "import os\nX = os.environ.get('GW_FIXTURE_GATE')\n",
         # only the port's tests count
         "tests/test_other.py": "GW_FIXTURE_GATE = 1\n"},
        {"pkg/gate.py": "import os\nX = os.environ.get('GW_FIXTURE_GATE')\n",
         "tests/test_torch_gate.py": "GW_FIXTURE_GATE = 1\n"}, 1),
    "h2d-staging": ({"engine/aoi.py": H2D}, {"engine/aoi.py": H2D_OK}, 2),
    "fault-seam-coverage": (
        {"goworld_tpu_torch/faults.py": SEAMS,
         "goworld_tpu_torch/engine/aoi.py":
             "from .. import faults\nfaults.check('aoi.kernal')\n",
         "tests/test_torch_f.py": "PLAN = ''\n"},
        {"goworld_tpu_torch/faults.py": SEAMS,
         "goworld_tpu_torch/engine/aoi.py":
             "from .. import faults\nfaults.check('aoi.kernel')\n",
         "tests/test_torch_f.py": "PLAN = 'aoi.kernel:fail@1'\n"}, 3),
    "telemetry": (
        {"goworld_tpu_torch/telemetry/spans.py":
             "import torch\nfrom . import trace\n"
             "def f():\n    with trace.span('aoi.flushes'):\n"
             "        pass\n",
         "goworld_tpu_torch/telemetry/__init__.py": '"""No catalog."""\n',
         "tests/test_torch_t.py": "NAME = ''\n"},
        {"goworld_tpu_torch/telemetry/spans.py":
             "from . import trace\n"
             "def f():\n    with trace.span('aoi.flushes'):\n"
             "        pass\n",
         "goworld_tpu_torch/telemetry/__init__.py": TELE_CATALOG,
         "tests/test_torch_t.py": "NAME = 'aoi.flushes'\n"}, 3),
    "flush-phase": ({"engine/aoi.py": DISPATCH},
                    {"engine/aoi.py": DISPATCH_OK}, 1),
    "fused-dispatch": ({"engine/aoi_mesh.py": FUSED},
                       {"engine/aoi_mesh.py": FUSED_OK}, 1),
    "bounded-caps": (
        {"ops/b.py": "import torch\ndef f(max_n):\n"
                     "    return torch.zeros(max_n, 3, dtype=torch.int32)\n"},
        {"ops/b.py": "import torch\ndef f(max_n, stats):\n"
                     "    stats['decode_overflow'] += 1\n"
                     "    return torch.zeros(max_n, 3, dtype=torch.int32)\n"},
        1),
    "oracle-parity": ({"interest/p.py": POLICY,
                       "tests/test_torch_p.py": "X = 1\n"},
                      {"interest/p.py": POLICY_OK,
                       "tests/test_torch_p.py": "from x import Team\n"}, 2),
    "recompile-churn": ({"ops/g.py": CHURN}, {"ops/g.py": CHURN_OK}, 2),
    "thread-discipline": ({"engine/w.py": THREAD},
                          {"engine/w.py": THREAD_OK}, 1),
    "msg-flow": (
        {"proto/msgtypes.py": "MT_PING = 5\n"},
        {"proto/msgtypes.py": "MT_PING = 5\n",
         "proto/send.py": "def ping(Packet, MT):\n"
                          "    return Packet.for_msgtype(MT.MT_PING)\n",
         "proto/recv.py": "def on(mt, MT):\n    return mt == MT.MT_PING\n"},
        1),
}


def test_rules_are_the_reference_fifteen():
    assert set(RULES) == set(JAX_RULES) and len(RULES) == 15
    assert set(CASES) == set(RULES)


@pytest.mark.parametrize("verdict", ["flagged", "passes"])
@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fixture(rule, verdict, tmp_path):
    bad, good, n_bad = CASES[rule]
    root = _mk(tmp_path, bad if verdict == "flagged" else good)
    got = _lint(root, rule)
    if verdict == "flagged":
        assert len(got) >= n_bad, [f.render() for f in got]
    else:
        assert got == [], [f.render() for f in got]


def test_host_sync_locations(tmp_path):
    """Each sync of the fixture is reported at its line."""
    root = _mk(tmp_path, {"ops/hot.py": HOT})
    lines = {f.line for f in _lint(root, "host-sync")}
    for frag in ("x.item()", "x.cpu()", "x.tolist()", "torch.nonzero(w)",
                 "torch.cuda.synchronize()", "int(x)"):
        assert _ln(HOT, frag) in lines, frag


def test_fused_module_methods_are_entries(tmp_path):
    """Every method of the fused module's classes is a fused-dispatch and
    flush-phase entry; a packet written into its static buffer (out=)
    is no upload for h2d-staging, a fresh device tensor is."""
    src = """\
        from . import aoi_stage as AS


        class Graphs:
            def run(self, t):
                self.graph.replay()
                self.done.synchronize()

            def load(self, idx):
                AS.h2d(idx, self.device, out=self.idx)
                self.sub = AS.h2d(idx, self.device)
    """
    root = _mk(tmp_path, {"ops/fused.py": src})
    for rule in ("fused-dispatch", "flush-phase"):
        got = _lint(root, rule)
        assert [f.line for f in got] == [_ln(src, "synchronize")], rule
    got = _lint(root, "h2d-staging")
    assert [f.line for f in got] == [_ln(src, "self.sub = AS.h2d")]


def test_suppression_file_format(tmp_path):
    sup = tmp_path / "s.txt"
    sup.write_text("ops/hot.py::host-sync\nops/hot.py::host-sync::tick "
                   "-- fixture\n")
    s = Suppressions.load(str(sup))
    assert len(s.errors) == 1 and "reason" in s.errors[0]
    assert ("ops/hot.py", "host-sync", "tick") in s.func_rules


def test_cli_exit_codes(tmp_path, capsys):
    clean = _mk(tmp_path / "clean", {"pkg/ok.py": "X = 1\n"})
    assert gwlint_main([str(clean), "--root", str(clean)]) == 0
    dirty = _mk(tmp_path / "dirty", {"ops/hot.py": HOT})
    assert gwlint_main([str(dirty), "--root", str(dirty)]) == 1
    out = capsys.readouterr().out
    assert f"ops/hot.py:{_ln(HOT, 'x.item()')}:" in out
    bad = tmp_path / "dirty" / "bad.suppressions"
    bad.write_text("ops/hot.py::host-sync\n")
    assert gwlint_main([str(dirty), "--root", str(dirty),
                        "--suppressions", str(bad)]) == 2


# -- the port's tree ------------------------------------------------------------


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Every finding over the port's tree with no suppression file (the
    inline allow markers still apply): one index build for the module."""
    empty = tmp_path_factory.mktemp("gwlint") / "empty.suppressions"
    empty.write_text("")
    findings, errors = run([str(TREE)], root=str(REPO),
                           suppressions=str(empty))
    assert errors == []
    return findings


def test_port_tree_clean_under_its_suppressions(raw):
    sup = Suppressions.load(DEFAULT_SUPPRESSIONS)
    assert sup.errors == []
    left = [f for f in raw if not sup.covers(f)]
    assert left == [], "\n".join(f.render() for f in left)


def test_every_suppression_has_a_reason_and_a_finding(raw):
    sup = Suppressions.load(DEFAULT_SUPPRESSIONS)
    assert sup.errors == []
    assert sup.file_rules or sup.func_rules
    for path, rule in sorted(sup.file_rules):
        assert any(f.path == path and f.rule == rule for f in raw), \
            (path, rule)
    for path, rule, sym in sorted(sup.func_rules):
        assert any(f.path == path and f.rule == rule and f.symbol == sym
                   for f in raw), (path, rule, sym)
    # no blanket entry for the whole package
    assert all(p.endswith(".py") for p, *_ in
               sup.file_rules | sup.func_rules)


def test_item_in_mesh_dispatch_fused_is_flagged(tmp_path):
    """A copy of the port's bucket modules with one ``.item()`` put into
    the mesh bucket's ``_dispatch_fused``: ``fused-dispatch`` reports it
    there, and the unmodified copy has no finding."""
    rels = ["engine/aoi.py", "engine/aoi_mesh.py", "engine/aoi_rowshard.py",
            "ops/fused.py", "ops/aoi_stage.py", "ops/events.py"]
    for rel in rels:
        dst = tmp_path / "goworld_tpu_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(TREE / rel, dst)
    assert _lint(tmp_path, "fused-dispatch") == []
    mesh = tmp_path / "goworld_tpu_torch" / "engine" / "aoi_mesh.py"
    text = mesh.read_text()
    anchor = "        self.stats[\"fused_dispatches\"] += 1\n"
    i = text.index("    def _dispatch_fused(")
    j = text.index(anchor, i)
    mesh.write_text(text[:j] + "        self.prev[0].item()\n" + text[j:])
    line = text[:j].count("\n") + 1
    got = _lint(tmp_path, "fused-dispatch")
    assert [(f.path, f.line) for f in got] == \
        [("goworld_tpu_torch/engine/aoi_mesh.py", line)], \
        [f.render() for f in got]
    assert "_MeshCUDABucket._dispatch_fused" in got[0].message
