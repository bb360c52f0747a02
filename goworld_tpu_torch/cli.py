"""Operator CLI (reference: cmd/goworld -- build|start|stop|kill|reload|status).

    python -m goworld_tpu_torch.cli start  -c goworld.ini -s mygame.py -d rundir
    python -m goworld_tpu_torch.cli status -d rundir
    python -m goworld_tpu_torch.cli reload -c goworld.ini -s mygame.py -d rundir
    python -m goworld_tpu_torch.cli stop   -d rundir

``start`` launches dispatchers -> games -> gates as real processes, waiting
for each component's readiness tag in its log before starting the next kind
(reference start barrier: start.go:98-116 watching supervisor tags).
``reload`` SIGHUPs the games (freeze), waits for them to exit, and restarts
them with -restore -- clients stay connected through the gates.
``stop`` signals gates -> games -> dispatchers (reference order, stop.go).

The port's copy of the JAX package's ``cli.py``: it spawns the port's
components (``goworld_tpu_torch.components.*``, the package's root on
their path).  A game whose config runs the CUDA kernels (``aoi_backend``
``cuda`` or ``auto`` on a CUDA ``aoi_device``, the defaults) needs them
built: ``start`` builds them once (``ops/_build.build_all``, into the
ignored ``build/``) before it spawns anything, so no game compiles inside
its readiness wait, and ``build`` builds them too.  Without ``nvcc`` such
a config fails both, with the compiler's message; a game on a CUDA device
without a card raises, and ``start`` then fails its readiness wait.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from . import config as gwconfig
from .utils.gwlog import READY_TAG

# the package's root: on the children's path, wherever they start
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def needs_kernels(cfg) -> bool:
    """Whether a game of ``cfg`` runs the CUDA kernels: its calculator is
    ``cuda`` or ``auto`` and its device a CUDA device."""
    return any(g.aoi_backend in ("cuda", "auto")
               and g.aoi_device.startswith("cuda")
               for g in cfg.games.values())


def build_kernels() -> str | None:
    """Build every stale CUDA source; None, or the failure's message."""
    from .ops import _build

    try:
        paths = _build.build_all()
    except RuntimeError as e:
        return str(e)
    print(f"kernels: {', '.join(sorted(os.path.basename(p) for p in paths.values()))} "
          f"in {_build.BUILD_DIR}")
    return None


def _pidfile(rundir: str, name: str) -> str:
    return os.path.join(rundir, f"{name}.pid")


def _logfile(rundir: str, name: str) -> str:
    return os.path.join(rundir, f"{name}.log")


def _proc_cmdline(pid: int) -> str:
    """The process's command line via /proc (reference role:
    cmd/goworld/process -- process-table inspection so a stale pidfile whose
    pid was recycled by an unrelated process is not reported RUNNING)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode("utf-8", "replace")
    except OSError:
        return ""


def _alive(pid: int, name: str | None = None) -> bool:
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    if name is None or not os.path.isdir("/proc"):
        return True
    # the component named e.g. "game2" runs as
    # `python -m goworld_tpu_torch.components.game`; verify the pid still belongs
    # to that component kind (pid-recycling guard).  An empty cmdline
    # (zombie / kernel thread) is not our live component.
    kind = name.rstrip("0123456789")
    return f"goworld_tpu_torch.components.{kind}" in _proc_cmdline(pid)


def _read_pids(rundir: str) -> dict[str, int]:
    out = {}
    if not os.path.isdir(rundir):
        return out
    for fn in sorted(os.listdir(rundir)):
        if fn.endswith(".pid"):
            try:
                out[fn[:-4]] = int(open(os.path.join(rundir, fn)).read())
            except (ValueError, OSError):
                pass
    return out


def _spawn(rundir: str, name: str, argv: list[str]) -> tuple[int, int]:
    """Returns (pid, log_offset): the log size before this process appends,
    so readiness watching ignores tags left by previous runs in the same
    rundir."""
    path = _logfile(rundir, name)
    offset = os.path.getsize(path) if os.path.exists(path) else 0
    log = open(path, "ab")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        argv, stdout=log, stderr=subprocess.STDOUT, cwd=rundir,
        start_new_session=True, env=env,
    )
    with open(_pidfile(rundir, name), "w") as f:
        f.write(str(proc.pid))
    return proc.pid, offset


# a component's readiness wait: a game process imports torch, initialises
# its device and, with -restore, rebuilds its spaces from the freeze file
# (about 16 s for 80,000 entities on a host core) before it is ready
READY_TIMEOUT_S = 120.0


def _wait_ready(rundir: str, name: str, offset: int = 0,
                timeout: float = READY_TIMEOUT_S) -> bool:
    """Watch the component's log (past ``offset``) for the readiness tag.
    Only content this run appended counts -- logs accumulate across runs."""
    path = _logfile(rundir, name)
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                if READY_TAG.encode() in f.read():
                    return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


def _fail_and_teardown(rundir: str, what: str) -> int:
    """A component never became ready: kill everything already spawned so a
    retried start doesn't stack duplicate processes on the same ports."""
    print(f"{what}; tearing down partial cluster", file=sys.stderr)
    _signal_kind(rundir, "gate", signal.SIGTERM)
    _signal_kind(rundir, "game", signal.SIGTERM)
    _signal_kind(rundir, "dispatcher", signal.SIGTERM)
    return 1


def cmd_start(args) -> int:
    cfg = gwconfig.load(args.config)
    os.makedirs(args.dir, exist_ok=True)
    config_abs = os.path.abspath(args.config)
    script_abs = os.path.abspath(args.script) if args.script else None
    if cfg.games and script_abs is None:
        print("start: -s/--script is required when games > 0", file=sys.stderr)
        return 1
    if script_abs is not None and not os.path.exists(script_abs):
        print(f"start: script not found: {script_abs}", file=sys.stderr)
        return 1
    if needs_kernels(cfg):
        failed = build_kernels()
        if failed is not None:
            print(f"start: the games' CUDA kernels did not build:\n{failed}",
                  file=sys.stderr)
            return 1
    py = sys.executable

    offsets: dict[str, int] = {}
    for i in cfg.dispatchers:
        name = f"dispatcher{i}"
        _pid, offsets[name] = _spawn(
            args.dir, name, [py, "-m", "goworld_tpu_torch.components.dispatcher",
                             "-dispid", str(i), "-configfile", config_abs])
    for i in cfg.dispatchers:
        if not _wait_ready(args.dir, f"dispatcher{i}", offsets[f"dispatcher{i}"]):
            return _fail_and_teardown(args.dir, f"dispatcher{i} failed to become ready")
    for i in cfg.games:
        name = f"game{i}"
        argv = [py, "-m", "goworld_tpu_torch.components.game", "-gid", str(i),
                "-configfile", config_abs, "-script", script_abs, "-dir", "."]
        if args.restore:
            argv.append("-restore")
        _pid, offsets[name] = _spawn(args.dir, name, argv)
    for i in cfg.games:
        if not _wait_ready(args.dir, f"game{i}", offsets[f"game{i}"]):
            return _fail_and_teardown(args.dir, f"game{i} failed to become ready")
    for i in cfg.gates:
        name = f"gate{i}"
        _pid, offsets[name] = _spawn(
            args.dir, name, [py, "-m", "goworld_tpu_torch.components.gate",
                             "-gateid", str(i), "-configfile", config_abs])
    for i in cfg.gates:
        if not _wait_ready(args.dir, f"gate{i}", offsets[f"gate{i}"]):
            return _fail_and_teardown(args.dir, f"gate{i} failed to become ready")
    print(f"cluster up: {len(cfg.dispatchers)} dispatcher(s), "
          f"{len(cfg.games)} game(s), {len(cfg.gates)} gate(s)")
    return 0


def _signal_kind(rundir: str, prefix: str, sig, wait: float = 10.0) -> list[str]:
    pids = _read_pids(rundir)
    names = [n for n in pids if n.startswith(prefix)]
    for n in names:
        if _alive(pids[n], n):
            os.kill(pids[n], sig)
    deadline = time.time() + wait
    while time.time() < deadline and any(_alive(pids[n], n) for n in names):
        time.sleep(0.05)
    for n in names:
        if not _alive(pids[n], n):
            try:
                os.unlink(_pidfile(rundir, n))
            except OSError:
                pass
    return names


def cmd_stop(args) -> int:
    # reference order: gates -> games -> dispatchers (stop.go:11-78)
    _signal_kind(args.dir, "gate", signal.SIGTERM)
    _signal_kind(args.dir, "game", signal.SIGTERM)
    _signal_kind(args.dir, "dispatcher", signal.SIGTERM)
    print("cluster stopped")
    return 0


def cmd_kill(args) -> int:
    for name, pid in _read_pids(args.dir).items():
        if _alive(pid, name):
            os.kill(pid, signal.SIGKILL)
    print("cluster killed")
    return 0


def cmd_status(args) -> int:
    pids = _read_pids(args.dir)
    if not pids:
        print("no components found")
        return 1
    rc = 0
    for name, pid in sorted(pids.items()):
        ok = _alive(pid, name)
        print(f"{name:16s} pid={pid:<8d} {'RUNNING' if ok else 'DEAD'}")
        rc |= 0 if ok else 1
    return rc


def cmd_reload(args) -> int:
    """Freeze games via SIGHUP, then restart them with -restore (clients stay
    connected through the gates) -- reference: reload.go:10-33."""
    cfg = gwconfig.load(args.config)
    pids = _read_pids(args.dir)
    game_names = [f"game{i}" for i in cfg.games if f"game{i}" in pids]
    for n in game_names:
        if _alive(pids[n], n):
            os.kill(pids[n], signal.SIGHUP)
    deadline = time.time() + READY_TIMEOUT_S
    while time.time() < deadline and any(_alive(pids[n], n) for n in game_names):
        time.sleep(0.05)
    still = [n for n in game_names if _alive(pids[n], n)]
    if still:
        print(f"games did not freeze: {still}", file=sys.stderr)
        return 1
    config_abs = os.path.abspath(args.config)
    script_abs = os.path.abspath(args.script)
    py = sys.executable
    offsets: dict[str, int] = {}
    for i in cfg.games:
        name = f"game{i}"
        _pid, offsets[name] = _spawn(
            args.dir, name,
            [py, "-m", "goworld_tpu_torch.components.game", "-gid", str(i),
             "-configfile", config_abs, "-script", script_abs,
             "-dir", ".", "-restore"])
    for i in cfg.games:
        if not _wait_ready(args.dir, f"game{i}", offsets[f"game{i}"]):
            print(f"game{i} failed to restore", file=sys.stderr)
            return 1
    print("reload complete")
    return 0


def cmd_build(args) -> int:
    """Build everything the cluster needs ahead of start (reference:
    goworld build, build.go:9-56 -- go-builds the three binaries; here:
    compile the native codec, the CUDA kernels when the config's games run
    them, byte-compile the framework + game script, and validate the
    config)."""
    import compileall
    import py_compile

    ok = True
    # 1. native codec (used by the packet layer when present)
    native_dir = os.path.join(os.path.dirname(__file__), "..", "native")
    native_dir = os.path.abspath(native_dir)
    if os.path.exists(os.path.join(native_dir, "Makefile")):
        targets = ["all"] + (["sanitize"] if getattr(args, "sanitize", False)
                             else [])
        r = subprocess.run(
            ["make", "-C", native_dir] + targets, capture_output=True,
            text=True
        )
        if r.returncode != 0:
            print(f"native build failed:\n{r.stdout}{r.stderr}",
                  file=sys.stderr)
            ok = False
        else:
            libs = [f for f in sorted(os.listdir(native_dir))
                    if f.endswith(".so")]
            print(f"native: {', '.join(libs)} in {native_dir}")
    # 2. byte-compile the framework package
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    if not compileall.compile_dir(pkg_dir, quiet=2, force=False):
        print("framework byte-compile failed", file=sys.stderr)
        ok = False
    else:
        print(f"framework: {pkg_dir} byte-compiled")
    # 3. the game script, if given
    if args.script:
        try:
            py_compile.compile(args.script, doraise=True)
            print(f"script: {args.script} OK")
        except py_compile.PyCompileError as e:
            print(f"script compile failed:\n{e}", file=sys.stderr)
            ok = False
    # 4. config validation (strict parse, same as the components do), then
    # the CUDA kernels its games run
    if args.config:
        try:
            cfg = gwconfig.load(args.config)
            print(
                f"config: {args.config} OK "
                f"({len(cfg.dispatchers)} dispatcher(s), "
                f"{len(cfg.games)} game(s), {len(cfg.gates)} gate(s))"
            )
        except Exception as e:
            print(f"config invalid: {e}", file=sys.stderr)
            ok = False
        else:
            if needs_kernels(cfg):
                failed = build_kernels()
                if failed is not None:
                    print(f"CUDA kernels failed to build:\n{failed}",
                          file=sys.stderr)
                    ok = False
    print("build OK" if ok else "build FAILED")
    return 0 if ok else 1


def _parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Minimal Prometheus text-exposition parser: (name, labels, value)
    per sample line; HELP/TYPE comments skipped."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, sval = line.rpartition(" ")
        if not head:
            continue
        labels: dict[str, str] = {}
        name = head
        if head.endswith("}") and "{" in head:
            name, _, rest = head.partition("{")
            for part in rest[:-1].split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                labels[k] = v.strip('"')
        try:
            out.append((name, labels, float(sval)))
        except ValueError:
            pass
    return out


def cmd_gwtop(args) -> int:
    """Live terminal dashboard over a dispatcher's federated
    ``/debug/metrics`` (docs/observability.md "Cluster metrics"): one row
    per component with its headline series, plus any ``--filter`` matches.
    ``--once`` prints a single frame (tests / piping)."""
    import urllib.request

    url = args.url.rstrip("/")
    if not url.startswith("http"):
        url = "http://" + url
    if not url.endswith("/debug/metrics"):
        url += "/debug/metrics"

    def frame() -> str:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            samples = _parse_prometheus(resp.read().decode("utf-8", "replace"))
        by_comp: dict[str, dict[str, float]] = {}
        rest: list[tuple[str, dict, float]] = []
        for name, labels, val in samples:
            comp = labels.get("component")
            if comp is not None:
                key = name
                extra = {k: v for k, v in labels.items()
                         if k not in ("component", "series")}
                if extra:
                    key += "{" + ",".join(
                        f"{k}={v}" for k, v in sorted(extra.items())) + "}"
                by_comp.setdefault(comp, {})[key] = val
            else:
                rest.append((name, labels, val))
        lines = [f"gwtop  {url}  components={len(by_comp)}", ""]
        headline = ("tick.count", "aoi.entities", "net.packets_sent",
                    "net.packets_recv", "trace.hops", "flight.dumps",
                    "clu.failovers", "accelerator_absent")
        for comp in sorted(by_comp):
            series = by_comp[comp]
            cells = []
            for want in headline:
                hits = [v for k, v in series.items()
                        if k == want or k.startswith(want + "{")]
                if hits:
                    cells.append(f"{want}={sum(hits):g}")
            lines.append(f"  {comp:14s} {'  '.join(cells)}")
            if args.filter:
                for k in sorted(series):
                    if args.filter in k:
                        lines.append(f"    {k:40s} {series[k]:g}")
        lines.append("")
        shown = 0
        for name, labels, val in sorted(rest):
            if args.filter and args.filter not in name:
                continue
            if not args.filter and not (
                    name.startswith("clu.") or name == "accelerator_absent"):
                continue
            lab = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            lines.append(f"  {name + ('{' + lab + '}' if lab else ''):44s} "
                         f"{val:g}")
            shown += 1
            if shown >= args.limit:
                lines.append(f"  ... ({args.limit}-row cap; use --filter)")
                break
        return "\n".join(lines)

    if args.once:
        try:
            print(frame())
        except OSError as e:
            print(f"gwtop: {url}: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        while True:
            try:
                body = frame()
            except OSError as e:
                body = f"gwtop: {url}: {e}"
            # ANSI home+clear keeps the frame flicker-free in any terminal
            sys.stdout.write("\x1b[H\x1b[2J" + body + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="goworld_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in [("start", cmd_start), ("stop", cmd_stop),
                     ("kill", cmd_kill), ("status", cmd_status),
                     ("reload", cmd_reload)]:
        p = sub.add_parser(name)
        p.add_argument("-d", "--dir", default="gwrun")
        if name in ("start", "reload"):
            p.add_argument("-c", "--config", required=True)
            p.add_argument("-s", "--script", default=None,
                           required=(name == "reload"))
            if name == "start":
                p.add_argument("--restore", action="store_true")
        p.set_defaults(fn=fn)
    p = sub.add_parser("gwtop", help="live cluster metrics dashboard "
                                     "(scrapes a dispatcher /debug/metrics)")
    p.add_argument("url", help="dispatcher debug address, e.g. "
                               "127.0.0.1:8000 (path optional)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--filter", default=None,
                   help="substring filter for extra series rows")
    p.add_argument("--limit", type=int, default=40,
                   help="cap on unlabeled series rows per frame")
    p.set_defaults(fn=cmd_gwtop)
    p = sub.add_parser("build")
    p.add_argument("--sanitize", action="store_true",
                   help="also build ASAN+UBSAN variants of the native libs "
                        "(the reference's covertest -race analog)")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("-s", "--script", default=None)
    p.set_defaults(fn=cmd_build)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
