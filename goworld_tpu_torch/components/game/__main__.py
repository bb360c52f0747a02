"""Game process entry: ``python -m goworld_tpu_torch.components.game -gid N
-configfile goworld.ini -script mygame.py [-restore]``.

The user script is the game's logic module (reference analog: the user's own
main package linked against components/game).  It must define
``setup(game: GameService) -> None`` which registers entity/space/service
types; optionally ``on_ready(game)`` run once the deployment barrier passes.

Signals (reference: game.go:138-194): SIGTERM = graceful terminate (save and
destroy all entities); SIGHUP = freeze for hot reload (dump state, exit;
restart with -restore).

The port's game process: entity storage and kvdb are attached from the
config's [storage] / [kvdb] sections under ``-dir``, then durable world
state where ``aoi_checkpoint`` is not ``off``.  The AOI ticks on
``aoi_device`` (``cuda`` by default, which raises without a card: the
game never carries on on the CPU unless the config says ``aoi_device =
cpu`` or a host calculator, ``aoi_backend = cpu|cpp``).
"""

import argparse
import importlib.util
import os
import signal
import sys
import threading

# The game's host tensor work runs on its one logic thread, as the
# reference's numpy work does.  An OpenMP pool of one thread a core would
# fan small ops out to threads that, on a host the dispatcher, the gates
# and the clients share, wait for cores the logic thread needs: beside six
# CPU-bound test processes a client's login took 0.4-0.85 s, against 0.05 s
# with one thread.  Set before torch loads (it reads the variable once); an
# operator's own setting wins.
os.environ.setdefault("OMP_NUM_THREADS", "1")

from ... import config as gwconfig  # noqa: E402
from ...utils import gwlog  # noqa: E402
from .service import GameService  # noqa: E402


def load_script(path: str):
    spec = importlib.util.spec_from_file_location("gwgame_script", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["gwgame_script"] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None, default_script: str | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-gid", type=int, default=1)
    ap.add_argument("-configfile", required=True)
    ap.add_argument("-script", default=None)
    ap.add_argument("-restore", action="store_true")
    ap.add_argument("-log", default="info")
    ap.add_argument("-dir", default=".", help="runtime dir (freeze files, storage)")
    args = ap.parse_args(argv)
    script = args.script or default_script
    if not script:
        ap.error("-script is required")
    gwlog.setup(args.log)
    cfg = gwconfig.load(args.configfile)
    mod = load_script(script)

    game = GameService(args.gid, cfg, freeze_dir=args.dir)
    game.attach_storage(args.dir)
    game.attach_kvdb(args.dir)
    game.attach_checkpoints(args.dir)
    from ... import goworld as facade

    facade.bind(game)
    mod.setup(game)
    game.start(restore=args.restore)

    if hasattr(mod, "on_ready"):
        def wait_ready():
            import time

            while not game.deployment_ready and not game._stop.is_set():
                time.sleep(0.01)
            if game.deployment_ready:
                game.rt.post.post(lambda: mod.on_ready(game))

        threading.Thread(target=wait_ready, daemon=True).start()

    stop = threading.Event()
    freezing = threading.Event()

    def on_term(*a):
        stop.set()

    def on_hup(*a):
        freezing.set()
        game.rt.post.post(game.freeze)
        # wake main only once the freeze dump completed (game._stop is set
        # by _do_freeze after the dispatcher acks + file write)
        threading.Thread(
            target=lambda: (game._stop.wait(), stop.set()), daemon=True
        ).start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    signal.signal(signal.SIGHUP, on_hup)
    stop.wait()
    if freezing.is_set():
        game._thread.join(timeout=15)  # state already dumped by _do_freeze
    else:
        game.stop(save=True)


if __name__ == "__main__":
    sys.exit(main())
