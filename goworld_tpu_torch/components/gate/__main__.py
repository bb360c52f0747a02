"""Gate process entry: ``python -m goworld_tpu_torch.components.gate -gateid N
-configfile goworld.ini`` (reference: components/gate/gate.go)."""

import argparse
import signal
import sys
import threading

from ... import config as gwconfig
from ...utils import gwlog
from .service import GateService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-gateid", type=int, default=1)
    ap.add_argument("-configfile", required=True)
    ap.add_argument("-log", default="info")
    args = ap.parse_args()
    gwlog.setup(args.log)
    cfg = gwconfig.load(args.configfile)
    svc = GateService(args.gateid, cfg).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    svc.stop()


if __name__ == "__main__":
    sys.exit(main())
