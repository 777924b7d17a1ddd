#!/usr/bin/env python3
"""How often a port picked with ``find_free_port`` is bound by another
socket before its owner binds it (the race behind a GCS that exits
before it is ready, ROADMAP §C):

    python3 tools/port_pick_race.py [--binders N] [--window S] [--seconds T]

BINDERS threads each bind port 0, listen for 0.2 s and close, over and
over, as the RPC servers and stores of a busy test run do; meanwhile
batches of ten trials each pick a port (bind 0, read it, close), wait
WINDOW seconds (a child's start before it binds) and bind it.  Prints
the trials whose bind failed, and the other binds made.  Any host; no
card, no cluster.
"""

from __future__ import annotations

import argparse
import socket
import threading
import time


def find_free_port() -> int:
    """The pick of ``_private/protocol.py`` ``find_free_port``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--binders", type=int, default=100)
    parser.add_argument("--window", type=float, default=0.5)
    parser.add_argument("--seconds", type=float, default=15.0)
    args = parser.parse_args()
    stop = threading.Event()
    counts = {"binds": 0, "trials": 0, "lost": 0}
    lock = threading.Lock()

    def binder():
        while not stop.is_set():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                s.listen()
                with lock:
                    counts["binds"] += 1
                time.sleep(0.2)

    def trial():
        port = find_free_port()
        time.sleep(args.window)
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                lost = 0
            except OSError:
                lost = 1
        with lock:
            counts["trials"] += 1
            counts["lost"] += lost

    binders = [threading.Thread(target=binder, daemon=True)
               for _ in range(args.binders)]
    for t in binders:
        t.start()
    deadline = time.monotonic() + args.seconds
    while time.monotonic() < deadline:
        batch = [threading.Thread(target=trial) for _ in range(10)]
        for t in batch:
            t.start()
        for t in batch:
            t.join()
    stop.set()
    for t in binders:
        t.join(timeout=5)
    print(f"{counts['lost']} of {counts['trials']} picked ports were bound "
          f"elsewhere first; {counts['binds']} other binds")


if __name__ == "__main__":
    main()
