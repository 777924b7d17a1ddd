"""Session-log serving, shared by the node daemon (back-compat routes)
and the per-node agent (ref: the reference's log agent endpoints —
dashboard/agent.py:24).  One implementation so the traversal guard and
read caps can never diverge between the two servers."""

from __future__ import annotations

import os


def logs_dir(session_dir: str) -> str:
    return os.path.join(session_dir, "logs")


def list_logs(session_dir: str) -> list[dict]:
    directory = logs_dir(session_dir)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        try:
            out.append({"filename": name,
                        "size": os.path.getsize(
                            os.path.join(directory, name))})
        except OSError:
            continue
    return out


def read_log(session_dir: str, payload: dict) -> dict:
    name = os.path.basename(payload["filename"])  # no traversal
    path = os.path.join(logs_dir(session_dir), name)
    max_bytes = min(int(payload.get("max_bytes", 65536)), 4 << 20)
    tail = payload.get("tail")
    try:
        size = os.path.getsize(path)
        offset = int(payload.get("offset", 0))
        if tail is not None:  # last N bytes
            offset = max(0, size - int(tail))
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(max_bytes)
        return {"data": data, "offset": offset,
                "next_offset": offset + len(data),
                "eof": offset + len(data) >= size}
    except OSError as e:
        return {"error": str(e)}
