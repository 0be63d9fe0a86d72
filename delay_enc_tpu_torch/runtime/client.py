"""Client side of the warm prover daemon's protocol (see daemon.py).

Counterpart of `delay_enc_tpu/runtime/client.py`, byte for byte the same
protocol: newline-delimited JSON over a unix socket, one request line in;
for the streaming commands ("prove", "batch") event lines until a terminal
{"event": "done" | "error"} line; a status line (with "ok") for the others.
Pure host code: no torch, no device.
"""

from __future__ import annotations

import json
import os
import socket

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_socket_path() -> str:
    """`.daemon.sock` at the repo's root; callers name another with
    `socket_path` (no environment variable is read)."""
    return os.path.join(ROOT, ".daemon.sock")


def daemon_request(req: dict, on_event=None, timeout: float = 10.0,
                   socket_path: str | None = None):
    """Send one request; pass each event line to `on_event`; return the
    terminal dict ({"event": "done" | "error"} or a status), or None if no
    daemon answers at the socket.  `timeout` bounds each read: give a
    streaming command a generous one."""
    path = socket_path if socket_path is not None else default_socket_path()
    if not path or not os.path.exists(path):
        return None
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.settimeout(min(timeout, 10.0))
            sock.connect(path)
            sock.settimeout(timeout)
            sock.sendall((json.dumps(req) + "\n").encode())
            for line in sock.makefile("r"):
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if d.get("event") in ("done", "error") or "ok" in d:
                    return d
                if on_event:
                    on_event(d)
    except OSError:
        return None
    return None
