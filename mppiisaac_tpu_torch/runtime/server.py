"""Minimal TCP RPC: the world ↔ planner process split (the port's copy of
the JAX package's `runtime/server.py`, the same protocol).

A world process (a simulator of its own, a robot bridge, or
`examples/*/world.py`) calls the planner's public methods —
`compute_action_tensor`, `get_rollouts`, `update_weights`,
`update_mppi_params`, `add_to_env` — with tensors as `runtime/transport`
bytes.

Protocol: 4-byte big-endian length + pickled (method, args, kwargs) request,
4-byte length + pickled (ok, payload) response; a remote exception comes
back as (False, "Type: message + traceback") and the client raises it.
Endpoints are zerorpc-style "tcp://host:port"; port 0 serves on a free port
(`Server.port` tells which).

Trust model: pickle over a loopback or lab link, as the reference's
zerorpc + msgpack; do not expose it to untrusted networks.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
import traceback
from typing import Any

_LEN = struct.Struct(">I")


def _parse_endpoint(ep: str):
    if ep.startswith("tcp://"):
        ep = ep[len("tcp://"):]
    host, _, port = ep.rpartition(":")
    return host or "0.0.0.0", int(port)


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=4)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, n))


class Server:
    """`Server(planner).bind("tcp://0.0.0.0:4242").run()`."""

    def __init__(self, obj: Any):
        self.obj = obj
        self._sock: socket.socket | None = None
        self._stop = threading.Event()

    def bind(self, endpoint: str) -> "Server":
        host, port = _parse_endpoint(endpoint)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(8)
        self._sock = s
        return self

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                try:
                    method, args, kwargs = _recv_msg(conn)
                except ConnectionError:
                    break
                try:
                    result = getattr(self.obj, method)(*args, **kwargs)
                    _send_msg(conn, (True, result))
                except Exception as e:  # relay the remote error to the caller
                    _send_msg(conn, (False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        finally:
            conn.close()

    def run(self):
        """Blocking accept loop, one thread per connection."""
        assert self._sock is not None, "bind() first"
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class Client:
    """`c = Client().connect("tcp://127.0.0.1:4242"); c.compute_action_tensor(...)`"""

    def __init__(self):
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def connect(self, endpoint: str) -> "Client":
        host, port = _parse_endpoint(endpoint)
        self._sock = socket.create_connection((host if host != "0.0.0.0" else "127.0.0.1", port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            with self._lock:
                _send_msg(self._sock, (name, args, kwargs))
                ok, payload = _recv_msg(self._sock)
            if not ok:
                raise RuntimeError(f"remote error: {payload}")
            return payload

        return call

    def close(self):
        if self._sock is not None:
            self._sock.close()
