"""In-process fake redis: just enough of the redis-py surface to run the
stream protocol without a server.

Covers what the reference pipeline uses (evaluate_model_helpers.py:129-297 ↔
language-model-standalone.py:514-790): XADD / XREAD (with blocking and
'ms-seq' entry ids), XLEN, GET / SET, PING, TIME — plus a fault-injection
switch so the reconnect state machine in RedisDecoderServer can be exercised.
Install with ``install_fake_redis()`` (registers a module named ``redis`` in
sys.modules) so RedisDecoderServer / RemoteLMClient run unchanged.

Shared state is keyed by (host, port): every Redis() instance pointing at the
same address sees the same streams, like separate connections to one server.
"""

from __future__ import annotations

import sys
import threading
import time
import types
from typing import Dict, List, Optional, Tuple


class ConnectionError(Exception):  # noqa: A001 — mirrors redis.exceptions
    pass


def _encode(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, bool):
        return str(int(v)).encode()
    return str(v).encode()


def _parse_id(entry_id) -> Tuple[int, int]:
    if isinstance(entry_id, bytes):
        entry_id = entry_id.decode()
    if isinstance(entry_id, str):
        if "-" in entry_id:
            ms, seq = entry_id.split("-")
            return int(ms), int(seq)
        return int(entry_id), 0
    return int(entry_id), 0


class _ServerState:
    """One fake server: streams + keys + a condition for blocking reads."""

    def __init__(self):
        self.streams: Dict[bytes, List[Tuple[Tuple[int, int], Dict[bytes, bytes]]]] = {}
        self.keys: Dict[bytes, bytes] = {}
        self.cond = threading.Condition()
        self.last_ms = 0
        self.last_seq = 0
        self.down = False  # fault injection: connections appear lost


_SERVERS: Dict[Tuple[str, int], _ServerState] = {}
_REGISTRY_LOCK = threading.Lock()


def _server(host: str, port: int) -> _ServerState:
    with _REGISTRY_LOCK:
        return _SERVERS.setdefault((host, port), _ServerState())


def reset_all() -> None:
    with _REGISTRY_LOCK:
        _SERVERS.clear()


def set_down(down: bool, host: str = "localhost", port: int = 6379) -> None:
    """Fault injection: make every connection to (host, port) raise
    ConnectionError until restored."""
    srv = _server(host, port)
    with srv.cond:
        srv.down = down
        srv.cond.notify_all()


class Redis:
    def __init__(self, host: str = "localhost", port: int = 6379, **_kw):
        self._srv = _server(host, port)

    def _check(self):
        if self._srv.down:
            raise ConnectionError("fake redis: connection lost")

    def ping(self) -> bool:
        self._check()
        return True

    def time(self) -> Tuple[int, int]:
        self._check()
        t = time.time()
        return int(t), int((t % 1) * 1e6)

    def xadd(self, stream, fields: dict) -> bytes:
        self._check()
        srv = self._srv
        with srv.cond:
            ms = int(time.time() * 1000)
            if ms <= srv.last_ms:
                srv.last_seq += 1
                ms = srv.last_ms
            else:
                srv.last_ms, srv.last_seq = ms, 0
            entry_id = (ms, srv.last_seq)
            data = {_encode(k): _encode(v) for k, v in fields.items()}
            srv.streams.setdefault(_encode(stream), []).append((entry_id, data))
            srv.cond.notify_all()
            return f"{entry_id[0]}-{entry_id[1]}".encode()

    def xlen(self, stream) -> int:
        self._check()
        return len(self._srv.streams.get(_encode(stream), []))

    def xread(self, streams: dict, count: Optional[int] = None,
              block: Optional[int] = None):
        self._check()
        srv = self._srv
        if block is None:
            deadline = None          # non-blocking
        elif block == 0:
            deadline = float("inf")  # block forever (redis semantics)
        else:
            deadline = time.time() + block / 1000.0
        while True:
            with srv.cond:
                if srv.down:
                    raise ConnectionError("fake redis: connection lost")
                out = []
                for name, last in streams.items():
                    last_id = _parse_id(last)
                    entries = [
                        (f"{ms}-{seq}".encode(), dict(data))
                        for (ms, seq), data in srv.streams.get(_encode(name), [])
                        if (ms, seq) > last_id
                    ]
                    if count is not None:
                        entries = entries[:count]
                    if entries:
                        out.append([_encode(name), entries])
                if out or deadline is None:
                    return out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return []
                srv.cond.wait(
                    timeout=0.05 if remaining == float("inf") else remaining
                )

    def set(self, key, value) -> bool:
        self._check()
        self._srv.keys[_encode(key)] = _encode(value)
        return True

    def get(self, key) -> Optional[bytes]:
        self._check()
        return self._srv.keys.get(_encode(key))


def make_module() -> types.ModuleType:
    """Build a module object that quacks like ``redis``."""
    mod = types.ModuleType("redis")
    mod.Redis = Redis
    exceptions = types.ModuleType("redis.exceptions")
    exceptions.ConnectionError = ConnectionError
    mod.exceptions = exceptions
    sys.modules.setdefault("redis.exceptions", exceptions)
    return mod


def install_fake_redis() -> types.ModuleType:
    """Register the fake as the ``redis`` package (no-op if real redis is
    importable and already loaded). Returns the module."""
    mod = make_module()
    sys.modules["redis"] = mod
    sys.modules["redis.exceptions"] = mod.exceptions
    return mod
