"""Execution bridge — the counterpart of ``matrel_tpu/bridge.py``: a
newline-delimited JSON-RPC server over TCP, so a JVM-side (or any
non-Python) DSL shim can drive the port as the reference's Scala DSL
drives Spark: create/upload matrices, submit DSL/SQL queries, fetch
results. Same protocol as the JAX package's server.

Protocol (one JSON object per line):
  {"id": 1, "method": "create_random", "params": {"name": "A", "shape": [64, 64], "seed": 0}}
  {"id": 2, "method": "upload",        "params": {"name": "X", "shape": [2, 2], "data": [[1, 2], [3, 4]]}}
  {"id": 3, "method": "sql",           "params": {"query": "rowsum(A * A)", "store": "R"}}
  {"id": 4, "method": "fetch",         "params": {"name": "R"}}
  {"id": 5, "method": "explain",       "params": {"query": "A * A"}}
  {"id": 6, "method": "tables"} | {"method": "shutdown"}
Responses: {"id": N, "result": ...} or {"id": N, "error": "..."}.

``create_random`` goes through ``session.random``, a seeded
``torch.Generator`` on the session's device: its values differ from the
JAX package's for the same seed, and ``explain`` returns the port's
plan text; every other response is the JAX package's. The server's session runs on the card unless it is given one
(or a ``device``) that says otherwise.
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import threading
from typing import Any, Dict, Optional

import numpy as np

from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.utils import lockdep

log = logging.getLogger("matrel_tpu_torch.bridge")


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: "BridgeServer" = self.server  # type: ignore[assignment]
        for raw in self.rfile:
            line = raw.decode("utf-8").strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                result = server.dispatch(req.get("method"), req.get("params") or {})
                resp = {"id": req.get("id"), "result": result}
            except _Shutdown:
                self.wfile.write(json.dumps(
                    {"id": req.get("id"), "result": "bye"}).encode() + b"\n")
                self.wfile.flush()
                threading.Thread(target=server.shutdown, daemon=True).start()
                return
            except Exception as e:  # noqa: BLE001 — protocol boundary
                resp = {"id": req.get("id") if isinstance(req, dict) else None,
                        "error": f"{type(e).__name__}: {e}"}
            self.wfile.write(json.dumps(resp).encode("utf-8") + b"\n")
            self.wfile.flush()


class _Shutdown(Exception):
    pass


class BridgeServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, session: Optional[MatrelSession] = None,
                 host: str = "127.0.0.1", port: int = 0, device=None):
        super().__init__((host, port), _Handler)
        self.session = session or MatrelSession.builder().device(
            device).get_or_create()
        self._lock = lockdep.make_lock("bridge.server")

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    # -- RPC methods --------------------------------------------------------

    def dispatch(self, method: str, params: Dict[str, Any]) -> Any:
        # the session/catalog is not thread-safe: bridge.server
        # serialises each RPC, result materialisation included
        with self._lock:
            if method == "create_random":
                m = self.session.random(tuple(params["shape"]),
                                        seed=int(params.get("seed", 0)))
                self.session.register(params["name"], m)
                return {"shape": list(m.shape)}
            if method == "upload":
                arr = np.asarray(params["data"], dtype=np.float32)
                if "shape" in params:
                    arr = arr.reshape(params["shape"])
                m = self.session.from_numpy(arr)
                self.session.register(params["name"], m)
                return {"shape": list(m.shape)}
            if method == "sql":
                e = self.session.sql(params["query"])
                out = self.session.compute(e)
                if params.get("store"):
                    self.session.register(params["store"], out)
                    return {"stored": params["store"], "shape": list(out.shape)}
                return {"data": out.to_numpy().tolist(),  # lockcheck: disable=LK102 bridge.server IS the RPC serializer: the session is not thread-safe, so each RPC (including result materialization) runs under it by design; no other thread ever waits on this lock for latency
                        "shape": list(out.shape)}
            if method == "fetch":
                m = self.session.table(params["name"])
                return {"data": m.to_numpy().tolist(),  # lockcheck: disable=LK102 same RPC-serializer design as "sql" above: fetch materializes under bridge.server deliberately
                        "shape": list(m.shape)}
            if method == "explain":
                return {"plan": self.session.explain(
                    self.session.sql(params["query"]))}
            if method == "tables":
                return {"tables": {n: list(m.shape)
                                   for n, m in self.session.catalog.items()}}
            if method == "shutdown":
                raise _Shutdown()
            raise ValueError(f"unknown method {method!r}")


class BridgeClient:
    """Minimal client for tests/other processes (the JVM shim's contract)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))
        self.f = self.sock.makefile("rwb")
        self._id = 0

    def call(self, method: str, **params) -> Any:
        self._id += 1
        req = {"id": self._id, "method": method, "params": params}
        self.f.write(json.dumps(req).encode() + b"\n")
        self.f.flush()
        resp = json.loads(self.f.readline())
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["result"]

    def close(self):
        try:
            self.f.close()
        finally:
            self.sock.close()
