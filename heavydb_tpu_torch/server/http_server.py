"""HTTP JSON endpoint over the same handler core as the TCP server.

Reference: the HeavyDB server exposes Thrift over HTTP/binary-HTTP
alongside the TCP transport (HeavyDB.cpp --http-port, DBHandler shared);
here the same `HeavyTpuServer` RPC methods are served over HTTP POST.

Protocol:
    POST /          {"method": "connect", "params": {...}, "id": 1}
                    — same envelope as the JSON-lines TCP protocol
    POST /sql       {"session": "...", "query": "SELECT ..."}
                    — convenience endpoint: rows + column meta as JSON
    GET  /status    — server status (no session required)

The port of heavydb_tpu/server/http_server.py; it runs on CUDA unless it
is given device="cpu" (`--device cpu`).

Usage:
    python -m heavydb_tpu_torch.server.http_server --port 6278 [--data /path] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from heavydb_tpu_torch.server.server import HeavyTpuServer, device_or_exit


def make_http_server(core: HeavyTpuServer, host: str = "127.0.0.1",
                     port: int = 6278) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        # quiet default request logging
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/status"):
                self._reply(200, core.rpc_get_status())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._reply(400, {"error": "bad JSON"})
                return
            if self.path.rstrip("/") == "/sql":
                out = core.handle({
                    "method": "sql_execute",
                    "params": {
                        "session": msg.get("session", ""),
                        "query": msg.get("query", ""),
                    },
                    "id": 0,
                })
                code = 200 if "result" in out else 400
                self._reply(code, out.get("result") or out)
                return
            out = core.handle(msg)
            self._reply(200 if "result" in out else 400, out)

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(host: str = "127.0.0.1", port: int = 6278,
               data_path=None, config=None,
               core: HeavyTpuServer = None, device=None) -> ThreadingHTTPServer:
    core = core or HeavyTpuServer(data_path, config, device)
    srv = make_http_server(core, host, port)
    srv.core = core
    return srv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6278)
    ap.add_argument("--data", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    args = ap.parse_args()
    srv = serve_http(args.host, args.port, args.data,
                     device=device_or_exit(args.device))
    print(f"heavydb_tpu_torch http server on {args.host}:{args.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
