"""The HTTP layer of the port's worker and controller, on the standard
library (the JAX package's runs on aiohttp and requests; the port's serves
and calls the same routes with http.server and urllib.request).

A POST route is a function of (handler, JSON body), a GET route of the
handler alone. It answers with `handler.send_json(obj)` or
`handler.send_body(bytes, content_type)`, or streams:
`handler.start_stream(content_type)` then `handler.write_chunk(bytes)` per
chunk. Responses are HTTP/1.0: a
stream carries no length and ends when the connection closes, which both
aiohttp's and urllib's clients read as the end of the body.
"""

from __future__ import annotations

import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def post_json(url: str, payload: dict, timeout: float):
    """POST payload as JSON; returns the open response (a file-like object:
    read it, or read1 it chunk by chunk as it streams, then close it)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def post_json_reply(url: str, payload: dict, timeout: float) -> dict:
    """POST payload as JSON and return the JSON reply."""
    with post_json(url, payload, timeout) as resp:
        return json.loads(resp.read() or b"{}")


class _Handler(BaseHTTPRequestHandler):
    routes: dict = {}      # POST routes, set per server by make_server
    get_routes: dict = {}  # GET routes: fn(handler)

    def do_GET(self):  # noqa: N802 — http.server's name
        route = self.get_routes.get(self.path.split("?", 1)[0])
        if route is None:
            self.send_json({"error": f"no route {self.path}"}, status=404)
            return
        try:
            route(self)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_POST(self):  # noqa: N802 — http.server's name
        route = self.routes.get(self.path.split("?", 1)[0])
        if route is None:
            self.send_json({"error": f"no route {self.path}"}, status=404)
            return
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            body = json.loads(raw) if raw else {}
        except json.JSONDecodeError as e:
            self.send_json({"error": f"bad JSON: {e}"}, status=400)
            return
        try:
            route(self, body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away; the request's work has finished or goes on alone

    def send_json(self, obj, status: int = 200) -> None:
        self.send_body(json.dumps(obj).encode(), "application/json", status)

    def send_body(self, data: bytes, content_type: str, status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def start_stream(self, content_type: str = "application/octet-stream") -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.end_headers()

    def write_chunk(self, data: bytes) -> None:
        self.wfile.write(data)
        self.wfile.flush()

    def log_message(self, format, *args):  # noqa: A002 — http.server's signature
        pass  # one line a request on stderr is noise beside a streaming server


def make_server(host: str, port: int, routes: dict,
                get_routes: dict | None = None) -> ThreadingHTTPServer:
    """A threading HTTP server (one thread a request, daemon threads) whose
    POST routes are `routes` {path: fn(handler, body)} and GET routes
    `get_routes` {path: fn(handler)}. Port 0 takes a free one
    (server.server_address). Run server.serve_forever(); end it with
    shutdown() and server_close()."""
    handler = type("Handler", (_Handler,), {"routes": dict(routes),
                                            "get_routes": dict(get_routes or {})})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server
