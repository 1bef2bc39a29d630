"""Live training viewer (counterpart of ``divshot_tpu/viewer/live.py``):
an HTTP server over a ``TrainerSession``.

The reference editor renders the model in-viewport while the trainer runs
(``editor.cpp:1556-1575``: per-frame ``getGaussianPositions()`` etc. into
the visible splat model). The headless equivalent serves the same
snapshot stream over HTTP to the WebGL2 page from ``html_export``:

- ``GET /``        the live viewer page (polls status + splat data)
- ``GET /status``  JSON: phase, iteration, loss, splat count, generation
- ``GET /splats``  current snapshot packed as antimatter15 .splat records

``generation`` bumps every time a fresh snapshot is taken, so the page
refetches splat bytes only when the trainer actually produced new ones.
The server's threads read the session's host snapshot only (numpy arrays
and CPU tensors), never a tensor on the card.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from divshot_tpu_torch.viewer.html_export import live_page, splat_bytes


class LiveViewerServer:
    """Serve a TrainerSession's snapshots. Start/stop from the host thread;
    the HTTP server runs daemonic so it never blocks shutdown."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8123,
                 max_splats: int = 1_000_000, poll_ms: int = 1000):
        self.session = session
        self.max_splats = max_splats
        self._page = live_page(poll_ms).encode()
        self._lock = threading.Lock()
        self._cached_gen = -1
        self._cached_bytes = b""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    self._reply(200, "text/html", outer._page)
                elif path == "/status":
                    self._reply(200, "application/json",
                                json.dumps(outer.status()).encode())
                elif path == "/splats":
                    # ?gen=G -> 304 when the snapshot hasn't advanced (the
                    # page polls; without this every poll re-downloaded the
                    # full payload). ?max=N -> top-N-opacity decimation for
                    # large sessions (bounds the payload instead of
                    # streaming all splats every generation).
                    from urllib.parse import parse_qs
                    qs = parse_qs(self.path.split("?", 1)[1]) \
                        if "?" in self.path else {}
                    cur = int(getattr(outer.session,
                                      "snapshot_generation", 0))
                    if qs.get("gen") and int(qs["gen"][0]) == cur:
                        self.send_response(304)
                        self.send_header("X-Generation", str(cur))
                        self.end_headers()
                        return
                    maxn = int(qs["max"][0]) if qs.get("max") else None
                    body = outer.splat_payload(maxn)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Generation", str(cur))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    # -- data ----------------------------------------------------------------
    def status(self) -> dict:
        s = self.session
        loss = s.current_loss
        return {
            "phase": s.phase_name,
            "iteration": s.current_iteration,
            "max_iterations": s.max_iterations,
            "loss": None if loss != loss else float(loss),  # NaN -> null
            "num_splats": int(s.num_gaussians),
            "generation": int(getattr(s, "snapshot_generation", 0)),
        }

    def splat_payload(self, max_splats: int | None = None) -> bytes:
        gen = int(getattr(self.session, "snapshot_generation", 0))
        cap = min(max_splats or self.max_splats, self.max_splats)
        with self._lock:
            key = (gen, cap)
            if key != self._cached_gen:
                params = self.session.get_params_snapshot()
                self._cached_bytes = b"" if params is None else \
                    splat_bytes(params, cap)
                self._cached_gen = key
            return self._cached_bytes

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "LiveViewerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
