"""MJPEG over HTTP (stdlib `http.server`): the port's copy of
`dexrobot_isaac_tpu/graphics/streamer.py`.

`/` is a page that shows the stream and forwards its keydown events to
`GET /control?key=<name>`, `/stream` the multipart MJPEG of the latest
frames, `/stats` a JSON of the counters; a taken port moves the server to
the next one. Frames are JPEG-encoded with OpenCV (imported in
`add_frame`). `on_key` (set by ViewerController to its `push_key`) runs on
an HTTP worker thread and only queues: the render thread applies the keys,
so nothing on the card is touched from an HTTP thread.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from dexrobot_isaac_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_PAGE = b"""<html><head><title>DexHand stream</title></head>
<body style="background:#111;color:#eee;font-family:monospace">
<h2>DexHand live stream</h2>
<img src="/stream" style="border:1px solid #444"/>
<p><a href="/stats" style="color:#8cf">/stats</a>
&nbsp; keys: ENTER view &middot; F follow &middot; &uarr;/&darr; env &middot;
E reset env &middot; SPACE random actions &middot; C contacts</p>
<p id="k" style="color:#888"></p>
<script>
document.addEventListener('keydown', function (ev) {
  if (ev.key === ' ' || ev.key === 'Enter' || ev.key.startsWith('Arrow'))
    ev.preventDefault();
  fetch('/control?key=' + encodeURIComponent(ev.key));
  document.getElementById('k').textContent = 'sent: ' + ev.key;
});
</script>
</body></html>"""


class HTTPVideoStreamer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_port_attempts: int = 10,
        buffer_size: int = 4,
        jpeg_quality: int = 80,
    ):
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self.max_port_attempts = max_port_attempts
        self.jpeg_quality = jpeg_quality
        self._frames: deque = deque(maxlen=buffer_size)
        self._lock = threading.Condition()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stats = {"frames_received": 0, "clients": 0, "started": time.time()}
        # keyboard channel sink (set by ViewerController); called on an
        # HTTP worker thread — implementations must only queue
        self.on_key: Optional[Callable[[str], None]] = None

    def add_frame(self, frame: np.ndarray) -> None:
        """Encode an RGB frame to JPEG and publish it to connected clients."""
        import cv2

        ok, jpg = cv2.imencode(
            ".jpg", frame[..., ::-1],
            [int(cv2.IMWRITE_JPEG_QUALITY), self.jpeg_quality],
        )
        if not ok:
            return
        with self._lock:
            self._frames.append(jpg.tobytes())
            self._stats["frames_received"] += 1
            self._lock.notify_all()

    def start(self) -> None:
        streamer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence default request logging
                pass

            def do_GET(self):
                if self.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path.startswith("/control"):
                    qs = urllib.parse.urlparse(self.path).query
                    key = urllib.parse.parse_qs(qs).get("key", [""])[0]
                    if key and streamer.on_key is not None:
                        streamer.on_key(key)
                        streamer._stats["keys_received"] = (
                            streamer._stats.get("keys_received", 0) + 1
                        )
                    self.send_response(204)
                    self.end_headers()
                elif self.path == "/stats":
                    body = json.dumps(streamer.stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    streamer._stats["clients"] += 1
                    try:
                        last = None
                        while True:
                            with streamer._lock:
                                streamer._lock.wait(timeout=1.0)
                                frame = (
                                    streamer._frames[-1]
                                    if streamer._frames else None
                                )
                            if frame is None or frame is last:
                                continue
                            last = frame
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(b"Content-Type: image/jpeg\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(frame)}\r\n\r\n".encode()
                            )
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    finally:
                        streamer._stats["clients"] -= 1
                else:
                    self.send_response(404)
                    self.end_headers()

        for attempt in range(self.max_port_attempts):
            port = self.requested_port + attempt
            try:
                self._server = ThreadingHTTPServer((self.host, port), Handler)
                self.port = port
                break
            except OSError:
                continue
        if self._server is None:
            raise RuntimeError(
                f"No free port in [{self.requested_port}, "
                f"{self.requested_port + self.max_port_attempts})"
            )
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info(f"MJPEG stream: http://{self.host}:{self.port}/stream")

    def stats(self) -> dict:
        return {
            **self._stats,
            "uptime_s": round(time.time() - self._stats["started"], 1),
            "buffered": len(self._frames),
        }

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
