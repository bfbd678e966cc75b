"""Live time series over HTTP for the harness: the port's copy of
`dexrobot_isaac_tpu/graphics/liveplot.py`.

`log()` appends scalar samples to a ring per series; a browser at `/`
polls `/data` (JSON) twice a second and draws one line chart per series.
The server thread reads only the host-side rings.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from dexrobot_isaac_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_PAGE = b"""<html><head><title>DexHand live series</title></head>
<body style="background:#14161c;color:#c9cdd6;font-family:monospace;margin:16px">
<h2 style="font-weight:normal">DexHand live series</h2>
<div id="charts"></div>
<script>
const W = 640, H = 120, PAD = 34;
const charts = {};
function ensure(name) {
  if (charts[name]) return charts[name];
  const wrap = document.createElement('div');
  const title = document.createElement('div');
  title.textContent = name;
  title.style.cssText = 'color:#9aa0ae;margin:10px 0 2px';
  const cv = document.createElement('canvas');
  cv.width = W; cv.height = H;
  cv.style.cssText = 'background:#1b1e27;border:1px solid #2a2e3a';
  const val = document.createElement('span');
  val.style.cssText = 'color:#c9cdd6;margin-left:8px';
  title.appendChild(val);
  wrap.appendChild(title); wrap.appendChild(cv);
  document.getElementById('charts').appendChild(wrap);
  charts[name] = {cv, val};
  return charts[name];
}
function draw(name, ys) {
  const {cv, val} = ensure(name);
  const g = cv.getContext('2d');
  g.clearRect(0, 0, W, H);
  if (!ys.length) return;
  let lo = Math.min(...ys), hi = Math.max(...ys);
  if (hi - lo < 1e-12) { hi = lo + 1; lo = lo - 1; }
  const x = i => PAD + (W - PAD - 6) * i / Math.max(ys.length - 1, 1);
  const y = v => H - 14 - (H - 26) * (v - lo) / (hi - lo);
  g.strokeStyle = '#2a2e3a'; g.lineWidth = 1;          // recessive grid
  g.beginPath(); g.moveTo(PAD, y(lo)); g.lineTo(W - 6, y(lo)); g.stroke();
  g.fillStyle = '#9aa0ae'; g.font = '10px monospace';  // axis ink, not series
  g.fillText(hi.toPrecision(3), 2, y(hi) + 4);
  g.fillText(lo.toPrecision(3), 2, y(lo) + 4);
  g.strokeStyle = '#7aa2f7'; g.lineWidth = 2;          // single-hue series
  g.beginPath();
  ys.forEach((v, i) => i ? g.lineTo(x(i), y(v)) : g.moveTo(x(i), y(v)));
  g.stroke();
  val.textContent = ' = ' + ys[ys.length - 1].toPrecision(5);
}
async function tick() {
  try {
    const d = await (await fetch('/data')).json();
    for (const [name, ys] of Object.entries(d)) draw(name, ys);
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script>
</body></html>"""


class LivePlotServer:
    """Thread-safe scalar-series sink + HTTP live view (port auto-increments
    like HTTPVideoStreamer when taken)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8090,
        max_port_attempts: int = 10,
        maxlen: int = 2000,
    ):
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self.max_port_attempts = max_port_attempts
        self.maxlen = maxlen
        self._series: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def log(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._series:
                self._series[name] = deque(maxlen=self.maxlen)
            self._series[name].append(float(value))

    def log_many(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            self.log(k, v)

    def data(self) -> Dict[str, list]:
        with self._lock:
            return {k: list(v) for k, v in self._series.items()}

    def start(self) -> None:
        plot = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path == "/data":
                    body = json.dumps(plot.data()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
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
        logger.info(f"Live series: http://{self.host}:{self.port}/")

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
