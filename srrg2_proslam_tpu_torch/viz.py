"""Live SLAM viewer: an embedded HTTP server streaming map and trajectory.

Port of srrg2_proslam_tpu/viz.py (standard library only).  A background
``ThreadingHTTPServer`` serves

  * ``/``            a self-contained HTML page that polls the state and
                     draws a top-down (x/z) view: trajectory polyline,
                     current local map landmarks, closure edges, status;
  * ``/state.json``  the latest snapshot.

GraphSLAM is not thread-safe and reading the card costs a round trip, so
the server never touches it: the driving loop calls ``viewer.update(slam)``
at its own cadence, which takes one small host snapshot, and requests
serve the cached snapshot.

    viewer = LiveViewer(port=8800)          # prints the URL
    for i, frame in enumerate(frames):
        slam.process(...)
        if i % 10 == 0:
            viewer.update(slam)
    viewer.close()

``python -m srrg2_proslam_tpu_torch.apps.app_benchmark --viewer-port 8800``
wires it into the benchmark app.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><title>srrg2_proslam_tpu_torch live</title><style>
body { background: #111; color: #ddd; font-family: monospace; margin: 12px; }
canvas { background: #181818; border: 1px solid #333; }
#hud { margin: 6px 0; }
</style></head><body>
<div id="hud">connecting...</div>
<canvas id="c" width="900" height="600"></canvas>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
async function tick() {
  try {
    const s = await (await fetch('state.json')).json();
    hud.textContent = `status=${s.status} frames=${s.frames} maps=${s.maps} `
      + `closures=${s.closures} relocs=${s.relocalizations}`;
    const tr = s.trajectory, lm = s.landmarks;
    ctx.clearRect(0, 0, cv.width, cv.height);
    if (tr.length) {
      let xs = tr.map(p => p[0]).concat(lm.map(p => p[0]));
      let zs = tr.map(p => p[2]).concat(lm.map(p => p[2]));
      const x0 = Math.min(...xs), x1 = Math.max(...xs);
      const z0 = Math.min(...zs), z1 = Math.max(...zs);
      const sc = 0.9 * Math.min(cv.width / Math.max(x1 - x0, 1e-3),
                                cv.height / Math.max(z1 - z0, 1e-3));
      const X = p => 0.05 * cv.width + (p[0] - x0) * sc;
      const Z = p => 0.05 * cv.height + (p[2] - z0) * sc;
      ctx.fillStyle = '#4a6';
      for (const p of lm) ctx.fillRect(X(p) - 1, Z(p) - 1, 2, 2);
      ctx.strokeStyle = '#fa3'; ctx.lineWidth = 2; ctx.beginPath();
      tr.forEach((p, i) => i ? ctx.lineTo(X(p), Z(p)) : ctx.moveTo(X(p), Z(p)));
      ctx.stroke();
      ctx.strokeStyle = '#38f';
      for (const [a, b] of s.closure_edges) {
        ctx.beginPath(); ctx.moveTo(X(tr[a]), Z(tr[a]));
        ctx.lineTo(X(tr[b]), Z(tr[b])); ctx.stroke();
      }
      const last = tr[tr.length - 1];
      ctx.fillStyle = '#f55';
      ctx.beginPath(); ctx.arc(X(last), Z(last), 4, 0, 7); ctx.fill();
    }
  } catch (e) { hud.textContent = 'disconnected: ' + e; }
  setTimeout(tick, 500);
}
tick();
</script></body></html>
"""


def snapshot(slam, max_landmarks: int = 2048) -> dict:
    """One JSON-able host snapshot of the SLAM state.

    Consumes the speculative queue (the trajectory unrolls through the
    PGO-updated poses) and reads back the current local map's landmark
    positions in the world frame: a few tens of kB per refresh.
    """
    slam.flush()
    traj = slam.trajectory()
    arena = slam.current_local_map()
    pos = arena.pos.cpu().numpy()
    valid = arena.valid.cpu().numpy()
    pts = pos[valid][:max_landmarks]
    if slam.current_map >= 0 and len(pts):
        T = slam.graph.poses[slam.current_map].cpu().numpy()
        pts = pts @ T[:3, :3].T + T[:3, 3]
    # closure edges as frame-index pairs (first frame of each linked map)
    first_frame = {}
    for i, fr in enumerate(slam.frames):
        first_frame.setdefault(fr.local_map_index, i)
    edges = [[first_frame[a], first_frame[b]]
             for a, b in slam.closure_events
             if a in first_frame and b in first_frame]
    return dict(
        status=slam.status,
        frames=len(traj),
        maps=slam.num_maps,
        closures=slam.num_closures,
        relocalizations=slam.num_relocalizations,
        trajectory=[list(map(float, T[:3, 3])) for T in traj],
        landmarks=[list(map(float, p)) for p in pts],
        closure_edges=edges,
    )


class LiveViewer:
    """Background HTTP server for the live top-down view."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = False):
        self._state = json.dumps(dict(
            status="Initializing", frames=0, maps=0, closures=0,
            relocalizations=0, trajectory=[], landmarks=[],
            closure_edges=[]))
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.endswith("state.json"):
                    body = viewer._state.encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # no per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}/"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        if not quiet:
            print(f"[viewer] live view at {self.url}")

    def update(self, slam, max_landmarks: int = 2048):
        """Refresh the served snapshot from the driving loop's thread."""
        self._state = json.dumps(snapshot(slam, max_landmarks))

    def close(self):
        self._server.shutdown()
        self._server.server_close()
