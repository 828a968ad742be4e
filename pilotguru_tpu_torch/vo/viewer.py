"""Live tracking viewer: HTTP MJPEG frame stream and map state (port of
pilotguru_tpu/vo/viewer.py).

The runtime counterpart of the reference's Pangolin windows
(thirdparty/orb-slam2/src/Viewer.cc: FrameDrawer shows the current frame
with its tracked keypoints, MapDrawer the keyframe trajectory and the map
cloud; --visualize in src/optical_trajectories.cc:47), served over HTTP
for a headless machine. A browser pointed at the port shows:

- ``/``            a small HTML page: the frame stream and an orbit / pan /
                   zoom canvas of the map, polling the state;
- ``/stream.mjpg`` multipart/x-mixed-replace MJPEG of the overlay frames;
- ``/frame.jpg``   the latest overlay frame as one JPEG;
- ``/state.json``  tracker state: keyframe centres and axes, the map cloud,
                   status.

The tracking loop publishes; handlers serialize on demand under a lock, so
an idle viewer costs the tracker one JPEG encode a frame. Everything is the
standard library's ``http.server`` and cv2's JPEG encoder, imported in
``publish_frame``, which does not run where cv2 is missing. The state reads
the tracker's host arrays only (points, validity, keyframe poses), so it
costs no device transfer.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>pilotguru_tpu live tracker</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1em; }
 .row { display:flex; gap:1em; flex-wrap:wrap; }
 img, canvas { border:1px solid #444; background:#000; }
 #status { margin:0.5em 0; }
 #hint { color:#777; font-size:0.85em; }
</style></head>
<body>
<h3>pilotguru_tpu live tracker</h3>
<div id="status">connecting...</div>
<div class="row">
  <img id="frame" src="/stream.mjpg" width="640"/>
  <canvas id="map" width="560" height="560"></canvas>
</div>
<div id="hint">drag: orbit &middot; shift+drag: pan &middot; wheel: zoom
 &middot; double-click: reset (MapDrawer-equivalent 3D view)</div>
<script>
// Interactive 3D map view (the reference's Pangolin MapDrawer pan/orbit,
// thirdparty/orb-slam2/src/MapDrawer.cc, in ~100 lines of vanilla canvas).
const canvas = document.getElementById('map');
const cv = canvas.getContext('2d');
const W = canvas.width, H = canvas.height;
let yaw = 0.5, pitch = 0.45, dist = 2.2, panX = 0, panY = 0;
let state = null, center = [0, 0, 0], span = 1;
canvas.addEventListener('mousedown', e => {
  const move = ev => {
    if (e.shiftKey || ev.shiftKey || ev.buttons === 4) {
      panX += ev.movementX / W * span * dist;
      panY += ev.movementY / H * span * dist;
    } else {
      yaw += ev.movementX * 0.008; pitch += ev.movementY * 0.008;
      pitch = Math.max(-1.55, Math.min(1.55, pitch));
    }
    draw();
  };
  const up = () => { window.removeEventListener('mousemove', move);
                     window.removeEventListener('mouseup', up); };
  window.addEventListener('mousemove', move);
  window.addEventListener('mouseup', up);
});
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.0015);
  dist = Math.max(0.15, Math.min(30, dist));
  draw();
}, { passive: false });
canvas.addEventListener('dblclick', () => {
  yaw = 0.5; pitch = 0.45; dist = 2.2; panX = panY = 0; draw();
});
function project(p) {
  // world -> orbit camera (look at scene center) -> perspective.
  const x0 = (p[0] - center[0]) / span, y0 = (p[1] - center[1]) / span,
        z0 = (p[2] - center[2]) / span;
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let x = cy * x0 + sy * z0, z1 = -sy * x0 + cy * z0;
  let y = cp * y0 - sp * z1, z = sp * y0 + cp * z1 + dist;
  x += panX; y += panY;
  if (z < 0.05) return null;
  const f = 1.4 * Math.min(W, H) / 2;
  return [W / 2 + f * x / z, H / 2 + f * y / z, z];
}
function line(a, b) {
  const pa = project(a), pb = project(b);
  if (!pa || !pb) return;
  cv.beginPath(); cv.moveTo(pa[0], pa[1]); cv.lineTo(pb[0], pb[1]); cv.stroke();
}
function draw() {
  cv.fillStyle = '#000'; cv.fillRect(0, 0, W, H);
  if (!state) return;
  const pts = state.points || [], kfs = state.keyframe_centers || [];
  const axes = state.keyframe_axes || [];
  // MapDrawer point cloud.
  cv.fillStyle = '#2a6';
  for (const p of pts) {
    const q = project(p);
    if (q) cv.fillRect(q[0] - 1, q[1] - 1, 2, 2);
  }
  // Keyframe trajectory polyline.
  cv.strokeStyle = '#e33'; cv.lineWidth = 1.5;
  for (let i = 1; i < kfs.length; i++) line(kfs[i - 1], kfs[i]);
  // Camera frusta (small pyramid along each keyframe's +z optical axis;
  // MapDrawer::DrawKeyFrames).
  cv.strokeStyle = '#39f'; cv.lineWidth = 1;
  const s = 0.035 * span;
  for (let i = 0; i < kfs.length && i < axes.length; i++) {
    const c = kfs[i], a = axes[i];  // rows of R: camera axes in world
    const X = a[0], Y = a[1], Z = a[2];
    const corner = (sx, sy) => [
      c[0] + s * (sx * X[0] + sy * Y[0] + 1.6 * Z[0]),
      c[1] + s * (sx * X[1] + sy * Y[1] + 1.6 * Z[1]),
      c[2] + s * (sx * X[2] + sy * Y[2] + 1.6 * Z[2])];
    const q = [corner(-1, -0.7), corner(1, -0.7), corner(1, 0.7),
               corner(-1, 0.7)];
    for (let k = 0; k < 4; k++) { line(c, q[k]); line(q[k], q[(k + 1) % 4]); }
  }
}
async function tick() {
  try {
    const s = await (await fetch('/state.json')).json();
    state = s;
    document.getElementById('status').textContent =
      `frame ${s.frame_id}  state ${s.state}  inliers ${s.inliers}  ` +
      `map ${s.map_points}  keyframes ${s.keyframes}`;
    const all = (s.points || []).concat(s.keyframe_centers || []);
    if (all.length) {
      const mins = [0, 1, 2].map(i => Math.min(...all.map(p => p[i])));
      const maxs = [0, 1, 2].map(i => Math.max(...all.map(p => p[i])));
      center = [0, 1, 2].map(i => (mins[i] + maxs[i]) / 2);
      span = Math.max(maxs[0] - mins[0], maxs[1] - mins[1],
                      maxs[2] - mins[2], 1e-3);
    }
    draw();
  } catch (e) { document.getElementById('status').textContent = 'offline'; }
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveViewer:
    """Threaded HTTP live view. Start with port=0 for an ephemeral port
    (read it back from ``.port``); ``publish_frame`` / ``publish_state``
    are called from the tracking loop; ``close()`` stops the server."""

    def __init__(self, port: int = 0, max_cloud_points: int = 2000):
        self._lock = threading.Condition()
        self._jpeg: bytes | None = None
        self._jpeg_seq = 0
        self._state: dict = {
            "frame_id": -1, "state": "STARTING", "inliers": 0,
            "map_points": 0, "keyframes": 0,
        }
        self._max_cloud = max_cloud_points
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # keep the tracker's stdout clean
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/state.json":
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/frame.jpg":
                    with viewer._lock:
                        jpeg = viewer._jpeg
                    if jpeg is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", jpeg)
                elif self.path == "/stream.mjpg":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=pgtpuframe",
                    )
                    self.end_headers()
                    seq = -1
                    try:
                        while True:
                            with viewer._lock:
                                viewer._lock.wait_for(
                                    lambda: viewer._jpeg_seq != seq
                                    or viewer._closed,
                                    timeout=2.0,
                                )
                                if viewer._closed:
                                    return
                                jpeg, seq = viewer._jpeg, viewer._jpeg_seq
                            if jpeg is None:
                                continue
                            self.wfile.write(
                                b"--pgtpuframe\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                            )
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self._send(404, "text/plain", b"not found")

        self._closed = False
        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def publish_frame(self, bgr: np.ndarray):
        """Encode and publish one overlay frame (BGR uint8). Needs cv2."""
        import cv2

        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 80])
        if not ok:
            return
        with self._lock:
            self._jpeg = buf.tobytes()
            self._jpeg_seq += 1
            self._lock.notify_all()

    def publish_state(self, tracker, frame_id: int, state, inliers: int):
        """Snapshot the tracker's map (MapDrawer's view): keyframe camera
        centres and axes, and a subsampled world point cloud."""
        valid = np.asarray(tracker.point_valid)
        pts = np.asarray(tracker.points)[valid]
        if len(pts) > self._max_cloud:
            step = -(-len(pts) // self._max_cloud)
            pts = pts[::step]
        centers = []
        axes = []
        for kf in tracker.keyframes:
            r, t = kf.pose6[:3], kf.pose6[3:]
            rot = _rotvec_matrix(np.asarray(r, np.float64))
            centers.append((-rot.T @ np.asarray(t, np.float64)).tolist())
            # Camera axes in world coordinates: with x_cam = R x + t the
            # camera's k-th axis is R^T e_k, the k-th row of R; the page
            # draws each keyframe's frustum from them (MapDrawer::DrawKeyFrames).
            axes.append(np.round(rot, 4).tolist())
        snapshot = {
            "frame_id": int(frame_id),
            "state": str(state),
            "inliers": int(inliers),
            "map_points": int(valid.sum()),
            "keyframes": len(tracker.keyframes),
            "points": np.round(pts, 4).tolist(),
            "keyframe_centers": [
                [round(v, 4) for v in c] for c in centers
            ],
            "keyframe_axes": axes,
        }
        with self._lock:
            self._state = snapshot

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()


def _rotvec_matrix(r: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation vector -> matrix (host numpy, viewer only)."""
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)
