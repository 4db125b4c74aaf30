"""Reconstruction service: HTTP frontend over the DISINF/DenseSLAM stack.

Production-facing analogue of the reference's ROS topic surface
(ros_offline.cc subscribers/publishers) for environments without ROS:
clients stream RGB-D frames and pull poses, bbox voxel queries, meshes,
and rendered views.  Payloads are npz/np binary (no external
dependencies; stdlib http.server with a worker thread pool of 1 —
reconstruction itself is serialized by the TSDF queue anyway).

Endpoints:
  POST /frame   npz{rgb, depth, timestamp_ms[, ht, lt, pose]} -> {pose, ok}
  GET  /pose?t=MS                -> npz{pose}
  GET  /pose_json?t=MS           -> json{pose: [16 floats]}
  GET  /stats                    -> json
  GET  /query?bbox=x0,x1,y0,y1,z0,z1 -> npz{records [N,4]}
  GET  /query_json?bbox=...      -> json{count}
  GET  /mesh                     -> npz{verts, faces}
  GET  /render?fx=..&w=..&h=..[&pose=16csv&view=rgba|normal&fmt=png]
                                 -> npz{rgba, normal, depth} or image/png
  GET  / (or /view)              -> interactive browser viewer (arcball
                                    orbit/zoom/pan, follow-cam,
                                    Start/Pause/Step replay, bbox query —
                                    the renderer_module.cc:20-102 parity
                                    surface)
  GET  /ctrl?cmd=start|pause|step|status -> json replay status
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..ops.gather import BoundingCube


class ReconstructionService:
    """Wraps either a DISINFSystem (poses provided) or DenseSLAM
    (self-tracking) behind frame-in / artifacts-out methods."""

    def __init__(self, system, mode: str = "disinf",
                 auto_recenter: bool = False):
        self.system = system
        self.mode = mode
        self.auto_recenter = auto_recenter
        self._lock = threading.Lock()
        self.frames = 0

    def process_frame(self, rgb, depth, timestamp_ms, ht=None, lt=None, pose=None):
        with self._lock:
            self.frames += 1
            if self.mode == "slam":
                # waypoint-cadence window follow (each check syncs on the
                # tracked pose, so not per frame; DISINFSystem handles
                # its own recentering in disinf mode)
                if self.auto_recenter and self.frames % 30 == 0:
                    self.system.maybe_recenter()
                est, ok = self.system.process_frame(rgb, depth, ht, lt)
                return est, bool(ok)
            if pose is not None:
                self.system.feed_pose(int(timestamp_ms), pose)
            self.system.feed_rgbd_frame(rgb, depth, int(timestamp_ms))
            return self.system.query_camera_pose(int(timestamp_ms)), True

    def pose(self, timestamp_ms):
        if self.mode == "slam":
            return np.linalg.inv(self.system.world_T_cam)
        return self.system.query_camera_pose(int(timestamp_ms))

    def _volume(self):
        if self.mode == "slam":
            return self.system.volume
        self.system.tsdf.flush()
        return self.system.tsdf.tsdf.snapshot()

    def stats(self):
        # drain the queue, then read the counter under the grid lock —
        # but skip the full volume snapshot _volume() would take: stats
        # is the viewer's liveness probe and must stay cheap
        if self.mode == "slam":
            vol = self.system.volume
            count = int(vol.num_active_blocks)
            vsz = vol.cfg.voxel_size
        else:
            self.system.tsdf.flush()
            grid = self.system.tsdf.tsdf
            count = grid.num_active_blocks()
            vsz = grid.cfg.voxel_size
        out = {
            "frames": self.frames,
            "active_blocks": count,
            "voxel_size": vsz,
            "mode": self.mode,
        }
        store = getattr(
            self.system if self.mode == "slam" else self.system.tsdf.tsdf,
            "spill_store", None,
        )
        if store is not None:
            out["spilled_blocks"] = len(store)
            out["spilled_bytes"] = store.nbytes()
        return out

    def query(self, bbox: BoundingCube):
        from ..ops.gather import gather_voxels, to_numpy_records

        return to_numpy_records(gather_voxels(self._volume(), bbox))

    def mesh(self):
        from ..ops.mesh import extract_mesh_chunked, merge_vertices

        tris = extract_mesh_chunked(self._volume())
        return merge_vertices(tris)

    def render(self, fx, img_h, img_w, pose=None, max_depth=10.0):
        import jax.numpy as jnp

        from ..core.geometry import SE3, CameraIntrinsics, CameraParams
        from ..ops.render_fast import splat_render

        if pose is None:
            pose = self.pose(0)
        cam = CameraParams.create(
            CameraIntrinsics.create(fx, fx, (img_w - 1) / 2, (img_h - 1) / 2),
            img_h, img_w,
        )
        res = splat_render(
            self._volume(), cam, SE3.from_matrix(jnp.asarray(pose)), max_depth,
        )
        return (
            np.asarray(res.rgba),
            np.asarray(res.normal),
            np.asarray(res.depth),
        )


class ReplayDriver:
    """Start/Pause/Step control over a frame replay feeding the service —
    the offline.cc:139-155 Start/Pause loop, controllable over HTTP.

    `frames` is a sequence of (rgb, depth, timestamp_ms, ht, lt, pose)
    tuples (ht/lt/pose may be None).  fps > 0 throttles playback."""

    def __init__(self, service: ReconstructionService, frames, fps: float = 0.0):
        self.service = service
        self.frames = list(frames)
        self.fps = fps
        self.idx = 0
        self._playing = threading.Event()
        self._steps = 0
        self._stop = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import time

        while not self._stop:
            with self._lock:
                want = self._playing.is_set() or self._steps > 0
                if want and self._steps > 0:
                    self._steps -= 1
            if not want or self.idx >= len(self.frames):
                time.sleep(0.05)
                continue
            rgb, depth, ts, ht, lt, pose = self.frames[self.idx]
            t0 = time.perf_counter()
            self.service.process_frame(rgb, depth, ts, ht, lt, pose)
            self.idx += 1
            if self.fps > 0:
                budget = 1.0 / self.fps - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)

    def start(self):
        self._playing.set()

    def pause(self):
        self._playing.clear()

    def step(self):
        with self._lock:
            self._steps += 1

    def shutdown(self):
        self._stop = True
        self._playing.clear()

    def status(self) -> dict:
        return {
            "playing": self._playing.is_set(),
            "frame": self.idx,
            "total": len(self.frames),
            "done": self.idx >= len(self.frames),
        }


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def make_server(
    service: ReconstructionService,
    host="127.0.0.1",
    port=0,
    replay: "ReplayDriver | None" = None,
):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if urlparse(self.path).path != "/frame":
                return self._send(404, b"not found", "text/plain")
            n = int(self.headers.get("Content-Length", 0))
            data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
            pose, ok = service.process_frame(
                data["rgb"],
                data["depth"],
                int(data["timestamp_ms"]),
                data["ht"] if "ht" in data else None,
                data["lt"] if "lt" in data else None,
                data["pose"] if "pose" in data else None,
            )
            self._send(200, _npz_bytes(pose=pose, ok=np.asarray(ok)))

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path in ("/", "/view"):
                from ..viz.viewer_html import VIEWER_HTML

                self._send(200, VIEWER_HTML.encode(), "text/html; charset=utf-8")
            elif url.path == "/stats":
                stats = service.stats()
                if replay is not None:
                    stats["replay"] = replay.status()
                self._send(200, json.dumps(stats).encode(), "application/json")
            elif url.path == "/ctrl":
                cmd = q.get("cmd", ["status"])[0]
                if replay is None:
                    self._send(400, b'{"error": "no replay attached"}',
                               "application/json")
                    return
                if cmd == "start":
                    replay.start()
                elif cmd == "pause":
                    replay.pause()
                elif cmd == "step":
                    replay.step()
                self._send(
                    200, json.dumps(replay.status()).encode(), "application/json"
                )
            elif url.path == "/pose":
                t = int(q.get("t", ["0"])[0])
                self._send(200, _npz_bytes(pose=service.pose(t)))
            elif url.path == "/pose_json":
                t = int(q.get("t", ["0"])[0])
                pose = np.asarray(service.pose(t), np.float64).reshape(-1)
                self._send(
                    200,
                    json.dumps({"pose": [float(x) for x in pose]}).encode(),
                    "application/json",
                )
            elif url.path == "/query":
                vals = [float(x) for x in q["bbox"][0].split(",")]
                rec = service.query(BoundingCube(*vals))
                self._send(200, _npz_bytes(records=rec))
            elif url.path == "/query_json":
                vals = [float(x) for x in q["bbox"][0].split(",")]
                rec = service.query(BoundingCube(*vals))
                self._send(
                    200, json.dumps({"count": int(len(rec))}).encode(),
                    "application/json",
                )
            elif url.path == "/mesh":
                verts, faces = service.mesh()
                self._send(200, _npz_bytes(verts=verts, faces=faces))
            elif url.path == "/render":
                fx = float(q.get("fx", ["525"])[0])
                w = int(q.get("w", ["640"])[0])
                h = int(q.get("h", ["360"])[0])
                pose = None
                if "pose" in q:
                    vals = [float(x) for x in q["pose"][0].split(",")]
                    pose = np.asarray(vals, np.float32).reshape(4, 4)
                rgba, normal, depth = service.render(fx, h, w, pose=pose)
                if q.get("fmt", ["npz"])[0] == "png":
                    from ..io.png_io import encode_png

                    img = rgba if q.get("view", ["normal"])[0] == "rgba" else normal
                    self._send(200, encode_png(np.asarray(img)), "image/png")
                else:
                    self._send(
                        200, _npz_bytes(rgba=rgba, normal=normal, depth=depth)
                    )
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)
