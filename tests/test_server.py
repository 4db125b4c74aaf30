"""Reconstruction service test: stream frames over HTTP, pull pose,
stats, bbox query, mesh, and renders."""

import io
import json
import threading
import urllib.request

import numpy as np

from disinfect_slam.systems.disinf_system import DISINFSystem
from disinfect_slam.systems.server import ReconstructionService, make_server

from .scenes import look_at, render_wall
from .test_integrate import CFG_DENSE, H, K, W


def _post_npz(url, **arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def _get(url):
    with urllib.request.urlopen(url, timeout=240) as r:
        body = r.read()
    if r.headers.get("Content-Type") == "application/json":
        return json.loads(body)
    return np.load(io.BytesIO(body))


def test_http_service_roundtrip():
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    rgb = np.full((H, W, 3), 120, np.float32)

    with DISINFSystem(
        K, depth_factor=1.0, voxel_size=0.05, truncation=0.15,
        cfg=CFG_DENSE, half_scale=False,
    ) as system:
        svc = ReconstructionService(system, mode="disinf")
        httpd = make_server(svc)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{port}"
        try:
            out = _post_npz(
                f"{base}/frame", rgb=rgb, depth=depth,
                timestamp_ms=np.asarray(0), pose=pose,
            )
            assert bool(out["ok"])
            np.testing.assert_allclose(out["pose"], pose, atol=1e-5)

            stats = _get(f"{base}/stats")
            assert stats["frames"] == 1 and stats["active_blocks"] > 10

            rec = _get(f"{base}/query?bbox=-2,2,-2,2,0,3")["records"]
            assert rec.shape[1] == 4 and len(rec) > 100

            mesh = _get(f"{base}/mesh")
            assert len(mesh["verts"]) > 50 and len(mesh["faces"]) > 50

            r = _get(f"{base}/render?fx=52.7&w=64&h=48")
            assert r["rgba"].shape == (48, 64, 4)
            assert (r["depth"] > 0).mean() > 0.1
        finally:
            httpd.shutdown()


def test_viewer_page_and_interactive_render():
    """The browser-viewer surface: HTML page, explicit-pose PNG render,
    pose_json/query_json, and Start/Pause/Step replay control
    (renderer_module.cc:20-102 parity)."""
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    rgb = np.full((H, W, 3), 120, np.float32)
    frames = [
        (rgb, depth, i * 33, None, None, pose) for i in range(3)
    ]

    from disinfect_slam.systems.server import ReplayDriver

    with DISINFSystem(
        K, depth_factor=1.0, voxel_size=0.05, truncation=0.15,
        cfg=CFG_DENSE, half_scale=False,
    ) as system:
        svc = ReconstructionService(system, mode="disinf")
        replay = ReplayDriver(svc, frames)
        httpd = make_server(svc, replay=replay)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{port}"
        try:
            with urllib.request.urlopen(f"{base}/view", timeout=30) as r:
                page = r.read().decode()
            assert "<html" in page.lower() and "arcball" in page.lower()

            # replay control: step one frame, then play out the rest
            st = _get(f"{base}/ctrl?cmd=step")
            assert st["total"] == 3
            import time

            for _ in range(300):
                if _get(f"{base}/ctrl?cmd=status")["frame"] >= 1:
                    break
                time.sleep(0.05)
            assert _get(f"{base}/ctrl?cmd=status")["frame"] == 1
            _get(f"{base}/ctrl?cmd=start")
            for _ in range(600):
                if _get(f"{base}/ctrl?cmd=status")["done"]:
                    break
                time.sleep(0.05)
            assert _get(f"{base}/ctrl?cmd=status")["done"]
            _get(f"{base}/ctrl?cmd=pause")
            stats = _get(f"{base}/stats")
            assert stats["frames"] == 3 and stats["replay"]["done"]

            # explicit virtual-camera pose render as PNG (the viewer's
            # orbit request)
            pose_csv = ",".join(str(float(x)) for x in np.asarray(pose).ravel())
            with urllib.request.urlopen(
                f"{base}/render?fx=52.7&w=64&h=48&fmt=png&view=normal&pose={pose_csv}",
                timeout=120,
            ) as r:
                png = r.read()
            assert png[:8] == b"\x89PNG\r\n\x1a\n"

            pj = _get(f"{base}/pose_json?t=66")
            assert len(pj["pose"]) == 16
            qj = _get(f"{base}/query_json?bbox=-2,2,-2,2,0,3")
            assert qj["count"] > 100
        finally:
            replay.shutdown()
            httpd.shutdown()
