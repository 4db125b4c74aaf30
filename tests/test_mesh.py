"""Mesh extraction tests: sphere isosurface geometry + weld/export."""

import os

import numpy as np
import pytest

from disinfect_slam.ops.mesh import (
    compact_mesh,
    extract_mesh,
    merge_vertices,
    save_obj,
)

from .scenes import look_at, render_sphere
from .test_integrate import CFG, H, K, W, make_frame
from .test_raycast import fuse_frames

CENTER = np.array([0.013, -0.021, 1.007])
RADIUS = 0.613


@pytest.fixture(scope="module")
def sphere_vol():
    frames = []
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, 8, endpoint=False)):
        eye = CENTER + np.array([np.sin(ang) * 2.5, 0.05, -np.cos(ang) * 2.5])
        pose = look_at(eye, CENTER)
        depth = render_sphere(W, H, K, pose, center=CENTER, radius=RADIUS)
        frames.append((make_frame(depth), pose))
    vol, _ = fuse_frames(frames)
    return vol


def test_sphere_mesh_radius(sphere_vol):
    mesh = extract_mesh(sphere_vol, max_tris=1 << 17)
    tris = compact_mesh(mesh)
    assert tris.shape[0] > 500
    centroids = tris.mean(axis=1)
    r = np.linalg.norm(centroids - CENTER, axis=-1)
    # vertices lie on the sphere within ~1.5 voxels
    assert abs(np.median(r) - RADIUS) < 1.5 * CFG.voxel_size
    assert np.percentile(np.abs(r - RADIUS), 90) < 3 * CFG.voxel_size


def test_mesh_triangles_nondegenerate(sphere_vol):
    tris = compact_mesh(extract_mesh(sphere_vol, max_tris=1 << 17))
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    assert (area > 0).mean() > 0.99


def test_mesh_normals_outward(sphere_vol):
    """Winding consistency: triangle normals should point away from the
    sphere center (tsdf > 0 outside)."""
    tris = compact_mesh(extract_mesh(sphere_vol, max_tris=1 << 17))
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    nn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    outward = (tris.mean(1) - CENTER)
    outward /= np.maximum(np.linalg.norm(outward, axis=-1, keepdims=True), 1e-12)
    agree = (np.sum(nn * outward, axis=-1) > 0).mean()
    assert agree > 0.9, agree


def test_merge_vertices_and_obj(tmp_path, sphere_vol):
    tris = compact_mesh(extract_mesh(sphere_vol, max_tris=1 << 17))
    verts, faces = merge_vertices(tris)
    assert len(verts) < tris.shape[0] * 3  # welding actually merged
    assert faces.max() < len(verts)
    path = os.path.join(tmp_path, "mesh.obj")
    save_obj(path, verts, faces)
    txt = open(path).read().splitlines()
    assert sum(1 for l in txt if l.startswith("v ")) == len(verts)
    assert sum(1 for l in txt if l.startswith("f ")) == len(faces)


def test_chunked_extraction_matches_single_shot(sphere_vol):
    from disinfect_slam.ops.mesh import extract_mesh_chunked

    tris_single = compact_mesh(extract_mesh(sphere_vol, max_tris=1 << 17))
    tris_chunked = extract_mesh_chunked(sphere_vol, chunk=16)
    assert tris_chunked.shape[0] == tris_single.shape[0]

    def sort(t):
        flat = t.reshape(len(t), -1)
        return t[np.lexsort(flat.T[::-1])]

    np.testing.assert_allclose(sort(tris_chunked), sort(tris_single), atol=1e-5)


def test_chunked_clip_warning_fires(sphere_vol, caplog):
    """Per-chunk triangle caps must WARN when they clip (round-1 shipped
    a silent 79% drop at bench scale — never again)."""
    import logging

    from disinfect_slam.ops.mesh import extract_mesh_chunked

    with caplog.at_level(logging.WARNING):
        tris_small = extract_mesh_chunked(
            sphere_vol, max_tris_per_chunk=256, chunk=64)
    assert any("clipped" in r.message for r in caplog.records)
    tris_full = extract_mesh_chunked(sphere_vol)
    assert len(tris_full) > len(tris_small)


def test_chunked_q16_transfer_matches_f32(sphere_vol):
    """The uint16 fixed-point D2H mode must reproduce the f32 mesh to
    within its documented half-step (voxel/32) and keep every triangle."""
    from disinfect_slam.ops.mesh import extract_mesh_chunked

    tris_f32 = extract_mesh_chunked(sphere_vol, chunk=16)
    tris_q16 = extract_mesh_chunked(sphere_vol, chunk=16, transfer="q16")
    assert tris_q16.shape == tris_f32.shape

    # both modes emit triangles in the same deterministic chunk order,
    # so rows correspond 1:1 — compare directly (sorting would pair
    # different triangles once coordinates move by the quantization)
    step = sphere_vol.cfg.voxel_size / 16.0
    np.testing.assert_allclose(tris_q16, tris_f32, atol=step / 2 + 1e-6)
