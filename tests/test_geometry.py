"""SE3 / intrinsics parity tests (vs utils/cuda/lie_group.cuh, camera.cuh)."""

import jax.numpy as jnp
import numpy as np

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams


def random_se3(rng):
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    t = rng.standard_normal(3)
    w, x, y, z = q
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


def test_identity():
    pts = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    out = SE3.identity().apply(jnp.asarray(pts))
    np.testing.assert_allclose(np.asarray(out), pts, atol=1e-6)


def test_from_matrix_apply():
    rng = np.random.default_rng(1)
    m = random_se3(rng)
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    se3 = SE3.from_matrix(m)
    expected = pts @ m[:3, :3].T + m[:3, 3]
    np.testing.assert_allclose(np.asarray(se3.apply(jnp.asarray(pts))), expected, atol=1e-4)
    # matrix round-trip
    np.testing.assert_allclose(np.asarray(se3.matrix()), m, atol=1e-5)


def test_inverse_compose():
    rng = np.random.default_rng(2)
    a = SE3.from_matrix(random_se3(rng))
    b = SE3.from_matrix(random_se3(rng))
    pts = jnp.asarray(rng.standard_normal((50, 3)).astype(np.float32))
    # inverse: T^-1(T(x)) = x  (lie_group.cuh:25-27)
    np.testing.assert_allclose(
        np.asarray(a.inverse().apply(a.apply(pts))), np.asarray(pts), atol=1e-4
    )
    # composition: (a*b)(x) = a(b(x))  (lie_group.cuh:38-40)
    np.testing.assert_allclose(
        np.asarray((a @ b).apply(pts)), np.asarray(a.apply(b.apply(pts))), atol=1e-4
    )


def test_intrinsics_inverse():
    # closed-form inverse (camera.cuh:35-39): K_inv * K * p == p
    k = CameraIntrinsics.create(520.9, 521.0, 325.1, 249.7)
    k_inv = k.inverse()
    pts = jnp.asarray(
        np.random.default_rng(3).uniform(0.1, 5.0, (20, 3)).astype(np.float32)
    )
    proj = k.project(pts)
    # unproject homogeneous pixel (u, v, 1) scaled by z
    uv1 = proj / proj[:, 2:3]
    back = k_inv.project(uv1) * proj[:, 2:3]
    np.testing.assert_allclose(np.asarray(back), np.asarray(pts), rtol=1e-4, atol=1e-4)


def test_projection_formula():
    # project (camera.cuh:48-51): (fx*x + cx*z, fy*y + cy*z, z)
    k = CameraIntrinsics.create(100.0, 200.0, 320.0, 240.0)
    p = k.project(jnp.array([[1.0, 2.0, 4.0]]))
    np.testing.assert_allclose(
        np.asarray(p)[0], [100 * 1 + 320 * 4, 200 * 2 + 240 * 4, 4.0], atol=1e-5
    )


def test_camera_params_static_size():
    k = CameraIntrinsics.create(1.0, 1.0, 0.0, 0.0)
    cam = CameraParams.create(k, 480, 640)
    assert cam.img_h == 480 and cam.img_w == 640
    assert isinstance(cam.img_h, int)
