"""System-layer tests: pose manager (python + native), TSDF system queue
semantics, DISINF facade, native frame queue."""


import numpy as np
import pytest

from disinfect_slam.systems.pose_manager import PoseManager

from .scenes import look_at


def se3(tx, ty, tz):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = (tx, ty, tz)
    return m


class TestPoseManager:
    def test_empty_returns_identity(self):
        pm = PoseManager()
        np.testing.assert_array_equal(pm.query_pose(100), np.eye(4, dtype=np.float32))

    def test_nearest_pick_reference_semantics(self):
        # pose_manager.cc:36-43 nearest-neighbor behavior
        pm = PoseManager(interpolate=False)
        pm.register_valid_pose(100, se3(1, 0, 0))
        pm.register_valid_pose(200, se3(2, 0, 0))
        assert pm.query_pose(140)[0, 3] == 1.0
        assert pm.query_pose(160)[0, 3] == 2.0
        # past-the-end returns last (pose_manager.cc:24-27)
        assert pm.query_pose(999)[0, 3] == 2.0

    def test_slerp_interpolation(self):
        pm = PoseManager(interpolate=True)
        pm.register_valid_pose(0, se3(0, 0, 0))
        pm.register_valid_pose(100, se3(1, 0, 0))
        p = pm.query_pose(50)
        assert abs(p[0, 3] - 0.5) < 1e-6

    def test_rotation_slerp(self):
        from scipy.spatial.transform import Rotation

        pm = PoseManager(interpolate=True)
        m0 = np.eye(4)
        m1 = np.eye(4)
        m1[:3, :3] = Rotation.from_euler("y", 90, degrees=True).as_matrix()
        pm.register_valid_pose(0, m0)
        pm.register_valid_pose(100, m1)
        p = pm.query_pose(50)
        ang = Rotation.from_matrix(p[:3, :3]).magnitude() * 180 / np.pi
        assert abs(ang - 45) < 1.0


class TestNativeRuntime:
    def test_native_pose_buffer_matches_python(self):
        from disinfect_slam.native import runtime as rt

        if not rt.available():
            pytest.skip("native toolchain unavailable")
        nb = rt.NativePoseBuffer(interpolate=False)
        pb = PoseManager(interpolate=False)
        rng = np.random.default_rng(0)
        for i in range(20):
            m = se3(*rng.uniform(-1, 1, 3))
            nb.register_valid_pose(i * 100, m)
            pb.register_valid_pose(i * 100, m)
        for t in [0, 55, 140, 950, 1990, 5000]:
            np.testing.assert_allclose(
                nb.query_pose(t), pb.query_pose(t), atol=1e-6
            )

    def test_native_pose_buffer_slerp(self):
        from disinfect_slam.native import runtime as rt

        if not rt.available():
            pytest.skip("native toolchain unavailable")
        nb = rt.NativePoseBuffer(interpolate=True)
        nb.register_valid_pose(0, se3(0, 0, 0))
        nb.register_valid_pose(100, se3(2, 0, 0))
        assert abs(nb.query_pose(50)[0, 3] - 1.0) < 1e-6

    def test_native_frame_queue(self):
        from disinfect_slam.native import runtime as rt

        if not rt.available():
            pytest.skip("native toolchain unavailable")
        q = rt.NativeFrameQueue(capacity=3)
        assert q.pop(timeout_ms=10) is None
        for i in range(5):
            q.push(i, bytes([i] * 4))
        assert q.depth() == 3
        assert q.dropped() == 2  # drop-oldest backpressure
        ts, blob = q.pop()
        assert ts == 2 and blob == bytes([2] * 4)
        q.close()


class TestTSDFSystem:
    def test_async_integration_and_query(self):
        import jax

        from disinfect_slam.config import TSDFConfig
        from disinfect_slam.ops.gather import BoundingCube
        from disinfect_slam.systems.tsdf_system import TSDFSystem

        from .scenes import render_wall
        from .test_integrate import CFG, H, K, W

        sys_ = TSDFSystem(0.05, 0.15, 4.0, K, cfg=CFG)
        pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
        depth = render_wall(W, H, K, pose, wall_z=2.0131)
        rgb = np.full((H, W, 3), 128, np.float32)
        for _ in range(2):
            sys_.integrate(pose, rgb, depth)
        sys_.flush()
        assert sys_.tsdf.num_active_blocks() > 10
        st = sys_.query(BoundingCube(-2, 2, -2, 2, 0, 3))
        assert int(st.count) > 0
        sys_.terminate()

    def test_missing_masks_default_to_ones(self):
        # tsdf_module.cc:32-33 behavior is in TSDFSystem.integrate
        import jax

        from disinfect_slam.systems.tsdf_system import TSDFSystem

        from .scenes import render_wall
        from .test_integrate import CFG, H, K, W

        sys_ = TSDFSystem(0.05, 0.15, 4.0, K, cfg=CFG)
        pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
        depth = render_wall(W, H, K, pose, wall_z=2.0131)
        rgb = np.full((H, W, 3), 128, np.float32)
        sys_.integrate(pose, rgb, depth)  # no ht/lt
        sys_.flush()
        vol = sys_.tsdf.volume
        live = np.asarray(vol.entry_block) >= 0
        pool = np.asarray(vol.entry_block)[live]
        w = np.asarray(vol.weight)[pool]
        p = np.asarray(vol.prob)[pool]
        np.testing.assert_allclose(p[w > 0], 0.5, atol=1e-5)
        sys_.terminate()


class TestDISINFSystem:
    def test_facade_pipeline(self):
        from disinfect_slam.ops.gather import BoundingCube
        from disinfect_slam.systems.disinf_system import DISINFSystem

        from .scenes import render_wall
        from .test_integrate import CFG, H, K, W

        # feed full-res frames; facade half-scales (disinfect_slam.cc:37-43)
        K2 = tuple(2 * k for k in K)
        pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
        depth = render_wall(W * 2, H * 2, K2, pose, wall_z=2.0131)
        rgb = np.full((H * 2, W * 2, 3), 100, np.float32)

        with DISINFSystem(
            K, depth_factor=1000.0, voxel_size=0.05, truncation=0.15, cfg=CFG
        ) as sys_:
            sys_.feed_pose(100, pose)
            sys_.feed_rgbd_frame(rgb, depth * 1000.0, 100)
            sys_.tsdf.flush()
            assert sys_.tsdf.tsdf.num_active_blocks() > 10
            st = sys_.query_tsdf(BoundingCube(-2, 2, -2, 2, 0, 3))
            assert int(st.count) > 0
            got = sys_.query_camera_pose(100)
            np.testing.assert_allclose(got, pose, atol=1e-5)


class TestConcurrency:
    def test_concurrent_producers_and_readers(self):
        """Multiple producer threads + concurrent query/render must not
        race the functional volume state (the lock-free analogue of the
        reference's mtx_queue_/mtx_read_ discipline)."""
        import threading

        from disinfect_slam.ops.gather import BoundingCube
        from disinfect_slam.systems.tsdf_system import TSDFSystem

        from .scenes import render_wall
        from .test_integrate import CFG_DENSE, H, K, W

        sys_ = TSDFSystem(0.05, 0.15, 4.0, K, cfg=CFG_DENSE)
        rgb = np.full((H, W, 3), 128, np.float32)
        errors = []

        def produce(seed):
            try:
                pose = look_at((0.01 * seed, 0.02, -0.01), (0.04, -0.03, 2.0))
                depth = render_wall(W, H, K, pose, wall_z=2.0131 + 0.01 * seed)
                for _ in range(3):
                    sys_.integrate(pose, rgb, depth)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def read():
            try:
                for _ in range(5):
                    st = sys_.query(BoundingCube(-2, 2, -2, 2, 0, 3))
                    int(st.count)
                    sys_.render((K, H, W), np.eye(4, dtype=np.float32))
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=produce, args=(i,)) for i in range(3)]
        threads += [threading.Thread(target=read) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        sys_.flush()
        assert not errors, errors
        assert sys_.tsdf.num_active_blocks() > 10
        sys_.terminate()


def test_grid_debug_stats_path_matches_plain():
    """The debug (stats) integrate path — which also reports the
    visible count — must produce the identical volume as the plain
    path."""
    import logging

    from disinfect_slam.systems.tsdf_grid import TSDFGrid

    from .scenes import look_at, render_sphere
    from .test_integrate import CFG_DENSE, H, K, W, make_frame

    def run(debug):
        g = TSDFGrid(0.05, 0.15, cfg=CFG_DENSE)
        lg = logging.getLogger("disinfect_slam.tsdf_grid")
        old = lg.level
        lg.setLevel(logging.DEBUG if debug else logging.INFO)
        try:
            for ang in (0.0, 0.15, 0.3):
                pose = look_at((np.sin(ang) * 1.6, 0, 1.3 - 1.6 * np.cos(ang)),
                               (0.0, 0.0, 1.3))
                d = render_sphere(W, H, K, pose, center=(0.0, 0.0, 1.3), radius=0.4)
                f = make_frame(d.astype(np.float32))
                g.integrate(f.rgb, f.depth, f.ht, f.lt, 4.0, K, pose)
            g.block_until_ready()
        finally:
            lg.setLevel(old)
        return g

    plain = run(False)
    stats = run(True)
    assert plain.num_active_blocks() == stats.num_active_blocks()
    np.testing.assert_array_equal(
        np.asarray(plain.volume.tsdf), np.asarray(stats.volume.tsdf)
    )
