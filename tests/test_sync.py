"""Stream synchronizer tests (the reference's topic-pairing semantics)."""

from disinfect_slam.io.sync import (
    ApproximateTimeSynchronizer,
    RGBDPairer,
    StereoPairer,
)


def test_stereo_pairing_within_slop():
    pairs = []
    s = StereoPairer(lambda ts, l, r: pairs.append((ts, l, r)))
    s.push(0, 100.0, "L0")
    s.push(1, 104.0, "R0")  # within 10 ms
    assert pairs == [(100.0, "L0", "R0")]
    s.push(0, 200.0, "L1")
    s.push(1, 215.0, "R1")  # outside 10 ms -> no pair
    assert len(pairs) == 1


def test_out_of_order_and_skips():
    pairs = []
    s = ApproximateTimeSynchronizer(2, lambda ts, a, b: pairs.append((ts, a, b)),
                                    slop_ms=5)
    # stream 1 runs ahead; stream 0 catches up later
    s.push(1, 100.0, "b0")
    s.push(1, 133.0, "b1")
    s.push(0, 134.0, "a1")  # should pair with b1, b0 consumed/skipped
    assert pairs and pairs[0][1] == "a1" and pairs[0][2] == "b1"


def test_rgbd_pairer_slop():
    pairs = []
    p = RGBDPairer(lambda ts, rgb, d: pairs.append(ts))
    p.push(0, 1000.0, "rgb")
    p.push(1, 1040.0, "depth")  # 40 ms < 50 ms
    assert len(pairs) == 1


def test_horizon_expiry():
    pairs = []
    s = ApproximateTimeSynchronizer(2, lambda *a: pairs.append(a),
                                    slop_ms=5, horizon_ms=100)
    s.push(0, 0.0, "old")
    s.push(0, 500.0, "new")  # expires "old"
    s.push(1, 501.0, "match")
    assert len(pairs) == 1
    assert pairs[0][1] == "new"
    assert s.dropped >= 1
