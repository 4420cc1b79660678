"""The yardstick's counts: the fused sweep's shapes, bytes and operations
against the program's strip plan, and the issue rate they are held to."""

import pytest

from benchmark import counts, harness


def test_the_minmax_issue_rate_is_the_h100s():
    # 132 SMs x 64 integer min/max a clock x 1.98 GHz
    assert counts.PEAK_MINMAX_ISSUE == pytest.approx(16.727e12, rel=1e-4)


@pytest.mark.parametrize("traffic,n,r,w", [("gtsdb_b32", 64, 408, 684),
                                           ("hd1080_b32", 64, 552, 964)])
def test_k3_shape_and_bytes_follow_the_frames(traffic, n, r, w):
    config = harness.load("configs", "mser_tuned")
    mix = harness.load("traffic", traffic)
    s = counts.k3_shape(config, mix)
    assert (s["n"], s["r"], s["w"], s["core"]) == (n, r, w, r)
    assert (s["levels"], s["passes"]) == (31, 4)
    assert counts.k3_bytes(s) == n * r * w * 5
    assert counts.k3_ops(s) == n * r * w * 31 * 4 * 6
    bound, by = counts.k3_bound_s(config, mix)
    assert by == "ops" and bound == pytest.approx(counts.k3_ops(s) / counts.PEAK_MINMAX_ISSUE)
    doubled = counts.k3_shape(config, {**mix, "batch": 2 * mix["batch"]})
    assert counts.k3_bytes(doubled) == 2 * counts.k3_bytes(s)


@pytest.mark.parametrize("traffic", ["gtsdb_b32", "hd1080_b32"])
def test_k3_shape_is_the_programs_strip_plan(traffic):
    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig
    from opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda import plan_halo, sweep_plan

    config = harness.load("configs", "mser_tuned")
    mix = harness.load("traffic", traffic)
    sub = MSERConfig(max_area=config["max_area"] // 4, min_area=config["min_area"] // 4)
    h, w = mix["height"] // 2 + 2, mix["width"] // 2 + 2
    n_strips, core, halo = sweep_plan(h, w, config["topk_pool"], plan_halo(sub))
    s = counts.k3_shape(config, mix)
    assert (s["n"], s["r"], s["core"]) == (mix["batch"] * 2 * n_strips, core + 2 * halo, core)
