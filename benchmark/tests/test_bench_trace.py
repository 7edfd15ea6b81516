"""The reduction of a traced block and the per-layer readers, on a made-up
trace (a CPU run records no device work)."""

import pytest

from benchmark import manifest, trace as tracing


def _trace(n=262144):
    dev = [("void (anonymous namespace)::near_field_kernel<8, 32>(float4 const*)", 0.000, 0.004),
           ("near_combine_kernel(float4 const*)", 0.004, 0.005),
           ("far_octet_kernel(float4 const*)", 0.006, 0.008),
           ("void at::native::elementwise_kernel<128>()", 0.010, 0.011),
           ("Memcpy DtoH (Device -> Pageable)", 0.011, 0.0112),
           ("allpairs_kernel(float const*)", 0.012, 0.052),
           ("allpairs_combine_kernel(float4 const*)", 0.052, 0.053)]
    host = [("aten::nonzero", 0.0085, 0.0098),
            ("cudaStreamSynchronize", 0.0086, 0.0087),
            ("cudaLaunchKernel", 0.0099, 0.0100)]
    calls = {"cudaLaunchKernel": 6, "cudaMemcpyAsync": 1,
             "cudaStreamSynchronize": 1}
    return tracing.Trace(dev, host, calls, (0.0, 0.055), steps=2,
                         n=n, hand_kernels=frozenset(
                             {"near_field_kernel", "near_combine_kernel",
                              "far_octet_kernel", "allpairs_kernel",
                              "allpairs_combine_kernel"}), step_s=0.03)


def test_busy_window_and_sums():
    t = _trace()
    assert t.window_s == pytest.approx(0.055)
    assert t.busy_s == pytest.approx(0.005 + 0.002 + 0.0012 + 0.041)
    assert t.device_s(("near_field_kernel",)) == pytest.approx(0.004)
    assert t.device_s(exclude=t.hand_kernels) == pytest.approx(0.0012)


def test_readers():
    t = _trace()

    def read(name):
        return manifest.load_metric(name).read(t)

    assert read("idle_share") == pytest.approx(1 - t.busy_s / 0.055)
    assert read("launches_per_step") == pytest.approx(3.5)
    assert read("torch_ops_ms_per_step") == pytest.approx(0.6)
    least = 262144.0 ** 2 * 18 / 67e12
    assert read("k3_roofline") == pytest.approx(100 * least / 0.0205)
    assert read("step_mfu") == pytest.approx(100 * least / 0.03)


def test_readers_find_nothing_to_read():
    t = _trace()
    t.device = [r for r in t.device if "kernel" not in r[0]
                or "elementwise" in r[0]]
    assert manifest.load_metric("k3_roofline").read(t) is None


def test_whole_reading_rule():
    t = _trace()
    launched = {"near_field": 1, "far_octet": 1, "allpairs": 1}
    assert tracing.is_whole(t, launched)
    assert not tracing.is_whole(t, {"near_field": 2})
    t.runtime_calls["cudaLaunchKernel"] = 99
    assert not tracing.is_whole(t, launched)


def test_breakdown():
    ops = dict(tracing.device_ops(_trace()))
    assert ops["allpairs_kernel"] == pytest.approx(0.040)
    assert ops["near_field_kernel<8, 32>"] == pytest.approx(0.004)
    idle = dict(tracing.idle_gaps(_trace()))
    # The gap 0.008-0.010 is under aten::nonzero; 0.005-0.006 and
    # 0.053-0.055 under no host op.
    assert idle["aten::nonzero"] == pytest.approx(0.002)
    assert idle["python"] == pytest.approx(0.001 + 0.002 + 0.0008)
    assert sum(idle.values()) == pytest.approx(0.055 - _trace().busy_s)


def test_window_from_the_host_clock():
    """A device-only block's window: the host's seconds, placed at the
    first device record."""
    class Event:
        def __init__(self, name, start, end, cuda):
            self.name = name
            self.time_range = type("R", (), {"start": start, "end": end})
            self.device_type = (tracing.torch.autograd.DeviceType.CUDA if cuda
                                else tracing.torch.autograd.DeviceType.CPU)

    events = [Event("cudaLaunchKernel", 5.0, 6.0, False),
              Event("k1(float*)", 10.0, 30.0, True),
              Event("k2(float*)", 40.0, 50.0, True)]
    t = tracing.reduce(events, 1, 8, frozenset(), window=60e-6)
    assert t.window == pytest.approx((10e-6, 70e-6))
    assert t.busy_s == pytest.approx(30e-6)
    assert t.runtime_calls == {"cudaLaunchKernel": 1}
    empty = tracing.reduce(events[:1], 1, 8, frozenset(), window=60e-6)
    assert empty.busy_s == 0 and not tracing.is_whole(empty, {})
