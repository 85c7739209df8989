"""The reduction of a Chrome trace to what the per-layer metrics read,
on a hand-made trace: the window, device busy time, launches, device
time under host ops and under named calls."""
import pytest

import devtrace
import harness
import smoke


def _trace():
    X = "X"
    ev = [
        {"ph": X, "cat": "user_annotation", "name": devtrace.WINDOW,
         "tid": 1, "ts": 100, "dur": 1000},
        {"ph": X, "cat": "cpu_op", "name": "repro_torch::flash_attention",
         "tid": 1, "ts": 200, "dur": 50,
         "args": {"Input Dims": [[1, 256, 4, 64], [1, 256, 4, 64],
                                 [1, 256, 4, 64]],
                  "Input type": ["c10::BFloat16"] * 3}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 210, "dur": 5, "args": {"correlation": 1}},
        {"ph": X, "cat": "kernel", "name": "flash_kernel", "ts": 300,
         "dur": 100, "args": {"correlation": 1}},
        {"ph": X, "cat": "cpu_op", "name": "autograd::engine::evaluate_"
         "function: FlashAttentionBackward", "tid": 2, "ts": 400, "dur": 100},
        {"ph": X, "cat": "cpu_op", "name": "FlashAttentionBackward",
         "tid": 2, "ts": 410, "dur": 80},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 2, "ts": 420, "dur": 5, "args": {"correlation": 2}},
        {"ph": X, "cat": "kernel", "name": "void at::native::"
         "elementwise_kernel<128>", "ts": 450, "dur": 200,
         "args": {"correlation": 2}},
        {"ph": X, "cat": "cuda_runtime", "name": "cuLaunchKernelEx",
         "tid": 1, "ts": 700, "dur": 5, "args": {"correlation": 3}},
        {"ph": X, "cat": "kernel", "name": "nvjet_gemm", "ts": 1050,
         "dur": 100, "args": {"correlation": 3}},     # half past the end
        {"ph": X, "cat": "kernel", "name": "before", "ts": 0, "dur": 50,
         "args": {"correlation": 9}},                 # before the window
        {"ph": X, "cat": "cpu_op", "name": "bench.step", "tid": 1,
         "ts": 640, "dur": 300},
    ]
    return devtrace.Trace(ev, 99.0)


def test_window_busy_and_launches():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((100 + 200 + 50) / 1e6)
    assert t.n_launches == 3
    assert t.device_s(lambda n: "elementwise_kernel" in n) == \
        pytest.approx(200e-6)


def test_device_time_under_ops_and_calls():
    t = _trace()
    assert t.device_s_under("FlashAttentionBackward") == \
        pytest.approx(200e-6)
    (args, s), = t.calls("repro_torch::flash_attention")
    assert s == pytest.approx(100e-6)
    assert args["Input Dims"][0] == [1, 256, 4, 64]


def test_breakdown_names_ops_and_gaps():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["void at::native::elementwise_kernel<128>",
                                  pytest.approx(200e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["bench.step"] == pytest.approx(400e-6)   # 650 -> 1050


@pytest.mark.parametrize("metric", [
    "idle_share.train", "launches_per_step.train", "elementwise_ms.train",
    "attention_bwd_ms.train", "flash_roofline.prefill",
    "ssd_roofline.prefill", "idle_share.prefill"])
def test_readers_read_the_trace_or_nothing(metric):
    mod = harness.reader(smoke.ROOT, metric)
    run = harness.Run({"count": 0, "spans": {}}, _trace(), 2)
    v = mod.read(run)
    if metric == "ssd_roofline.prefill":
        assert v is None                       # no such call traced
    else:
        assert v is not None and v > 0
    if metric.startswith(("idle", "flash_roofline")):
        assert v <= 100
    assert mod.read(harness.Run({"count": 0, "spans": {}})) is None
