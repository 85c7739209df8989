"""The readers of the train step's phases (`bench/phases.py`) on a
hand-made trace: a `train.backward` span on the caller's thread whose
kernels autograd's thread launches, a `train.recompute` nested on that
thread, a copy and a memset with no launch of their own, and the data
pipeline's spans."""
import pytest

import devtrace
import harness
import phases
import smoke

X = "X"
PHASES = ("forward_ms.train", "recompute_ms.train", "backward_ms.train",
          "optimizer_ms.train", "pipeline_ms.train")


def _span(name, tid, ts, dur):
    return {"ph": X, "cat": "cpu_op", "name": name, "tid": tid, "ts": ts,
            "dur": dur}


def _launch(corr, tid, ts):
    return {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "tid": tid, "ts": ts, "dur": 5, "args": {"correlation": corr}}


def _device(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": X, "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events(steps: int = 1) -> list:
    ev = [{"ph": X, "cat": "user_annotation", "name": devtrace.WINDOW,
           "tid": 1, "ts": 0, "dur": 20000},
          _span("data.synthetic_batch", 1, 10, 30),
          _span("data.to_device", 1, 40, 20),
          _launch(1, 1, 150), _device(1, 160, 20),        # in no phase
          _span("train.forward", 1, 200, 800),
          _launch(2, 1, 300), _device(2, 400, 400),
          _device(3, 800, 50, "gpu_memcpy", "Memcpy DtoD"),
          _span("train.backward", 1, 1000, 2000),
          _launch(4, 2, 1100), _device(4, 1200, 1000),
          _span("train.recompute", 2, 1500, 300),
          _launch(5, 2, 1600), _device(5, 2200, 300),
          _span("train.optimizer", 1, 3000, 1000),
          _launch(6, 1, 3100), _device(6, 3200, 200),
          _device(7, 3400, 10, "gpu_memset", "Memset"),
          _launch(8, 3, 3500), _device(8, 3600, 100)]     # another thread
    ev += [_span("train.step", 1, 100 + 5000 * i, 4900) for i in range(steps)]
    return ev


def _run(steps: int = 1):
    return harness.Run({"count": 0, "spans": {}},
                       devtrace.Trace(_events(steps), 99.0), steps)


def _read(metric, run):
    return harness.reader(smoke.ROOT, metric).read(run)


def test_the_backward_is_read_from_autograds_thread():
    t = _run().trace
    assert t.device_s_under("train.backward") == 0     # the caller's thread
    assert phases.device_ms(_run(), "train.backward", any_thread=True) \
        == pytest.approx(1.3)


@pytest.mark.parametrize("steps", [1, 2])
def test_each_reader_reads_its_phase_a_step(steps):
    want = {"forward_ms.train": 0.45,       # the kernel and the copy after it
            "recompute_ms.train": 0.3,
            "backward_ms.train": 1.0,       # 1.3 while open, less recompute
            "optimizer_ms.train": 0.21,     # the kernel and the memset
            "pipeline_ms.train": 0.05}
    got = {m: _read(m, _run(steps)) for m in PHASES}
    assert got == pytest.approx({m: v / steps for m, v in want.items()})


@pytest.mark.parametrize("metric", PHASES)
def test_no_train_step_reads_none(metric):
    ev = [e for e in _events() if e["name"] != "train.step"]
    assert _read(metric, harness.Run({}, devtrace.Trace(ev, 99.0), 1)) \
        is None
    assert _read(metric, harness.Run({})) is None
