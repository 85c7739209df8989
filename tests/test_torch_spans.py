"""The spans a train step opens (`repro_torch.spans`), as a CPU profiler
records them: one step, forward, backward and optimizer a step, a
recompute for each layer under remat inside the backward, a forward,
backward and accumulate a microbatch, the data pipeline's two; none of
them reaches the dispatcher, and recording them changes no number."""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.data import synthetic_batch, to_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

SHAPE = ShapeSpec("t", 32, 2, "train")
OPT = adamw.OptConfig(warmup_steps=1)
NAMES = (spans.STEP, spans.FORWARD, spans.BACKWARD, spans.RECOMPUTE,
         spans.ACCUMULATE, spans.OPTIMIZER, spans.SYNTHETIC_BATCH,
         spans.TO_DEVICE)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(remat: str = "nothing"):
    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(),
                              remat=remat)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, params


def _batch(cfg):
    return to_device(cfg, synthetic_batch(cfg, SHAPE, 0, seed=3), "cpu")


def _profiled(fn):
    """fn's result and the spans of NAMES it opened, under a CPU
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in NAMES]


def _step(cfg, params, accum_steps: int = 1):
    step = steps.make_train_step(cfg, OPT, accum_steps=accum_steps)
    return step(params, adamw.init(OPT, params), _batch(cfg))


@pytest.mark.parametrize("remat", ["nothing", "dots", "none"])
def test_a_step_opens_each_phase_once_and_a_recompute_a_layer(remat):
    cfg, params = _setup(remat)
    _, ev = _profiled(lambda: _step(cfg, params))
    n = collections.Counter(e.name for e in ev)
    layers = cfg.num_layers if remat != "none" else 0
    assert n == {spans.STEP: 1, spans.FORWARD: 1, spans.BACKWARD: 1,
                 spans.OPTIMIZER: 1, spans.SYNTHETIC_BATCH: 1,
                 spans.TO_DEVICE: 1} | ({spans.RECOMPUTE: layers}
                                        if layers else {})
    at = {e.name: e.time_range for e in ev if e.name != spans.RECOMPUTE}
    step, bwd = at[spans.STEP], at[spans.BACKWARD]
    for name in (spans.FORWARD, spans.BACKWARD, spans.OPTIMIZER):
        assert step.start <= at[name].start <= at[name].end <= step.end
    assert at[spans.FORWARD].end <= bwd.start
    assert bwd.end <= at[spans.OPTIMIZER].start
    for e in ev:
        if e.name == spans.RECOMPUTE:
            assert bwd.start <= e.time_range.start <= e.time_range.end \
                <= bwd.end


def test_accumulation_opens_a_forward_backward_and_accumulate_a_micro():
    cfg, params = _setup()
    _, ev = _profiled(lambda: _step(cfg, params, accum_steps=2))
    n = collections.Counter(e.name for e in ev)
    assert (n[spans.STEP], n[spans.FORWARD], n[spans.BACKWARD],
            n[spans.ACCUMULATE], n[spans.OPTIMIZER]) == (1, 2, 2, 2, 1)
    assert n[spans.RECOMPUTE] == 2 * cfg.num_layers


def test_the_data_pipeline_opens_its_two_spans():
    cfg, _ = _setup()
    _, ev = _profiled(lambda: _batch(cfg))
    assert [e.name for e in ev] == [spans.SYNTHETIC_BATCH, spans.TO_DEVICE]


def test_recording_the_spans_changes_no_number():
    cfg, params = _setup()
    out = {}
    for traced in (False, True):
        p = tree_map(torch.clone, params)
        fn = lambda: _step(cfg, p)                       # noqa: E731
        _, _, aux = _profiled(fn)[0] if traced else fn()
        out[traced] = (p, {k: float(v) for k, v in aux.items()})
    assert out[True][1] == out[False][1]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(out[True][0]), tree_leaves(out[False][0])))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._schema.name)
        return func(*args, **(kwargs or {}))


def test_no_span_reaches_the_dispatcher():
    """The dry run counts what its dispatch modes see: a span adds no
    op there, with or without a profiler recording."""
    cfg, params = _setup()
    for traced in (False, True):
        with _Ops() as mode:
            if traced:
                _profiled(lambda: _step(cfg, params))
            else:
                _step(cfg, params)
        assert mode.names and not any(n.startswith("profiler::")
                                      for n in mode.names)
