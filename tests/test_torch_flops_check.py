"""The port's FLOPs accounting against the reference's and against what
its model executes.

The first is exact: the same config and shape give the reference's
FLOPs by category, parameter counts and 6ND.  The second is the
counterpart of `tests/test_flops_accounting.py`'s
`test_analytic_close_to_compiled_hlo`, with
`torch.utils.flop_counter.FlopCounterMode` over the port's forward in
place of XLA's cost analysis.  FlopCounterMode counts every layer's
matmuls, where XLA counts a scan body once, so the ratio sits near 1
(1.02-1.09 at smoke size: the accounting leaves out a few small
products) and is held to 0.95-1.15, not the reference's 0.2-5."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ShapeSpec, get_config, make_inputs  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.flops import accounting  # noqa: E402
from repro_torch.flops.accounting import forward_flops  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402


def counted_forward_flops(cfg, shape) -> int:
    """FLOPs FlopCounterMode counts over one CPU forward of `cfg`."""
    params = init_params(cfg, device="cpu")
    batch = make_inputs(cfg, shape, device="cpu")
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        forward(cfg, params, batch)
    return counter.get_total_flops()


def test_analytic_close_to_counted_flops():
    cfg = get_config("granite-3-2b").smoke()
    shape = ShapeSpec("t", 64, 2, "train")
    counted = counted_forward_flops(cfg, shape)
    analytic = forward_flops(cfg, shape).total_mxu
    print(f"granite-3-2b smoke forward, S 64, B 2: counted {counted:,d}, "
          f"analytic {analytic:,.0f}, ratio {counted / analytic:.4f}")
    assert 0.95 < counted / analytic < 1.15


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m", "zamba2-7b",
                                  "whisper-small"])
def test_counted_flops_of_serving_families_near_analytic(arch):
    """The archs the serving path drives on the card, at smoke size: the
    counted matmul FLOPs stay near the accounting's."""
    cfg = get_config(arch).smoke()
    shape = ShapeSpec("p", 64, 2, "prefill")
    ratio = counted_forward_flops(cfg, shape) \
        / forward_flops(cfg, shape).total_mxu
    print(f"{arch} smoke forward, S 64, B 2: ratio {ratio:.4f}")
    assert 0.95 < ratio < 1.15


ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "qwen3-4b",
         "nemotron-4-340b", "granite-3-2b", "llama3.2-3b", "whisper-small",
         "phi-3-vision-4.2b", "mamba2-780m", "zamba2-7b"]
#: every accounting variant beside the exact one, and the executed count
VARIANTS = [{}, {"executed": True}, {"variant": "naive_moe"},
            {"variant": "naive_hybrid"}, {"variant": "no_remat_accounting"}]


@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_equals_reference(arch):
    """The port's accounting on the published config gives the
    reference's numbers for every SHAPES entry and variant: the step and
    forward FLOPs by category (the MFU that the card's run prints divides
    `step_flops` by the measured time), parameter counts and 6ND."""
    pytest.importorskip("jax")
    from repro.configs import get_config as R_get
    from repro.configs.base import SHAPES as R_SHAPES
    from repro.flops import accounting as R_acc
    cfg, rcfg = get_config(arch), R_get(arch)
    want = dataclasses.asdict(rcfg)
    # the fields only the port has (Zamba2-7B-Instruct's) at their defaults
    own = {f.name: f.default for f in dataclasses.fields(cfg)
           if f.name not in want}
    assert dataclasses.asdict(cfg) == want | own
    for name, shape in SHAPES.items():
        rshape = R_SHAPES[name]
        for kw in VARIANTS:
            for fn in ("step_flops", "forward_flops"):
                got = getattr(accounting, fn)(cfg, shape, **kw)
                want = getattr(R_acc, fn)(rcfg, rshape, **kw)
                assert (got.mxu, got.vpu) == (want.mxu, want.vpu), \
                    (fn, name, kw)
        assert accounting.model_flops_6nd(cfg, shape) == \
            R_acc.model_flops_6nd(rcfg, rshape), name
    for active in (False, True):
        assert accounting.param_count_analytic(cfg, active) == \
            R_acc.param_count_analytic(rcfg, active)
