"""The frozen FLOP and bound arithmetic against closed forms: at the
benchmark's granite-3-2b, and at the program's zamba2-7b, whose hybrid
rule and kernels' bounds wait for an SSM cell."""
import json
from dataclasses import asdict

import pytest

import smoke
from frozen import bounds, flops
from frozen.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S


def _sizes(name):
    """The sizes the benchmark runs, else the program's registry's."""
    path = smoke.BENCH / "configs" / f"{name}.json"
    if path.exists():
        return json.loads(path.read_text())["as_run"]
    from repro_torch.configs.base import get_config
    return {k: v for k, v in asdict(get_config(name)).items()
            if k in smoke.SIZE_KEYS}


def test_granite_flops_closed_form():
    d, H, KV, hd, ff, V, L, S, B = 2048, 32, 8, 64, 8192, 49155, 40, 4096, 8
    per_layer = (2 * d * (H + 2 * KV) * hd + 2 * H * hd * d
                 + 2 * 2 * (S / 2) * H * hd + 3 * 2 * d * ff)
    fwd = (L * per_layer + 2 * d * V) * B * S
    assert flops.forward_flops(_sizes("granite-3-2b"), B, S) == \
        pytest.approx(fwd, rel=1e-12)
    assert flops.train_step_flops(_sizes("granite-3-2b"), B, S) == \
        pytest.approx(3 * fwd, rel=1e-12)


def test_zamba2_flops_closed_form():
    d, di, g, ds, hd, nh, Q = 3584, 7168, 2, 64, 64, 112, 256
    H, hda, ff, V, L, S = 32, 112, 14336, 32000, 81, 4096
    mamba = (2 * d * (2 * di + 2 * g * ds + nh) + 2 * di * d
             + 2 * Q * g * ds + 2 * Q * nh * hd + 4 * nh * hd * ds)
    attn = (2 * d * 3 * H * hda + 2 * H * hda * d + 2 * 2 * (S / 2) * H * hda
            + 3 * 2 * d * ff)
    fwd = (L * mamba + 14 * attn + 2 * d * V) * S
    assert flops.forward_flops(_sizes("zamba2-7b"), 1, S) == \
        pytest.approx(fwd, rel=1e-12)


@pytest.mark.parametrize("name,B", [("zamba2-7b", 1), ("granite-3-2b", 8)])
def test_frozen_flops_equal_the_programs_accounting_today(name, B):
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.flops.accounting import forward_flops
    want = forward_flops(get_config(name),
                         ShapeSpec("t", 4096, B, "train")).total_mxu
    assert flops.forward_flops(_sizes(name), B, 4096) == \
        pytest.approx(want, rel=1e-12)


def test_flash_bound_at_zamba2_width():
    S, H, hd = 4096, 32, 112
    ops = 4 * hd * H * S * (S + 1) // 2
    byt = 4 * S * H * hd * 2
    got = bounds.flash_bound_s((1, S, H, hd), (1, S, H, hd),
                               "c10::BFloat16")
    assert got == pytest.approx(max(ops / BF16_FLOP_PER_S,
                                    byt / HBM_BYTES_PER_S), rel=1e-12)
    assert got * 1e3 == pytest.approx(0.1216, abs=1e-4)   # operations
    # a causal call keeps half the pairs a full one does, and bytes bound
    # a short call
    assert bounds.flash_bound_s((1, S, H, hd), (1, S, H, hd), "float",
                                causal=False) > got
    assert bounds.flash_bound_s((1, 16, H, hd), (1, 16, H, hd),
                                "c10::BFloat16") == pytest.approx(
        4 * 16 * H * hd * 2 / HBM_BYTES_PER_S)


def test_ssd_bound_at_zamba2_width():
    BC, Q, nh, hd, g, ds = 16, 256, 112, 64, 2, 64
    shapes = [(BC, Q, nh, hd), (BC, Q, nh), (BC, Q, nh), (BC, Q, g, ds),
              (BC, Q, g, ds)]
    types = ["c10::BFloat16", "float", "float", "c10::BFloat16",
             "c10::BFloat16"]
    pairs = BC * Q * (Q + 1) // 2
    ops = pairs * (g * 2 * ds + nh * (2 * hd + 4))
    assert ops == pytest.approx(7.916e9, rel=1e-3)
    byt = (2 * BC * Q * nh * hd * 2 + 2 * BC * Q * nh * 4
           + 2 * BC * Q * g * ds * 2)
    got = bounds.ssd_bound_s(shapes, types)
    assert got == pytest.approx(max(ops / BF16_FLOP_PER_S,
                                    byt / HBM_BYTES_PER_S), rel=1e-12)
    assert got * 1e3 == pytest.approx(0.0368, abs=1e-4)   # bytes
