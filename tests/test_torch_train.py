"""The port's training half (`kernels.grad`, the models' remat,
`optim.adamw`, `data.pipeline`, `train.{checkpoint,steps,trainer}`,
`launch.train`) against the JAX package on the same values.

Gradient parity initialises each arch's smoke config in f32 with the
port (seed 0), hands the reference a copy of those parameters and feeds
both packages `make_inputs`' draws: the port's loss and every gradient
leaf equal `jax.value_and_grad` of the reference's `loss_fn` to 1e-4 of
the leaf's RMS, and one train step the reference's (its jitted
`make_train_step` for `JITTED_STEPS`, accumulation included).  The
reference's functions are compiled once an arch and shared by the cases.
The autograd Functions' backwards equal autograd of the kernels' plain
versions in f64 (rtol 1e-10).  The data stream and checkpoints are
bitwise interchangeable with the reference's.

The `gpu` cases at the end import nothing of JAX:
`pytest -m gpu tests/test_torch_train.py`."""
import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec, get_config, make_inputs  # noqa: E402,E501
from repro_torch.core.peaks import TPU_V5E, TPU_V6E_LIKE  # noqa: E402
from repro_torch.data import synthetic_batch, to_device  # noqa: E402
from repro_torch.kernels import grad, ops, ref  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.common import (flash_attention, tree_leaves,  # noqa: E402,E501
                                       tree_map)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import (StepTelemetry, TrainConfig,  # noqa: E402,E501
                                       Trainer)

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "qwen3-4b",
         "nemotron-4-340b", "granite-3-2b", "llama3.2-3b", "whisper-small",
         "phi-3-vision-4.2b", "mamba2-780m", "zamba2-7b"]
TRAIN = ("t", 32, 2, "train")
F64 = torch.float64


def _jax():
    return pytest.importorskip("jax")


def _np(x) -> np.ndarray:
    """A jax or torch array as f32 (or integer) NumPy."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).detach().numpy()
    jnp = _jax().numpy
    return np.asarray(x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)


def _paths(tree, path=""):
    """{keystr path: leaf} of a dict tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{path}[{k!r}]"))
        return out
    return {path: tree}


def _close_rms(got, want, what: str, tol: float = 1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    rms = float(np.sqrt((want.astype(np.float64) ** 2).mean()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * rms, f"{what}: max |diff| {err:.3e}, RMS {rms:.3e}"


# ---------------------------------------------------------------------------
# the autograd Functions against autograd of the plain versions, in f64
# ---------------------------------------------------------------------------
def _grads(fn, inputs, cot):
    for t in inputs:
        t.grad = None
    fn().backward(cot)
    return [t.grad.clone() for t in inputs]


def _assert_f64(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (what, i)
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10 *
                                   float(w.abs().max()), msg=f"{what} {i}")


FLASH_GRAD_CASES = {
    # B, Sq, Sk, H, KV, hd, causal
    "causal": (2, 40, 40, 4, 4, 16, True),
    "full": (2, 40, 40, 4, 4, 16, False),
    "gqa-causal": (1, 37, 37, 8, 2, 8, True),
    "sq-lt-sk": (1, 20, 45, 4, 2, 8, False),
    "sq-gt-sk-causal": (2, 50, 30, 6, 3, 8, True),
}


@pytest.mark.parametrize("case", list(FLASH_GRAD_CASES))
def test_flash_backward_matches_plain_autograd(case):
    B, Sq, Sk, H, KV, hd, causal = FLASH_GRAD_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=F64,
                            requires_grad=True)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    cot = torch.tensor(rng.standard_normal((B, Sq, H, hd)), dtype=F64)
    with mock.patch.object(grad, "FLASH_BWD_BLOCK", 16):   # several blocks
        got = _grads(lambda: ops.flash(q, k, v, causal=causal), (q, k, v),
                     cot)
    want = _grads(lambda: ref.ref_attention(q, k, v, causal=causal),
                  (q, k, v), cot)
    _assert_f64(got, want, case)


def test_flash_backward_gives_a_narrower_v_its_own_width():
    """MLA: V of hd 8 against q/k of hd 16, zero-padded for the kernel;
    dv keeps V's width and equals autograd of the plain attention."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((2, 24, 4, 16)), dtype=F64,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((2, 24, 4, 16)), dtype=F64,
                     requires_grad=True)
    v = torch.tensor(rng.standard_normal((2, 24, 4, 8)), dtype=F64,
                     requires_grad=True)
    cot = torch.tensor(rng.standard_normal((2, 24, 4, 8)), dtype=F64)

    def plain():
        vp = torch.nn.functional.pad(v, (0, 8))
        return ref.ref_attention(q, k, vp, causal=True)[..., :8]
    got = _grads(lambda: flash_attention(q, k, v, causal=True), (q, k, v),
                 cot)
    want = _grads(plain, (q, k, v), cot)
    assert got[2].shape == (2, 24, 4, 8)
    _assert_f64(got, want, "mla")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_scales_are_the_summands_rms(causal):
    """`ref.flash_bwd_scales`, blocked, against each gradient element's
    summands written out whole, in f64 (GQA, Sq > Sk)."""
    B, Sq, Sk, H, KV, hd = 2, 23, 17, 6, 2, 8
    G, scale = H // KV, 0.3
    rng = np.random.default_rng(5)
    q, o, do = (torch.tensor(rng.standard_normal((B, Sq, H, hd)), dtype=F64)
                for _ in range(3))
    k, v = (torch.tensor(rng.standard_normal((B, Sk, KV, hd)), dtype=F64)
            for _ in range(2))
    got = ref.flash_bwd_scales(q, k, v, o, do, causal=causal, scale=scale,
                               block=8)
    qg, og, dog = (t.reshape(B, Sq, KV, G, hd) for t in (q, o, do))
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k) * scale
    if causal:
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool).triu(1),
                          float("-inf"))
    p = torch.softmax(s, -1)
    d = (dog * og).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqkgd,bjkd->bkgqj", dog, v) - d[..., None])
    # every summand, then the root-sum-square over the summed index
    tq = ds[..., None] * k.permute(0, 2, 1, 3)[:, :, None, None] * scale
    tk = ds[..., None] * qg.permute(0, 2, 3, 1, 4)[..., None, :] * scale
    tv = p[..., None] * dog.permute(0, 2, 3, 1, 4)[..., None, :]
    want = (tq.square().sum(4).sqrt().permute(0, 3, 1, 2, 4)
            .reshape(B, Sq, H, hd),
            tk.square().sum((2, 3)).sqrt().permute(0, 2, 1, 3),
            tv.square().sum((2, 3)).sqrt().permute(0, 2, 1, 3))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# the backward's route: (device, dtype, q/k hd, v hd) -> route
FLASH_BWD_ROUTES = {
    "cuda-bf16-hd64": ("cuda", torch.bfloat16, 64, 64, "kernel"),
    "cuda-bf16-hd128": ("cuda", torch.bfloat16, 128, 128, "kernel"),
    "meta-bf16-hd64": ("meta", torch.bfloat16, 64, 64, "kernel"),
    "cpu-bf16-hd64": ("cpu", torch.bfloat16, 64, 64, "plain"),
    "cuda-f32-hd64": ("cuda", torch.float32, 64, 64, "plain"),
    "cuda-f64-hd128": ("cuda", torch.float64, 128, 128, "plain"),
    "cuda-bf16-hd112": ("cuda", torch.bfloat16, 112, 112, "plain"),
    "cuda-bf16-hd96": ("cuda", torch.bfloat16, 96, 96, "plain"),
    "cuda-bf16-hd192": ("cuda", torch.bfloat16, 192, 192, "plain"),
    "cuda-bf16-narrower-v": ("cuda", torch.bfloat16, 128, 64, "plain"),
}


@pytest.mark.parametrize("case", list(FLASH_BWD_ROUTES))
def test_flash_bwd_route_rule(case):
    from repro_torch.kernels.flash_attention import bwd_route
    device, dtype, hd, hd_v, want = FLASH_BWD_ROUTES[case]
    q, k, v = (2, 300, 8, hd), (2, 300, 2, hd), (2, 300, 2, hd_v)
    assert bwd_route(device, dtype, q, k, v) == want


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_op_fake_gives_the_gradients_shapes(causal):
    """On fake CUDA tensors the op allocates what the launch allocates:
    dq, dk, dv like q, k, v and the f32 scratch of log-sum-exps and D;
    nothing launches and nothing counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    counts = grad.flash_bwd_routes()
    launches = fa.flash_attention_bwd_kernel.launches
    with FakeTensorMode():
        q = torch.empty((2, 200, 8, 64), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((2, 130, 2, 64), dtype=torch.bfloat16, device="cuda")
        dq, dk, dv = grad.flash_bwd(q, k, k, q, q, causal=causal, scale=0.125)
        *_, stats = fa.flash_attention_bwd_op(q, k, k, q, q, causal, 0.125)
    for g, like in ((dq, q), (dk, k), (dv, k)):
        assert (g.shape, g.dtype, g.device.type) == (like.shape, like.dtype,
                                                     "cuda")
    assert (stats.shape, stats.dtype) == ((2, 2, 8, 256), torch.float32)
    assert grad.flash_bwd_routes() == counts
    assert fa.flash_attention_bwd_kernel.launches == launches


# (q shape, Sk, causal) -> the backward kernels' executed FLOPs: 2·hd ·
# 128 · 64 a (block, tile) pair and product, 8 products over the tiles
def _bwd_closed_form(B, Sq, Sk, H, hd, causal):
    unit = 2 * hd * 128 * 64 * 4 * B * H
    if causal:                       # Sq == Sk, a multiple of 128: n blocks
        n = Sq // 128
        return unit * 2 * n * (n + 1)
    return unit * (-(-Sq // 128) * -(-Sk // 64) + -(-Sk // 128) * -(-Sq // 64))


FLASH_BWD_FLOPS = {
    "granite-layer": (8, 4096, 4096, 32, 64, True),
    "llama-layer": (1, 4096, 4096, 24, 128, True),
    "one-block": (1, 128, 128, 1, 64, True),
    "full-ragged": (2, 200, 330, 4, 64, False),
    "full-sq-gt-sk": (1, 1000, 96, 8, 128, False),
}


@pytest.mark.parametrize("case", list(FLASH_BWD_FLOPS))
def test_flash_bwd_flops_closed_form(case):
    """The formula in closed form, and through `FlopCounterMode` on meta
    tensors (the formula is registered on the op)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, hd, causal = FLASH_BWD_FLOPS[case]
    want = _bwd_closed_form(B, Sq, Sk, H, hd, causal)
    assert fa.flash_bwd_flops((B, Sq, H, hd), (B, Sk, 2, hd), causal) == want
    q = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Sk, 2, hd), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as counter:
        fa.flash_attention_bwd_op(q, k, k, q, q, causal, hd ** -0.5)
    assert counter.get_total_flops() == want


def test_flash_bwd_flops_granite_is_the_eight_passes():
    """At granite's layer the tiles' FLOPs are the 8 passes over the
    causal pairs, and the diagonal tiles' masked halves, 3.1 % more."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, hd = 8, 4096, 32, 64
    pairs = B * H * S * (S + 1) // 2
    got = fa.flash_bwd_flops((B, S, H, hd), (B, S, 8, hd), True)
    assert 1.0 < got / (8 * 2 * hd * pairs) < 1.04


def test_flash_backward_looks_up_flash_bwd_when_it_runs(monkeypatch):
    """`FlashAttention.backward` calls `grad.flash_bwd` as it is when the
    backward runs (the fault mutants patch it there), and on the CPU the
    router takes the plain version, bf16 at hd 64 included."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(torch.bfloat16).requires_grad_()
               for s in ((1, 20, 4, 64), (1, 20, 2, 64), (1, 20, 2, 64)))
    out = ops.flash(q, k, v, causal=True)
    seen = []
    router = grad.flash_bwd

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return router(*a, **kw)
    monkeypatch.setattr(grad, "flash_bwd", spy)
    counts = grad.flash_bwd_routes()
    out.float().sum().backward()
    assert seen == [q.shape]
    assert grad.flash_bwd_routes() == {"kernel": counts["kernel"],
                                       "plain": counts["plain"] + 1}
    assert q.grad.dtype == torch.bfloat16 and q.grad.shape == q.shape


SSD_GRAD_CASES = {
    # BC, Q, nh, hd, g, ds
    "g-lt-nh": (3, 16, 4, 8, 2, 6),
    "one-group": (2, 12, 6, 4, 1, 8),
    "g-eq-nh": (4, 8, 2, 8, 2, 4),
}


def _ssd_inputs(BC, Q, nh, hd, g, ds, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((BC, Q, nh, hd)), dtype=F64)
    dt = torch.tensor(rng.uniform(0.01, 0.5, (BC, Q, nh)), dtype=F64)
    A = torch.tensor(-rng.uniform(0.5, 4.0, nh), dtype=F64)
    b, c = (torch.tensor(rng.standard_normal((BC, Q, g, ds)), dtype=F64)
            for _ in range(2))
    return [t.requires_grad_() for t in (x, dt, A, b, c)]


@pytest.mark.parametrize("case", list(SSD_GRAD_CASES))
def test_ssd_intra_backward_matches_plain_autograd(case):
    """Through dacs = cumsum(dt·A): the gradient reaches A too."""
    shape = SSD_GRAD_CASES[case]
    x, dt, A, b, c = ins = _ssd_inputs(*shape)
    cot = torch.tensor(np.random.default_rng(3).standard_normal(x.shape),
                       dtype=F64)

    def run(fn):
        return lambda: fn(x, dt, torch.cumsum(dt * A, 1), b, c)
    with mock.patch.object(grad, "SSD_BWD_ELEMENTS", 1):    # a chunk a block
        got = _grads(run(ops.ssd_intra), ins, cot)
    want = _grads(run(ref.ref_ssd_intra), ins, cot)
    _assert_f64(got, want, case)
    assert float(got[2].abs().min()) > 0


def test_ssd_backward_over_chunks_matches_the_plain_scan():
    """ops.ssd (intra Function + plain inter-chunk recurrence) against
    autograd of `ssd_chunked` over 4 chunks, g < nh, in f64."""
    from repro_torch.models.ssm import ssd_chunked
    B, S, nh, hd, g, ds = 2, 32, 4, 8, 2, 6
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((B, S, nh, hd)), dtype=F64)
    dt = torch.tensor(rng.uniform(0.01, 0.5, (B, S, nh)), dtype=F64)
    A = torch.tensor(-rng.uniform(0.5, 4.0, nh), dtype=F64)
    Bm, Cm = (torch.tensor(rng.standard_normal((B, S, g, ds)), dtype=F64)
              for _ in range(2))
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    cot = torch.tensor(rng.standard_normal(x.shape), dtype=F64)
    got = _grads(lambda: ops.ssd(*ins, chunk=8), ins, cot)
    want = _grads(lambda: ssd_chunked(*ins, chunk=8), ins, cot)
    _assert_f64(got, want, "ssd")


# the SSD backward's route: (device, dtype, Q, hd, ds, nh, g) -> route
SSD_BWD_ROUTES = {
    "cuda-bf16-cell": ("cuda", torch.bfloat16, 256, 64, 64, 112, 2, "kernel"),
    "meta-bf16-cell": ("meta", torch.bfloat16, 256, 64, 64, 112, 2, "kernel"),
    "cpu-bf16-cell": ("cpu", torch.bfloat16, 256, 64, 64, 112, 2, "plain"),
    "cuda-f32-cell": ("cuda", torch.float32, 256, 64, 64, 112, 2, "plain"),
    "meta-f32-cell": ("meta", torch.float32, 256, 64, 64, 112, 2, "plain"),
    "cuda-f64-cell": ("cuda", torch.float64, 256, 64, 64, 112, 2, "plain"),
    "cpu-f64-cell": ("cpu", torch.float64, 256, 64, 64, 112, 2, "plain"),
    "cuda-bf16-q64-ds256": ("cuda", torch.bfloat16, 64, 64, 256, 4, 1,
                            "kernel"),
    "cuda-bf16-q1024-ds128": ("cuda", torch.bfloat16, 1024, 64, 128, 48, 1,
                              "kernel"),
    "cuda-bf16-q320": ("cuda", torch.bfloat16, 320, 64, 64, 8, 2, "kernel"),
    "cuda-bf16-hd128": ("cuda", torch.bfloat16, 256, 128, 64, 8, 2, "plain"),
    "cuda-bf16-hd32": ("cuda", torch.bfloat16, 256, 32, 64, 8, 2, "plain"),
    "cuda-bf16-q100": ("cuda", torch.bfloat16, 100, 64, 64, 8, 2, "plain"),
    "cuda-bf16-q32": ("cuda", torch.bfloat16, 32, 64, 64, 8, 2, "plain"),
    "cuda-bf16-q2048": ("cuda", torch.bfloat16, 2048, 64, 64, 8, 2, "plain"),
    "cuda-bf16-ds96": ("cuda", torch.bfloat16, 256, 64, 96, 8, 2, "plain"),
    "cuda-bf16-ds320": ("cuda", torch.bfloat16, 256, 64, 320, 8, 2, "plain"),
    "cuda-bf16-ds16": ("cuda", torch.bfloat16, 256, 64, 16, 8, 2, "plain"),
    "cuda-bf16-nh-not-groups": ("cuda", torch.bfloat16, 256, 64, 64, 6, 4,
                                "plain"),
}


@pytest.mark.parametrize("case", list(SSD_BWD_ROUTES))
def test_ssd_bwd_route_rule(case):
    from repro_torch.kernels.ssd_scan import bwd_route
    *args, want = SSD_BWD_ROUTES[case]
    assert bwd_route(*args) == want


@pytest.mark.parametrize("device", ["meta", "fake-cuda"])
def test_ssd_bwd_op_fake_gives_the_gradients_shapes(device):
    """On meta and fake CUDA tensors the router takes the kernels' op,
    which allocates what the launches allocate: the five gradients like
    their inputs and the f32 dG scratch (BC, g, Q, Q); nothing launches
    and nothing counts."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ssd_scan
    BC, Q, nh, hd, g, ds = 3, 320, 8, 64, 2, 128
    counts = grad.ssd_bwd_routes()
    launches = ssd_scan.ssd_intra_bwd_kernel.launches
    mode = FakeTensorMode() if device == "fake-cuda" else \
        contextlib.nullcontext()
    dev = "cuda" if device == "fake-cuda" else "meta"
    with mode:
        x = torch.empty((BC, Q, nh, hd), dtype=torch.bfloat16, device=dev)
        dt = torch.empty((BC, Q, nh), dtype=torch.float32, device=dev)
        b = torch.empty((BC, Q, g, ds), dtype=torch.bfloat16, device=dev)
        got = grad.ssd_intra_bwd(x, dt, dt, b, b, x)
        *_, dg = ssd_scan.ssd_intra_bwd_op(x, dt, dt, b, b, x)
    for t, like in zip(got, (x, dt, dt, b, b)):
        assert (t.shape, t.dtype, t.device.type) == (like.shape, like.dtype,
                                                     dev)
    assert (dg.shape, dg.dtype) == ((BC, g, Q, Q), torch.float32)
    assert grad.ssd_bwd_routes() == counts
    assert ssd_scan.ssd_intra_bwd_kernel.launches == launches


# (BC, Q, nh, hd, g, ds) -> the backward's executed FLOPs in closed form:
# 2·64·64 a 64 x 64 tile pair and unit of depth, over n(n + 1)/2 pairs a
# chunk; per group 3·ds (S, dC, dB), per head ds + 3·hd (S, dM twice, dX)
SSD_BWD_FLOPS = {
    "zamba2-7b-instruct-layer": ((32, 256, 112, 64, 2, 64),
                                 2 * 64 * 64 * 32 * 10
                                 * (3 * 2 * 64 + 112 * (64 + 3 * 64))),
    "mamba2-780m-layer": ((16, 256, 48, 64, 1, 128),
                          2 * 64 * 64 * 16 * 10
                          * (3 * 1 * 128 + 48 * (128 + 3 * 64))),
    "one-tile": ((1, 64, 2, 64, 1, 64),
                 2 * 64 * 64 * 1 * 1 * (3 * 64 + 2 * (64 + 3 * 64))),
}


@pytest.mark.parametrize("case", list(SSD_BWD_FLOPS))
def test_ssd_bwd_flops_closed_form(case):
    """The formula against its closed form, and through `FlopCounterMode`
    on meta tensors (the formula is registered on the op)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ssd_scan
    (BC, Q, nh, hd, g, ds), want = SSD_BWD_FLOPS[case]
    assert ssd_scan.ssd_bwd_flops((BC, Q, nh, hd), (BC, Q, g, ds)) == want
    x = torch.empty((BC, Q, nh, hd), dtype=torch.bfloat16, device="meta")
    dt = torch.empty((BC, Q, nh), dtype=torch.float32, device="meta")
    b = torch.empty((BC, Q, g, ds), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as counter:
        ssd_scan.ssd_intra_bwd_op(x, dt, dt, b, b, x)
    assert counter.get_total_flops() == want


def test_ssd_backward_looks_up_ssd_intra_bwd_when_it_runs(monkeypatch):
    """`SSDIntra.backward` calls `grad.ssd_intra_bwd` as it is when the
    backward runs (the fault mutants patch it there), and on the CPU the
    router takes the plain version, bf16 at the kernels' shapes included,
    and counts it as a plain call."""
    gen = torch.Generator().manual_seed(6)
    BC, Q, nh, hd, g, ds = 1, 64, 2, 64, 1, 64
    x = torch.randn((BC, Q, nh, hd), generator=gen).to(torch.bfloat16)
    b, c = (torch.randn((BC, Q, g, ds), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    dt = torch.rand((BC, Q, nh), generator=gen) * 0.1
    dacs = torch.cumsum(-dt, 1)
    ins = [t.requires_grad_() for t in (x, dt, dacs, b, c)]
    out = ops.ssd_intra(*ins)
    seen = []
    router = grad.ssd_intra_bwd

    def spy(*a):
        seen.append(a[0].shape)
        return router(*a)
    monkeypatch.setattr(grad, "ssd_intra_bwd", spy)
    counts = grad.ssd_bwd_routes()
    out.float().sum().backward()
    assert seen == [x.shape]
    assert grad.ssd_bwd_routes() == {"kernel": counts["kernel"],
                                     "plain": counts["plain"] + 1}
    assert x.grad.dtype == torch.bfloat16 and b.grad.shape == b.shape


def test_ssd_bwd_scales_are_the_summands_rms():
    """`ref.ssd_bwd_scales` against each gradient element's summands
    written out whole, in f64 (g < nh, several chunks)."""
    BC, Q, nh, hd, g, ds = 2, 12, 4, 3, 2, 5
    hpg = nh // g
    x, dt, A, b, c = (t.detach() for t in _ssd_inputs(BC, Q, nh, hd, g, ds))
    dacs = torch.cumsum(dt * A, 1)
    dy = torch.tensor(np.random.default_rng(8).standard_normal(x.shape),
                      dtype=F64)
    got = ref.ssd_bwd_scales(x, dt, dacs, b, c, dy)
    # per head: G of its group, L, M, dM, W; dG summed over a group's heads
    grp = torch.arange(nh) // hpg
    gm = torch.einsum("zigs,zjgs->zgij", c, b)[:, grp]      # (BC, nh, Q, Q)
    seg = dacs.transpose(1, 2)[..., :, None] - dacs.transpose(1, 2)[
        ..., None, :]
    L = seg.masked_fill(torch.ones(Q, Q, dtype=torch.bool).triu(1),
                        float("-inf")).exp()
    dtj = dt.transpose(1, 2)[..., None, :]
    m = gm * L * dtj
    dm = torch.einsum("zihp,zjhp->zhij", dy, x)
    w = dm * m
    dg = (dm * L * dtj).reshape(BC, g, hpg, Q, Q).sum(2)
    t_dx = m[..., None] * dy.permute(0, 2, 1, 3)[:, :, :, None]  # z h i j p
    t_ddt = dm * gm * L
    t_dc = dg[..., None] * b.permute(0, 2, 1, 3)[:, :, None]     # z g i j s
    t_db = dg[..., None] * c.permute(0, 2, 1, 3)[:, :, :, None]
    want = (t_dx.square().sum(2).sqrt().permute(0, 2, 1, 3),
            t_ddt.square().sum(2).sqrt().transpose(1, 2),
            (w.square().sum(3) + w.square().sum(2)).sqrt().transpose(1, 2),
            t_db.square().sum(2).sqrt().permute(0, 2, 1, 3),
            t_dc.square().sum(3).sqrt().permute(0, 2, 1, 3))
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=1e-12, atol=1e-12)


def test_functions_route_only_when_a_gradient_is_needed():
    q = torch.randn(1, 8, 2, 8)
    with mock.patch.object(grad.FlashAttention, "apply") as fa, \
            mock.patch.object(grad.SSDIntra, "apply") as sa:
        ops.flash(q, q, q, causal=True)
        with torch.no_grad():
            ops.flash(q.requires_grad_(), q, q, causal=True)
        assert fa.call_count == 0
        ops.flash(q, q, q, causal=True)
        assert fa.call_count == 1
        x, dt, A, b, c = _ssd_inputs(1, 8, 2, 4, 1, 4)
        with torch.no_grad():
            ops.ssd(x[None, 0], dt[None, 0], A, b[None, 0], c[None, 0],
                    chunk=8)
        assert sa.call_count == 0


# ---------------------------------------------------------------------------
# gradients and train steps against the reference
# ---------------------------------------------------------------------------
#: XLA's CPU backend with its LLVM optimisations off, its fusions emitted
#: by the older elemental emitter and each module codegen'd in one piece:
#: the same HLO, so the same operations and roundings, compiled in about a
#: sixth of the default's time (the reference's compiles are most of this
#: file's cost)
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True,
             "xla_cpu_use_fusion_emitters": False,
             "xla_cpu_parallel_codegen_split_count": 1}


def _compiled(fn, *args):
    """jax.jit(fn) lowered and compiled for `args` under `_XLA_FAST`."""
    return _jax().jit(fn).lower(*args).compile(compiler_options=_XLA_FAST)


def _f32_cfg(arch):
    return dataclasses.replace(get_config(arch).smoke(), dtype="float32")


_PORT: dict = {}
_CASES: dict = {}


def _port(arch):
    """(f32 smoke cfg, the port's parameters from its own init, seed 0,
    the smoke config's inputs upcast), made once an arch; callers that
    update parameters in place take a `_clone`."""
    if arch not in _PORT:
        cfg = _f32_cfg(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        batch = make_inputs(get_config(arch).smoke(), ShapeSpec(*TRAIN),
                            device="cpu")
        _PORT[arch] = (cfg, params, {
            k: (v.float() if v.is_floating_point() else v)
            for k, v in batch.items()})
    return _PORT[arch]


def _case(arch):
    """`_port`'s case beside the reference's copy of its parameters and
    inputs and the reference's `value_and_grad` of its `loss_fn` on
    them, made once an arch."""
    if arch not in _CASES:
        jax = _jax()
        from repro.configs import get_config as R_get
        from repro.train.steps import loss_fn as R_loss
        cfg, params, batch = _port(arch)
        rcfg = dataclasses.replace(R_get(arch).smoke(), dtype="float32")
        jp, jb = _jtree(params), _jtree(batch)
        fn = _compiled(jax.value_and_grad(
            lambda p, b: R_loss(rcfg, p, b), has_aux=True), jp, jb)
        (loss, aux), grads = fn(jp, jb)
        _CASES[arch] = dict(cfg=cfg, params=params, batch=batch, rcfg=rcfg,
                            jp=jp, jb=jb, aux=aux, grads=grads)
    return _CASES[arch]


def _jtree(tree):
    """A torch tree as jax arrays, copies (the port updates its parameters
    in place)."""
    jnp = _jax().numpy
    return tree_map(lambda t: jnp.asarray(np.array(t.numpy())), tree)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _port_grads(cfg, params, batch):
    grads = tree_map(torch.zeros_like, params)
    model, leaves = steps.grad_leaves(params, grads)
    loss, aux = steps.loss_fn(cfg, model, batch)
    loss.backward(inputs=leaves)
    return loss.detach(), aux, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    jax = _jax()
    c = _case(arch)
    loss, aux, got = _port_grads(c["cfg"], c["params"], c["batch"])
    assert set(aux) == set(c["aux"])
    for k in aux:
        assert float(aux[k].detach()) == pytest.approx(float(c["aux"][k]),
                                                       rel=1e-5)
    got, want = _paths(got), _paths(c["grads"])
    assert set(got) == {jax.tree_util.keystr(k) for k, _ in
                        jax.tree_util.tree_flatten_with_path(c["jp"])[0]}
    for path in want:
        _close_rms(got[path], want[path], f"{arch} {path}")


#: eps 1e-2 keeps the first step's g / (|g| + eps) smooth in g: at the
#: default 1e-8 it is sign(g), which the two packages' rounding can flip
#: for a gradient near 0
STEP_OPT = dict(peak_lr=0.05, warmup_steps=1, decay_steps=10, eps=1e-2)
#: (arch, accum_steps) held against the reference's own jitted
#: `make_train_step`; every other arch's step against the reference's
#: `adamw.update` on its `value_and_grad` (that step's body at accum 1)
JITTED_STEPS = [("granite-3-2b", 1), ("zamba2-7b", 2)]
_STEP_FNS: dict = {}
_STEPS: dict = {}


def _ref_step_fn(arch, accum):
    """The reference's `make_train_step` under `STEP_OPT`, compiled once
    for the shared case's shapes."""
    if (arch, accum) not in _STEP_FNS:
        from repro.optim import adamw as R_adamw
        from repro.train.steps import make_train_step as R_make
        c = _case(arch)
        oc = R_adamw.OptConfig(**STEP_OPT)
        _STEP_FNS[(arch, accum)] = _compiled(
            R_make(c["rcfg"], oc, accum_steps=accum), c["jp"],
            R_adamw.init(oc, c["jp"]), c["jb"])
    return _STEP_FNS[(arch, accum)]


def _ref_step(arch, accum):
    """The reference's train step from the shared case's parameters:
    (params, opt_state, metrics)."""
    if (arch, accum) not in _STEPS:
        jax = _jax()
        from repro.optim import adamw as R_adamw
        c = _case(arch)
        oc = R_adamw.OptConfig(**STEP_OPT)
        state = R_adamw.init(oc, c["jp"])
        if (arch, accum) in JITTED_STEPS:
            out = _ref_step_fn(arch, accum)(c["jp"], state, c["jb"])
        else:
            assert accum == 1
            update = _compiled(lambda g, s, p: R_adamw.update(oc, g, s, p),
                               c["grads"], state, c["jp"])
            p, s, m = update(c["grads"], state, c["jp"])
            out = (p, s, {**c["aux"], **m})
        _STEPS[(arch, accum)] = jax.block_until_ready(out)
    return _STEPS[(arch, accum)]


@pytest.mark.parametrize("arch,accum", [(a, 1) for a in ARCHS] + [
    k for k in JITTED_STEPS if k[1] > 1])
def test_train_step_matches_reference(arch, accum):
    c = _case(arch)
    want_p, want_s, want_m = _ref_step(arch, accum)
    oc = adamw.OptConfig(**STEP_OPT)
    params = _clone(c["params"])
    p, s, m = steps.make_train_step(c["cfg"], oc, accum_steps=accum)(
        params, adamw.init(oc, params), c["batch"])
    assert set(m) == set(want_m)
    for k in m:
        assert float(m[k]) == pytest.approx(float(want_m[k]), rel=1e-4), k
    assert int(s["count"]) == int(want_s["count"]) == 1
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(c["params"]), tree_leaves(p))]
    assert any(moved)
    got, want, start = _paths(p), _paths(want_p), _paths(c["params"])
    for path in want:
        # one Adam step moves each weight by ~lr: compare the moves
        _close_rms(got[path] - start[path],
                   np.asarray(want[path]) - _np(start[path]),
                   f"{arch} {path}", tol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    """The reference's `test_train_step_smoke`: one step of the smoke
    config in its own dtype (bf16) gives a finite loss and a non-zero
    gradient norm, and moves the parameters."""
    cfg = get_config(arch).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = _clone(params)
    # lr large enough that one update survives bf16 weight quantization
    oc = adamw.OptConfig(peak_lr=0.05, warmup_steps=1, decay_steps=10)
    batch = make_inputs(cfg, ShapeSpec(*TRAIN), device="cpu")
    _, _, m = steps.make_train_step(cfg, oc)(params, adamw.init(oc, params),
                                             batch)
    assert np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) > 0
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(before), tree_leaves(params))
               if a.is_floating_point())


def test_train_step_keeps_its_gradient_buffers_stacked():
    """The per-layer gradient leaves land in one stacked buffer a leaf,
    with the reference's keys and shapes, kept from call to call."""
    cfg, params, batch = _port("zamba2-7b")
    params = _clone(params)
    oc = adamw.OptConfig(warmup_steps=1)
    step = steps.make_train_step(cfg, oc)
    step(params, adamw.init(oc, params), batch)
    bufs = tree_leaves(step.grads)
    assert [b.shape for b in bufs] == [p.shape for p in tree_leaves(params)]
    step(params, adamw.init(oc, params), batch)
    assert all(a is b for a, b in zip(bufs, tree_leaves(step.grads)))
    in_proj = step.grads["layers"]["mixer"]["in_proj"]
    assert in_proj.shape[0] == cfg.num_layers
    assert all(float(in_proj[i].abs().sum()) > 0
               for i in range(cfg.num_layers))


def test_train_step_keeps_and_clears_its_accumulator():
    """With accum_steps > 1 the f32 accumulator is made once and kept;
    each call starts it from zero, so a second step from the same start
    gives the first one's result bitwise."""
    cfg, params, batch = _port("granite-3-2b")
    oc = adamw.OptConfig(**STEP_OPT)
    step = steps.make_train_step(cfg, oc, accum_steps=2)
    outs = []
    for _ in range(2):
        p = _clone(params)
        _, _, m = step(p, adamw.init(oc, p), batch)
        outs.append((p, m, tree_leaves(step.acc)))
    (p1, m1, acc1), (p2, m2, acc2) = outs
    assert all(a is b for a, b in zip(acc1, acc2))
    assert all(a.dtype == torch.float32 for a in acc1)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-small",
                                  "deepseek-moe-16b"])
def test_remat_policies_give_equal_gradients(arch):
    """"nothing", "dots" and "none" compute one gradient; under remat the
    recompute runs the SSD Function again, so A_log's gradient (through
    the cumsum of dt·A) still arrives."""
    cfg, params, batch = _port(arch)
    out = {}
    for policy in ("none", "nothing", "dots"):
        c = dataclasses.replace(cfg, remat=policy)
        out[policy] = _port_grads(c, params, batch)
    for policy in ("nothing", "dots"):
        assert float(out[policy][0]) == float(out["none"][0])
        for g, w in zip(tree_leaves(out[policy][2]),
                        tree_leaves(out["none"][2])):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    if cfg.ssm_state:
        a_log = out["nothing"][2]["layers"]["mixer"]["A_log"]
        assert bool((a_log != 0).all())


def test_recompute_runs_the_kernel_functions_again():
    """Under remat="nothing" each layer's kernel Functions run in the
    forward and again in the recompute."""
    cfg, params, batch = _port("zamba2-7b")
    calls = {"flash": 0, "ssd": 0}
    flash_fwd, ssd_fwd = grad.FlashAttention.forward, grad.SSDIntra.forward

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return staticmethod(wrapped)
    with mock.patch.object(grad.FlashAttention, "forward",
                           count("flash", flash_fwd)), \
            mock.patch.object(grad.SSDIntra, "forward",
                              count("ssd", ssd_fwd)):
        _port_grads(cfg, params, batch)
    groups = len(range(0, cfg.num_layers, cfg.attn_every))
    assert calls == {"flash": 2 * groups, "ssd": 2 * cfg.num_layers}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
OPT_CASES = {
    "dense": {},
    "factored": {"factored_v": True},
    "bf16-moments": {"moment_dtype": "bfloat16", "factored_v": True},
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_update_matches_reference(case):
    jax = _jax()
    jnp = jax.numpy
    from repro.optim import adamw as R_adamw
    kw = dict(peak_lr=0.05, warmup_steps=2, decay_steps=20, clip_norm=5.0,
              **OPT_CASES[case])
    rng = np.random.default_rng(5)
    shapes = {"w": (160, 130), "stack": (3, 128, 136), "b": (7,),
              "conv": (3, 4, 130)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rcfg, cfg = R_adamw.OptConfig(**kw), adamw.OptConfig(**kw)
    js, ts = R_adamw.init(rcfg, jp), adamw.init(cfg, tp)
    assert {k: tuple(t.shape) for k, t in _paths(ts).items()} == \
        {k: tuple(t.shape) for k, t in _paths(js).items()}
    update = None
    for i in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        update = update or _compiled(
            lambda g, s, p: R_adamw.update(rcfg, g, s, p), jg, js, jp)
        jp, js, jm = update(jg, js, jp)
        tp, ts, tm = adamw.update(cfg, {k: torch.from_numpy(v)
                                        for k, v in g.items()}, ts, tp)
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    # a bf16 first moment one ulp (2^-8) apart where the two packages'
    # f32 sums round it to either side moves a weight by ~lr·2^-8 a step,
    # and the moment carries the flip on: 4 steps, lr 0.05 -> ~1e-3
    atol = 1e-3 if case == "bf16-moments" else 1e-6
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-5,
                                   atol=atol)
    want = _paths(js)
    for pt, t in _paths(ts).items():
        np.testing.assert_allclose(_np(t), _np(want[pt]),
                                   rtol=2e-2 if "m'" in pt and
                                   case == "bf16-moments" else 1e-4,
                                   atol=1e-6, err_msg=pt)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_sliced_update_equals_unsliced(case):
    """update() runs a stacked leaf one leading index at a time; the
    whole-leaf arithmetic gives the same bits."""
    cfg = adamw.OptConfig(peak_lr=0.05, warmup_steps=1, **OPT_CASES[case])
    gen = torch.Generator().manual_seed(6)
    p = torch.randn((3, 130, 140), generator=gen)
    g = torch.randn((3, 130, 140), generator=gen) * 10
    tree = {"s": p.clone()}
    state = adamw.init(cfg, tree)
    whole = {"s": p.clone()}
    wstate = adamw.init(cfg, whole)
    for _ in range(3):
        adamw.update(cfg, {"s": g}, state, tree)
        count = wstate["count"]
        count += 1
        gn = adamw.global_norm({"s": g})
        adamw.update_leaf(
            cfg, whole["s"], g, wstate["mu"]["s"], lr=adamw.lr_at(cfg, count),
            scale=torch.clamp_max(cfg.clip_norm / (gn + 1e-9), 1.0),
            c1=1 - cfg.b1 ** count.float(), c2=1 - cfg.b2 ** count.float(),
            decay=True)
    assert torch.equal(tree["s"], whole["s"])
    for a, b in zip(tree_leaves(state), tree_leaves(wstate)):
        assert torch.equal(a, b)


def test_adamw_descends_quadratic():
    cfg = adamw.OptConfig(peak_lr=0.1, min_lr=0.01, warmup_steps=2,
                          decay_steps=100, weight_decay=0.0)
    params = {"w": torch.full((4, 4), 5.0)}
    state = adamw.init(cfg, params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_factored_v_matches_dense_roughly():
    cfg_d = adamw.OptConfig(peak_lr=0.05, warmup_steps=1, decay_steps=50,
                            weight_decay=0.0)
    cfg_f = adamw.OptConfig(peak_lr=0.05, warmup_steps=1, decay_steps=50,
                            weight_decay=0.0, factored_v=True)
    p1 = {"w": torch.full((256, 256), 3.0)}
    p2 = {"w": torch.full((256, 256), 3.0)}
    s1, s2 = adamw.init(cfg_d, p1), adamw.init(cfg_f, p2)
    # factored second moment keeps O(n+m) state
    assert s2["mu"]["w"]["v"]["row"].shape == (256,)
    for _ in range(30):
        p1, s1, _ = adamw.update(cfg_d, {"w": 2 * p1["w"]}, s1, p1)
        p2, s2, _ = adamw.update(cfg_f, {"w": 2 * p2["w"]}, s2, p2)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), atol=0.3)


def test_lr_schedule():
    cfg = adamw.OptConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                          decay_steps=100)
    assert float(adamw.lr_at(cfg, 5)) == pytest.approx(0.5)
    assert float(adamw.lr_at(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(adamw.lr_at(cfg, 1000)) == pytest.approx(0.1, rel=1e-3)


def test_lr_schedule_matches_reference():
    from repro.optim import adamw as R_adamw
    kw = dict(peak_lr=1e-3, min_lr=1e-4, warmup_steps=7, decay_steps=90)
    for step in (0, 1, 3, 7, 8, 40, 90, 91, 500):
        assert float(adamw.lr_at(adamw.OptConfig(**kw), step)) == \
            pytest.approx(float(R_adamw.lr_at(R_adamw.OptConfig(**kw),
                                              step)), rel=1e-6)


def test_grad_clipping():
    cfg = adamw.OptConfig(clip_norm=1.0, warmup_steps=1, decay_steps=10)
    params = {"w": torch.zeros((8,))}
    state = adamw.init(cfg, params)
    _, _, m = adamw.update(cfg, {"w": torch.full((8,), 100.0)}, state, params)
    assert float(m["grad_norm"]) > 100  # reported pre-clip


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite-3-2b", "phi-3-vision-4.2b",
                                  "whisper-small"])
def test_synthetic_batch_bitwise_equal_to_reference(arch):
    from repro.configs import get_config as R_get
    from repro.configs.base import ShapeSpec as R_Shape
    from repro.data import synthetic_batch as R_batch
    cfg, rcfg = get_config(arch).smoke(), R_get(arch).smoke()
    for step, host, hosts in ((0, 0, 1), (3, 0, 2), (3, 1, 2), (11, 2, 4)):
        want = R_batch(rcfg, R_Shape("t", 24, 8, "train"), step, seed=7,
                       host_id=host, num_hosts=hosts)
        got = synthetic_batch(cfg, ShapeSpec("t", 24, 8, "train"), step,
                              seed=7, host_id=host, num_hosts=hosts)
        assert list(got) == list(want)
        dev = to_device(cfg, got, "cpu")
        for k, w in want.items():
            w = np.asarray(w)
            assert dev[k].shape == w.shape, k
            if w.dtype.name == "bfloat16":      # the bits the model sees
                assert dev[k].dtype == torch.bfloat16
                assert np.array_equal(dev[k].view(torch.int16).numpy(),
                                      w.view(np.int16)), k
            else:
                assert np.array_equal(got[k], w), k


def test_data_deterministic_and_host_sharded():
    cfg = get_config("granite-3-2b").smoke()
    shape = ShapeSpec("t", 16, 8, "train")
    a = synthetic_batch(cfg, shape, 3, seed=1)
    b = synthetic_batch(cfg, shape, 3, seed=1)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = synthetic_batch(cfg, shape, 4, seed=1)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # host sharding: each host gets B/num_hosts rows, different content
    h0 = synthetic_batch(cfg, shape, 3, seed=1, host_id=0, num_hosts=2)
    h1 = synthetic_batch(cfg, shape, 3, seed=1, host_id=1, num_hosts=2)
    assert h0["tokens"].shape[0] == 4
    assert not np.array_equal(h0["tokens"], h1["tokens"])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), tree)
    np.testing.assert_array_equal(out["a"].numpy(),
                                  np.arange(6).reshape(2, 3))
    assert out["b"]["c"].dtype == torch.bfloat16
    assert list(out) == ["a", "b"]


def test_checkpoint_keep_gc(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    steps_ = sorted(os.listdir(tmp_path))
    assert steps_ == ["step_00000004", "step_00000005"]


def test_checkpoint_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), {"x": torch.zeros(1)})


def test_checkpoint_restore_validates_shapes_and_paths(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(4)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"y": torch.zeros(3)})


def _mixed_tree(seed=8):
    """An optimizer-state-like tree: bf16, f32 and a 0-d int32."""
    gen = torch.Generator().manual_seed(seed)
    return {"mu": {"layers": {"in_proj": {
        "m": torch.randn((2, 3, 5), generator=gen).to(torch.bfloat16),
        "v": {"row": torch.rand((2, 3), generator=gen),
              "col": torch.rand((2, 5), generator=gen)}}},
        "embed": {"m": torch.randn((4, 3), generator=gen)}},
        "count": torch.tensor(5, dtype=torch.int32)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_interchangeable_with_reference(tmp_path, writer):
    """A checkpoint of either package restores bitwise in the other, and
    the two write the same manifest."""
    jax = _jax()
    from repro.train import checkpoint as R_ckpt
    tree = _mixed_tree()

    def as_jax(t):
        a = _np(t) if t.is_floating_point() else t.numpy()
        return jax.numpy.asarray(a, jax.numpy.bfloat16
                                 if t.dtype == torch.bfloat16 else a.dtype)
    jtree = tree_map(as_jax, tree)
    R_ckpt.save(str(tmp_path / "ref"), 3, jtree)
    ckpt.save(str(tmp_path / "port"), 3, tree)
    manifests = [json.load(open(tmp_path / d / "step_00000003" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    if writer == "port":
        out = R_ckpt.restore(str(tmp_path / "port"), jtree)
        for path, t in _paths(tree).items():
            got = _paths(out)[path]
            if t.dtype == torch.bfloat16:
                assert np.array_equal(np.asarray(got).view(np.int16),
                                      t.view(torch.int16).numpy()), path
            else:
                assert np.array_equal(np.asarray(got), t.numpy()), path
    else:
        out = ckpt.restore(str(tmp_path / "ref"), tree_map(torch.zeros_like,
                                                           tree))
        for path, t in _paths(tree).items():
            got = _paths(out)[path]
            assert got.dtype == t.dtype, path
            assert torch.equal(got, t), path


# ---------------------------------------------------------------------------
# trainer: checkpoint/restart + recovery loop (integration)
# ---------------------------------------------------------------------------
def _mk_trainer(tmp_path, total=12, fault_hook=None, **kw):
    cfg = get_config("granite-3-2b").smoke()
    shape = ShapeSpec("t", 32, 2, "train")
    return Trainer(
        cfg, shape,
        opt_cfg=adamw.OptConfig(warmup_steps=2, decay_steps=50),
        train_cfg=TrainConfig(total_steps=total, ckpt_every=4,
                              ckpt_dir=str(tmp_path / "ck"), log_every=2,
                              monitor=False, device="cpu"),
        fault_hook=fault_hook, **kw)


def test_trainer_runs_and_checkpoints(tmp_path):
    out = _mk_trainer(tmp_path).run()
    assert out["final_step"] == 12
    assert ckpt.latest_step(str(tmp_path / "ck")) == 12
    assert np.isfinite(out["final_loss"])


def test_trainer_crash_restart_resumes(tmp_path):
    """Kill the job mid-run; a fresh Trainer must resume from the atomic
    checkpoint and reach the target step (fault-tolerance requirement)."""
    boom = {"armed": True}

    def fault(step):
        if step == 9 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    t1 = _mk_trainer(tmp_path, fault_hook=fault)
    with pytest.raises(RuntimeError):
        t1.run()
    # restart: resumes from step 8 checkpoint
    t2 = _mk_trainer(tmp_path)
    out = t2.run()
    assert out["final_step"] == 12


def test_deterministic_loss_after_restart(tmp_path):
    """Resumed run must see the same data stream -> same loss trajectory."""
    full = _mk_trainer(tmp_path / "a", total=8).run()
    t = _mk_trainer(tmp_path / "b", total=4)
    t.run()
    t2 = _mk_trainer(tmp_path / "b", total=8)
    resumed = t2.run()
    assert resumed["final_step"] == 8
    assert resumed["final_loss"] == pytest.approx(full["final_loss"],
                                                  rel=1e-3)


def test_trainer_checkpoints_nothing_when_told(tmp_path):
    t = _mk_trainer(tmp_path, total=3)
    t.tc.ckpt_every = 0
    assert t.run()["final_step"] == 3
    assert not (tmp_path / "ck").exists()


def test_trainer_matches_reference_trainer(tmp_path):
    """Both trainers from one tree, f32, the reference's on its compiled
    step: the same logged losses (the same data stream, step and
    optimizer)."""
    _jax()
    from repro.optim import adamw as R_adamw
    from repro.train import trainer as R_trainer
    c = _case("granite-3-2b")
    shape = ShapeSpec(*TRAIN)
    kw = dict(total_steps=5, ckpt_every=0, log_every=1, monitor=False)
    want = R_trainer.Trainer(
        c["rcfg"], shape, R_adamw.OptConfig(**STEP_OPT),
        R_trainer.TrainConfig(ckpt_dir=str(tmp_path / "r"), **{
            **kw, "ckpt_every": 10}))
    want.step_fn = _ref_step_fn("granite-3-2b", 1)
    want._init_state = lambda: (c["jp"], R_adamw.init(want.opt_cfg,
                                                      c["jp"]))
    got = Trainer(c["cfg"], shape, adamw.OptConfig(**STEP_OPT),
                  TrainConfig(ckpt_dir=str(tmp_path / "p"), device="cpu",
                              **kw),
                  params_fn=lambda: _clone(c["params"]))
    w, g = want.run()["metrics"], got.run()["metrics"]
    assert [m["step"] for m in g] == [m["step"] for m in w] == [1, 2, 3, 4,
                                                                5]
    for a, b in zip(g, w):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)


def test_step_telemetry_ofu_uses_the_trainer_chip():
    """The reference's StepTelemetry.ofu divides by the default chip's
    f_max whatever TrainConfig.chip says; the port's by its own."""
    tel = StepTelemetry(1, 0.5, 0.4, 1500.0, TPU_V6E_LIKE)
    assert tel.ofu == pytest.approx(0.4 * 1500.0 / TPU_V6E_LIKE.f_max_mhz)
    assert StepTelemetry(1, 0.5, 0.4, 1200.0).ofu == pytest.approx(
        0.4 * 1200.0 / TPU_V5E.f_max_mhz)
    t = Trainer(get_config("granite-3-2b").smoke(), ShapeSpec(*TRAIN),
                train_cfg=TrainConfig(chip=TPU_V6E_LIKE, device="cpu"),
                flops_per_step=1e12)
    tel = t._telemetry(1, 0.01)
    assert tel.chip is TPU_V6E_LIKE
    assert tel.ofu == pytest.approx(
        tel.tpa * tel.clock_mhz / TPU_V6E_LIKE.f_max_mhz)


def test_launch_train_main_runs_on_cpu_when_told(tmp_path, capsys):
    from repro_torch.launch.train import main
    out = main(["--arch", "mamba2-780m", "--smoke", "--steps", "2",
                "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "ck"),
                "--device", "cpu"])
    assert out["final_step"] == 2
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2
    assert '"final_step": 2' in capsys.readouterr().out


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Trainer(get_config("granite-3-2b").smoke(), ShapeSpec(*TRAIN))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_FLASH = [(2, 128, 128, 8, 2, 64, True), (1, 200, 200, 4, 4, 112, True),
              (1, 96, 160, 4, 2, 128, False)]
CARD_SSD = [(4, 256, 8, 64, 2, 64), (3, 64, 4, 64, 1, 128)]


def _card_tol(dtype):
    return dict(rtol=1e-3, atol=1e-3) if dtype == torch.float32 else \
        dict(rtol=5e-2, atol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_FLASH)
def test_card_flash_function_matches_plain_autograd(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    B, Sq, Sk, H, KV, hd, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               .requires_grad_()
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    cot = torch.randn((B, Sq, H, hd), generator=gen, device=cuda).to(dtype)
    n = flash_attention_kernel.launches
    got = _grads(lambda: ops.flash(q, k, v, causal=causal), (q, k, v), cot)
    assert flash_attention_kernel.launches == n + 1
    want = _grads(lambda: ref.ref_attention(q, k, v, causal=causal),
                  (q, k, v), cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **_card_tol(dtype))


#: the backward kernels' shapes (B, Sq, Sk, H, KV, hd, causal): hd 64 and
#: 128, GQA groups of 4, causal and full, Sq < Sk and Sq > Sk, ragged
#: lengths, and one granite-3-2b layer's slice (B 1 of its 8)
CARD_FLASH_BWD = {
    "g4-causal-hd64": (2, 256, 256, 8, 2, 64, True),
    "g4-full-hd128": (2, 256, 256, 8, 2, 128, False),
    "ragged-200-hd64": (1, 200, 200, 8, 2, 64, True),
    "ragged-1000-hd128": (1, 1000, 1000, 8, 2, 128, True),
    "sq-lt-sk-full-hd64": (1, 200, 330, 4, 1, 64, False),
    "sq-lt-sk-causal-hd128": (1, 130, 1000, 4, 1, 128, True),
    "sq-gt-sk-causal-hd128": (1, 330, 200, 8, 2, 128, True),
    "sq-gt-sk-full-hd64": (1, 1000, 200, 8, 2, 64, False),
    "granite-layer-slice": (1, 4096, 4096, 32, 8, 64, True),
}


def _rel_rms(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


def _bf16_grad_close(got, want, sigma, what):
    """The kernels' bf16 gradient against `flash_bwd_plain`'s in f32 on
    the same bf16 inputs.  The kernels round P and dS to bf16 before the
    products that take them (2^-9 of each summand, in no common
    direction) and the gradient once (2^-9 of it): each element within
    2^-6·|w| + 2^-5·σ + 2^-12·RMS(w), σ its summands' root-sum-square
    (`ref.flash_bwd_scales`; the card read at most 1.8e-2·σ, and a plain
    version rounding P and dS as the kernels do gave the same values to
    ~1e-4 where the f32 one was farthest), the last term the f32
    cancellation of dP − D where the gradient is exactly 0 (a causal
    first row); and the whole within 1e-2 of RMS(w) (the card read
    2.3e-3 to 2.5e-3).  A zeroed gradient fails both."""
    g, w = got.float(), want.float()
    rms = float(w.pow(2).mean().sqrt())
    over = (g - w).abs() - (2 ** -6 * w.abs() + 2 ** -5 * sigma
                            + 2 ** -12 * rms)
    bad = int((over > 0).sum())
    rel = _rel_rms(got, want)
    at = tuple(int(i) for i in torch.unravel_index(over.argmax(), w.shape))
    assert bad == 0 and rel < 1e-2, \
        f"{what}: {bad} elements beyond the limit, relative RMS {rel:.3e}; " \
        f"worst at {at}: got {float(g[at]):.4e}, want {float(w[at]):.4e}, " \
        f"summands' root-sum-square {float(sigma[at]):.4e}"


def _f32_sum_close(got, want, sigma, what):
    """The SSD backward's d dt or d dacs against `ssd_intra_bwd_plain`'s
    in f32 on the same bf16 inputs.  Both are f32 sums of f32 products of
    the same exact values (bf16 products accumulate exactly in f32),
    rounded nowhere, so they differ in the order of f32 additions alone:
    each element within 2^-12·σ + 2^-20·RMS(w), σ its summands'
    root-sum-square (`ref.ssd_bwd_scales`; the card read at most
    3.5e-5·σ), and the whole within 1e-5 of RMS(w) (the card read 4.4e-7
    to 1.7e-6).  Summing dM or M rounded to bf16 (2^-9 a summand) reads
    ~1e-3 of both."""
    g, w = got.double(), want.double()
    rms = float(w.pow(2).mean().sqrt())
    over = (g - w).abs() - (2 ** -12 * sigma.double() + 2 ** -20 * rms)
    bad = int((over > 0).sum())
    rel = float((g - w).pow(2).mean().sqrt()) / rms
    at = tuple(int(i) for i in torch.unravel_index(over.argmax(), w.shape))
    assert bad == 0 and rel < 1e-5, \
        f"{what}: {bad} elements beyond the limit, relative RMS {rel:.3e}; " \
        f"worst at {at}: got {float(g[at]):.6e}, want {float(w[at]):.6e}, " \
        f"summands' root-sum-square {float(sigma[at]):.4e}"


def _rounded_dm_plain(*ins):
    """`ssd_intra_bwd_plain` with dM = dY·Xᵀ rounded to bf16 where it
    forms it, so d dt and d dacs sum rounded values: the fault
    `_f32_sum_close` must reject."""
    einsum = torch.einsum

    def rounded(spec, *ops):
        out = einsum(spec, *ops)
        return out.bfloat16().to(out.dtype) \
            if spec == "zighp,zjghp->zghij" else out
    with mock.patch.object(torch, "einsum", rounded):
        return grad.ssd_intra_bwd_plain(*ins)


@pytest.mark.parametrize("k, name", [(1, "ddt"), (2, "ddacs")])
def test_ssd_f32_sum_limit_passes_f32_and_rejects_rounded_dm(k, name):
    """`_f32_sum_close`, the card test's limit on d dt and d dacs, on the
    CPU at one 64-row chunk pair: the plain backward in f32 against the
    same in f64 on the same bf16 inputs passes it, and the plain backward
    summing dM rounded to bf16 fails it."""
    ins = _ssd_card_inputs(torch.device("cpu"), 2, 128, 4, 64, 2, 64)
    f64 = [t.double() for t in ins]
    want = grad.ssd_intra_bwd_plain(*f64)[k]
    sigma = ref.ssd_bwd_scales(*f64)[k]
    f32 = [t.float() for t in ins]
    _f32_sum_close(grad.ssd_intra_bwd_plain(*f32)[k], want, sigma, name)
    with pytest.raises(AssertionError):
        _f32_sum_close(_rounded_dm_plain(*f32)[k], want, sigma,
                       f"{name} from dM rounded to bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_FLASH_BWD))
def test_card_flash_bwd_kernels_match_plain(cuda, case):
    """The backward's kernels (`grad.flash_bwd` routes bf16 at hd 64/128
    there) against `flash_bwd_plain` in f32, element by element, and
    against autograd of `ref.ref_attention` in f32, as a whole, both on
    the same bf16 inputs; two calls bitwise equal; one count on the
    kernel route."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KV, hd, causal = CARD_FLASH_BWD[case]
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    do = torch.randn((B, Sq, H, hd), generator=gen,
                     device=cuda).to(torch.bfloat16)
    scale = hd ** -0.5
    with torch.no_grad():
        o = fa.flash_attention_kernel(q, k, v, causal=causal)
    counts = grad.flash_bwd_routes()
    launches = fa.flash_attention_bwd_kernel.launches
    got = grad.flash_bwd(q, k, v, o, do, causal=causal, scale=scale)
    assert grad.flash_bwd_routes() == {"kernel": counts["kernel"] + 1,
                                       "plain": counts["plain"]}
    assert fa.flash_attention_bwd_kernel.launches == launches + 3
    again = grad.flash_bwd(q, k, v, o, do, causal=causal, scale=scale)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    plain = grad.flash_bwd_plain(*(t.float() for t in (q, k, v, o, do)),
                                 causal=causal, scale=scale)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    auto = _grads(lambda: ref.ref_attention(*leaves, causal=causal), leaves,
                  do.float())
    sigmas = ref.flash_bwd_scales(*(t.float() for t in (q, k, v, o, do)),
                                  causal=causal, scale=scale)
    for name, g, p, a, sg in zip(("dq", "dk", "dv"), got, plain, auto,
                                 sigmas):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        _bf16_grad_close(g, p, sg, f"{case} {name} vs flash_bwd_plain")
        # autograd of the f32 attention forms D from its own f32 output,
        # not the forward's bf16 O, which moves dq_i by scale·δD_i·(P·K)_i
        # on the first causal rows beyond the element limit: the whole
        # within 1e-2 of its RMS (the card read 2.5e-3 to 2.6e-3)
        assert _rel_rms(g, a) < 1e-2, f"{case} {name} vs autograd"
    with pytest.raises(AssertionError):
        _bf16_grad_close(torch.zeros_like(got[0]), plain[0], sigmas[0],
                         "dq zeroed")
    assert _rel_rms(torch.zeros_like(got[0]), auto[0]) >= 1e-2


@pytest.mark.gpu
def test_card_granite_step_takes_the_backward_kernels(cuda):
    """A granite-3-2b train step at full width (B 1, S 512) calls the
    backward once a layer, every call on the kernel route."""
    from repro_torch.configs.base import ShapeSpec as Shape
    cfg = get_config("granite-3-2b")
    params = init_params(cfg, device=cuda)
    state = adamw.init(adamw.OptConfig(), params)
    step = steps.make_train_step(cfg, adamw.OptConfig())
    batch = make_inputs(cfg, Shape("t", 512, 1, "train"), device=cuda)
    before = grad.flash_bwd_routes()
    _, _, aux = step(params, state, batch)
    assert torch.isfinite(aux["loss"])
    after = grad.flash_bwd_routes()
    assert {r: after[r] - before[r] for r in after} == {
        "kernel": cfg.num_layers, "plain": 0} == {"kernel": 40, "plain": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SSD)
def test_card_ssd_function_matches_plain_autograd(cuda, shape, dtype):
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    BC, Q, nh, hd, g, ds = shape
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((BC, Q, nh, hd), generator=gen, device=cuda).to(dtype)
    dt = torch.rand((BC, Q, nh), generator=gen, device=cuda) * 0.1
    A = -torch.rand(nh, generator=gen, device=cuda) * 4
    b, c = (torch.randn((BC, Q, g, ds), generator=gen, device=cuda)
            .to(dtype) * ds ** -0.5 for _ in range(2))
    ins = [t.requires_grad_() for t in (x, dt, A, b, c)]
    cot = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)

    def run(fn):
        return lambda: fn(x, dt, torch.cumsum(dt * A, 1), b, c)
    n = ssd_intra_kernel.launches
    got = _grads(run(ops.ssd_intra), ins, cot)
    assert ssd_intra_kernel.launches == n + 1
    want = _grads(run(ref.ref_ssd_intra), ins, cot)
    for gt, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(gt.float() / scale, w.float() / scale,
                                   **_card_tol(dtype))


#: the SSD backward kernels' shapes (BC, Q, nh, hd, g, ds): `CARD_SSD`'s
#: (a 64-row chunk: a strip half past Q), ds 256 with Q 320, and one
#: zamba2-7b-instruct layer's slice (4 of its 32 chunks)
CARD_SSD_BWD = {
    "card-ssd-g2": CARD_SSD[0],
    "card-ssd-q64-ds128": CARD_SSD[1],
    "q320-ds256": (2, 320, 4, 64, 2, 256),
    "zamba2-7b-instruct-slice": (4, 256, 112, 64, 2, 64),
}


def _ssd_card_inputs(cuda, BC, Q, nh, hd, g, ds, seed=12):
    """bf16 x, dy, b, c and f32 dt, dacs as a Mamba2 layer makes them:
    dt in (0, 0.1], dacs the within-chunk cumsum of dt·A, A in [-4, 0)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, dy = (torch.randn((BC, Q, nh, hd), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    b, c = ((torch.randn((BC, Q, g, ds), generator=gen, device=cuda)
             * ds ** -0.5).to(torch.bfloat16) for _ in range(2))
    dt = torch.rand((BC, Q, nh), generator=gen, device=cuda) * 0.1
    A = -torch.rand(nh, generator=gen, device=cuda) * 4
    return x, dt, torch.cumsum(dt * A, 1), b, c, dy


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_SSD_BWD))
def test_card_ssd_bwd_kernels_match_plain(cuda, case):
    """The backward's kernels (`grad.ssd_intra_bwd` routes bf16 at hd 64
    there) against `ssd_intra_bwd_plain` in f32 on the same inputs, each
    of the five gradients element by element within a limit of its
    summands' root-sum-square (`ref.ssd_bwd_scales`): dx, db and dc
    within `_bf16_grad_close`'s (the kernels round M and dG to bf16
    before their products and dX, dB, dC once), d dt and d dacs within
    `_f32_sum_close`'s, which must reject them summed from dM rounded to
    bf16; two calls bitwise equal; one count on the kernel route, three
    launches."""
    from repro_torch.kernels import ssd_scan
    ins = _ssd_card_inputs(cuda, *CARD_SSD_BWD[case])
    counts = grad.ssd_bwd_routes()
    launched = dict(ssd_scan.ssd_intra_bwd_kernel.launches_by)
    got = grad.ssd_intra_bwd(*ins)
    assert grad.ssd_bwd_routes() == {"kernel": counts["kernel"] + 1,
                                     "plain": counts["plain"]}
    now = ssd_scan.ssd_intra_bwd_kernel.launches_by
    assert {k: now[k] - launched[k] for k in now} == {"dg": 1, "dx": 1,
                                                      "dbdc": 1}
    again = grad.ssd_intra_bwd(*ins)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    f32 = [t.float() for t in ins]
    plain = grad.ssd_intra_bwd_plain(*f32)
    sigmas = ref.ssd_bwd_scales(*f32)
    rounded = _rounded_dm_plain(*f32)
    for name, g, p, sg, like, r in zip(("dx", "ddt", "ddacs", "db", "dc"),
                                       got, plain, sigmas, ins, rounded):
        assert g.dtype == like.dtype and g.shape == p.shape
        what = f"{case} {name} vs ssd_intra_bwd_plain"
        if name in ("ddt", "ddacs"):
            _f32_sum_close(g, p, sg, what)
            with pytest.raises(AssertionError):
                _f32_sum_close(r, p, sg, f"{what}, from dM rounded")
        else:
            _bf16_grad_close(g, p, sg, what)
    with pytest.raises(AssertionError):
        _bf16_grad_close(torch.zeros_like(got[0]), plain[0], sigmas[0],
                         "dx zeroed")


@pytest.mark.gpu
def test_card_ssd_bwd_kernels_complete_many_calls_in_a_row(cuda):
    """2,000 calls in a row at zamba2-7b-instruct's layer slice (more work
    items than SMs, so each block walks several) all complete, bitwise
    equal: with one warp of a warpgroup releasing the rings for all four,
    a late warp found its slot refilled and hung about one call in 1,000."""
    ins = _ssd_card_inputs(cuda, *CARD_SSD_BWD["zamba2-7b-instruct-slice"])
    first = grad.ssd_intra_bwd(*ins)
    for i in range(2000):
        got = grad.ssd_intra_bwd(*ins)
        if i % 100 == 99:
            torch.cuda.synchronize()
    assert all(torch.equal(g, f) for g, f in zip(got, first))


@pytest.mark.gpu
def test_card_zamba2_instruct_step_takes_the_ssd_bwd_kernels(cuda):
    """A zamba2-7b-instruct train step at full width (B 1, S 512) calls
    the SSD backward once a Mamba2 layer, every call on the kernel
    route."""
    from repro_torch.configs.base import ShapeSpec as Shape
    cfg = get_config("zamba2-7b-instruct")
    params = init_params(cfg, device=cuda)
    oc = adamw.OptConfig(moment_dtype="bfloat16", factored_v=True)
    state = adamw.init(oc, params)
    step = steps.make_train_step(cfg, oc)
    batch = make_inputs(cfg, Shape("t", 512, 1, "train"), device=cuda)
    before = grad.ssd_bwd_routes()
    _, _, aux = step(params, state, batch)
    assert torch.isfinite(aux["loss"])
    after = grad.ssd_bwd_routes()
    assert {r: after[r] - before[r] for r in after} == {
        "kernel": cfg.num_layers, "plain": 0} == {"kernel": 81, "plain": 0}


@pytest.mark.gpu
def test_card_kernels_raise_when_a_caller_bypasses_the_functions(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    q = torch.randn((1, 64, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="ops.flash"):
        flash_attention_kernel(q, q, q, causal=True)
    x = torch.randn((2, 64, 2, 64), device=cuda, requires_grad=True)
    dt = torch.rand((2, 64, 2), device=cuda)
    b = torch.randn((2, 64, 1, 64), device=cuda)
    with pytest.raises(RuntimeError, match="ops.ssd"):
        ssd_intra_kernel(x, dt, dt.cumsum(1), b, b)
    with torch.no_grad():           # no gradient wanted: the kernel runs
        flash_attention_kernel(q, q, q, causal=True)
        ssd_intra_kernel(x, dt, dt.cumsum(1), b, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "whisper-small", "zamba2-7b"])
def test_card_train_step_matches_cpu(cuda, arch):
    """A 2-layer (zamba2: 4-layer) smoke train step in f32 on the card
    against the CPU: loss, grad norm and every gradient leaf; the
    kernels launch in the forward and again in the recompute."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    params = init_params(cfg, device="cpu")
    batch = make_inputs(cfg, ShapeSpec(*TRAIN), device="cpu")
    oc = adamw.OptConfig(peak_lr=0.05, warmup_steps=1)
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        step = steps.make_train_step(cfg, oc)
        n = (flash_attention_kernel.launches, ssd_intra_kernel.launches)
        _, _, m = step(p, adamw.init(oc, p), {k: v.to(dev)
                                             for k, v in batch.items()})
        runs[str(dev)] = (m, step.grads, p)
    launched = (flash_attention_kernel.launches - n[0],
                ssd_intra_kernel.launches - n[1])
    groups = len(range(0, cfg.num_layers, cfg.attn_every or 1))
    want = {"llama3.2-3b": (2 * cfg.num_layers, 0),
            "mamba2-780m": (0, 2 * cfg.num_layers),
            "whisper-small": (2 * (cfg.encoder_layers + 2 * cfg.num_layers),
                              0),
            "zamba2-7b": (2 * groups, 2 * cfg.num_layers)}[arch]
    assert launched == want
    (mc, gc, pc), (mg, gg, pg) = runs["cpu"], runs[str(cuda)]
    for k in mc:
        assert float(mg[k]) == pytest.approx(float(mc[k]), rel=1e-4), k
    for path, w in _paths(gc).items():
        _close_rms(_paths(gg)[path].cpu(), w, f"{arch} grad {path}")
