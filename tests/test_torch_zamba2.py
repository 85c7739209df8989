"""The port's zamba2 family (Zamba2-7B-Instruct) on the CPU: the
registry's published shapes, the shared blocks' invocation counter and
the `model.shared_block` span around each invocation, the train step's
per-invocation gradient leaves, the grouped gated norm and decode's
refusal.  The program against the plain reference and `transformers`
is in `bench/tests/test_bench_zamba2.py`."""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.data import synthetic_batch, to_device  # noqa: E402
from repro_torch.models import api, init_params, ssm  # noqa: E402
from repro_torch.models import ssm_models  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deep():
    """The published layer pattern, 81 layers and 13 invocations, at the
    smoke widths."""
    return dataclasses.replace(get_config("zamba2-7b-instruct").smoke(),
                               num_layers=81, shared_block_layers=IDS,
                               dtype="float32")


def _batch(cfg, S=8):
    return to_device(cfg, synthetic_batch(cfg, ShapeSpec("t", S, 1, "train"),
                                          0, seed=3), "cpu")


def test_the_registry_holds_the_published_shapes():
    cfg = get_config("zamba2-7b-instruct")
    p = api.abstract_params(cfg)
    assert p["shared_blocks"]["attn"]["wq"].shape == (2, 7168, 32 * 224)
    assert p["shared_blocks"]["attn"]["wo"].shape == (2, 32 * 224, 3584)
    assert p["shared_blocks"]["mlp"]["gate_up"].shape == (2, 3584, 28672)
    assert p["shared_blocks"]["mlp"]["down"].shape == (2, 14336, 3584)
    assert p["shared_blocks"]["norm1"].shape == (2, 7168)
    assert p["adapters"]["lora_a"].shape == (13, 3584, 128)
    assert p["adapters"]["lora_b"].shape == (13, 128, 28672)
    assert p["linears"].shape == (13, 3584, 3584)
    assert p["layers"]["mixer"]["in_proj"].shape == (81, 3584, 14704)
    assert "lm_head" not in p
    assert api.param_count(p) == 7_356_749_648


def test_a_forward_counts_13_invocations_7_on_a_and_6_on_b():
    cfg = _deep()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ssm_models.shared_block.invocations_by = {}
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        api.forward(cfg, params, _batch(cfg))
    assert ssm_models.shared_block.invocations_by == {0: 7, 1: 6}
    ev = prof.events()
    blocks = [e.time_range for e in ev if e.name == spans.SHARED_BLOCK]
    assert len(blocks) == 13
    # the span holds each invocation's nine products (q, k, v, o, the
    # adapter's two, gate_up, down and the linear) and none of a Mamba
    # layer's two (in_proj, out_proj) or the head's
    mm = [e.time_range for e in ev if e.name == "aten::matmul"]
    inside = [any(b.start <= m.start and m.end <= b.end for b in blocks)
              for m in mm]
    assert (sum(inside), len(mm) - sum(inside)) == (13 * 9, 81 * 2 + 1)


def test_a_train_step_runs_each_invocation_in_its_forward_and_recompute():
    cfg = _deep()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw.OptConfig(warmup_steps=1)
    step = steps.make_train_step(cfg, opt)
    ssm_models.shared_block.invocations_by = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, adamw.init(opt, params), _batch(cfg))
    n = collections.Counter(e.name for e in prof.events()
                            if e.name in (spans.SHARED_BLOCK,
                                          spans.RECOMPUTE))
    # one remat a layer: an invocation recomputes with its Mamba layer
    assert n == {spans.SHARED_BLOCK: 26, spans.RECOMPUTE: 81}
    assert ssm_models.shared_block.invocations_by == {0: 14, 1: 12}
    g = step.grads
    for tree, lead in ((g["shared_blocks"], 2), (g["adapters"], 13),
                       (g["linears"], 13)):
        for t in (tree.values() if isinstance(tree, dict) else [tree]):
            for x in (t.values() if isinstance(t, dict) else [t]):
                assert x.shape[0] == lead
                assert all(float(x[i].norm()) > 0 for i in range(lead))


def test_the_stacked_subtrees_become_per_layer_gradient_leaves():
    cfg = dataclasses.replace(get_config("zamba2-7b-instruct").smoke(),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    grads = tree_map(torch.zeros_like, params)
    model, _ = steps.grad_leaves(params, grads)
    assert isinstance(model["linears"], list) and len(model["linears"]) == 4
    wq = model["shared_blocks"]["attn"]["wq"]
    assert isinstance(wq, list) and len(wq) == 2
    assert wq[1].grad.data_ptr() == \
        grads["shared_blocks"]["attn"]["wq"][1].data_ptr()
    assert wq[1].data_ptr() == params["shared_blocks"]["attn"]["wq"][1] \
        .data_ptr()


def test_the_grouped_gated_norm_normalises_each_group():
    cfg = get_config("zamba2-7b-instruct").smoke()
    g, di = cfg.ssm_ngroups, cfg.d_inner
    gen = torch.Generator().manual_seed(2)
    y, z = (torch.randn(2, 3, di, generator=gen) for _ in range(2))
    w = torch.rand(di, generator=gen) + 0.5
    out = ssm.gated_norm(cfg, y, z, w)
    h = (y * torch.nn.functional.silu(z)).reshape(2, 3, g, di // g)
    want = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + cfg.norm_eps)
    assert torch.allclose(out, want.reshape(2, 3, di) * w, atol=1e-6)
    whole = ssm.gated_norm(dataclasses.replace(cfg, ssm_grouped_norm=False),
                           y, z, w)
    assert not torch.allclose(out, whole, atol=1e-3)


def test_decode_names_the_family_it_does_not_implement():
    cfg = get_config("zamba2-7b-instruct").smoke()
    with pytest.raises(NotImplementedError, match="zamba2"):
        api.decode_step(cfg, {}, {})
