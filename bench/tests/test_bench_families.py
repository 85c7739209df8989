"""A model family's plain reference is a file (`reference/families/`),
found by the family's name: a new one needs no edit of another file,
its units may read several parameter sources and the embedding's output,
and moving the existing families into files changed no leaf, weight or
FLOP count."""
import json
from dataclasses import asdict

import pytest
import torch

import harness
import inputs
import smoke
from frozen import flops
from reference import models, ops, train

CPU = torch.device("cpu")

TOY = '''
import torch

from reference import ops
from reference.models import Leaf, Unit, mat


def leaves(c):
    d, L, dt = c["d_model"], c["num_layers"], c["dtype"]
    return [mat(("blocks", "w"), (L, d, d), dt, stacked=True),
            Leaf(("blocks", "norm"), (L, d), dt, "ones", stacked=True),
            mat(("mix",), (d, d), dt, 4.0)]


def block(c, ps, x, e, prec):
    p, m = ps
    h = ops.rms_norm(x, p["norm"], c["norm_eps"])
    return x + torch.tanh(prec.mm(h, p["w"]) + prec.mm(e, m))


def units(c):
    return [Unit(block, ((("blocks",), i), (("mix",), None)))
            for i in range(c["num_layers"])]


def flops_per_token(c, seq):
    return c["num_layers"] * 2 * 2 * c["d_model"] ** 2
'''
TOY_SIZES = {"name": "toy", "family": "toy", "num_layers": 3, "d_model": 16,
             "vocab_size": 32, "dtype": "float32", "tie_embeddings": False,
             "norm_eps": 1e-5}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """Sizes of the toy family, whose file is the only one in the
    families folder the lookup reads."""
    fam = tmp_path / "families"
    fam.mkdir()
    (fam / "toy.py").write_text(TOY)
    monkeypatch.setattr(models, "FAMILIES", fam)
    return dict(TOY_SIZES)


def test_a_reference_family_added_as_a_file_is_found(toy):
    c = toy
    assert [lf.path for lf in models.layout(c)] == [
        ("embed",), ("final_norm",), ("blocks", "w"), ("blocks", "norm"),
        ("mix",), ("lm_head",)]
    us = models.units(c)
    assert [u.sources for u in us] == [
        ((("blocks",), i), (("mix",), None)) for i in range(3)]
    params = inputs.weights(c, 2**34 + 9, CPU)
    assert params["blocks"]["w"].shape == (3, 16, 16)
    assert params["mix"].shape == (16, 16)
    assert flops.forward_flops(c, 2, 8) == (3 * 4 * 16**2 + 2 * 16 * 32) * 16
    names = [n for lf in models.layout(c)
             for n, _ in train.pieces(lf, models.get(params, lf.path))]
    assert names == ["embed", "final_norm", "blocks/w[0]", "blocks/w[1]",
                     "blocks/w[2]", "blocks/norm[0]", "blocks/norm[1]",
                     "blocks/norm[2]", "mix", "lm_head"]
    tokens = torch.randint(0, 32, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    last = models.last_logits(c, params, tokens, ops.Prec("f32"))
    every = models.all_logits(c, params, tokens, ops.Prec("f32"))
    assert torch.equal(last, every[:, -1])
    # the units read e: the logits follow the mixing matrix
    mixed = dict(params, mix=2 * params["mix"])
    assert not torch.allclose(
        models.last_logits(c, mixed, tokens, ops.Prec("f32")), last)
    # the existing families are not in the folder the lookup reads
    with pytest.raises(ValueError, match="dense.py is missing"):
        models.layout(dict(c, family="dense"))


@pytest.mark.parametrize("tie", [False, True])
def test_a_family_files_gradient_matches_one_autograd_pass(toy, tie):
    c = dict(toy, tie_embeddings=tie)
    prec = ops.Prec("f32")
    params = inputs.weights(c, 2**33 + 21, CPU)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 32, (2, 12), generator=gen)
    labels = torch.randint(0, 32, (2, 12), generator=gen)
    loss, got = train.RefTrainer(c, smoke.TRAIN_MIX["optimizer"], params,
                                 prec).grads(tokens, labels)

    leaf = {lf.path: models.get(params, lf.path).detach().clone()
            .requires_grad_() for lf in models.layout(c)}
    tree: dict = {}
    for path, t in leaf.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    x = e = tree["embed"][tokens]
    for u in models.units(c):
        x = u.fn(c, models.views(tree, u), x, e, prec)
    h = ops.rms_norm(x, tree["final_norm"], c["norm_eps"])[:, :-1]
    h = h.reshape(-1, h.shape[-1])
    want = ops.token_nll_sum(h, models.head_weight(c, tree),
                             labels[:, 1:].reshape(-1), prec) / h.shape[0]
    want.backward()

    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    assert set(got) == set(leaf)
    for path, t in leaf.items():
        gap = float((got[path] - t.grad).norm() / t.grad.norm())
        assert gap < 1e-6, (path, gap)


GRANITE_STD, GRANITE_FF_STD = 0.022097086912079608, 0.011048543456039804
ZAMBA_STD, ZAMBA_FF_STD = 0.016703827619526525, 0.008351913809763262
SMOKE_STD, SMOKE_FF_STD = 0.125, 0.08838834764831843


def _dense_rows(prefix, lead, d, q, kv, ff, dt, std, ff_std):
    return [
        (prefix + ("attn", "wq"), lead + (d, q), dt, "normal", std),
        (prefix + ("attn", "wk"), lead + (d, kv), dt, "normal", std),
        (prefix + ("attn", "wv"), lead + (d, kv), dt, "normal", std),
        (prefix + ("attn", "wo"), lead + (q, d), dt, "normal", std),
        (prefix + ("mlp", "wi"), lead + (d, ff), dt, "normal", std),
        (prefix + ("mlp", "wo"), lead + (ff, d), dt, "normal", ff_std),
        (prefix + ("mlp", "wg"), lead + (d, ff), dt, "normal", std),
        (prefix + ("norm1",), lead + (d,), dt, "ones", 0.0),
        (prefix + ("norm2",), lead + (d,), dt, "ones", 0.0)]


#: (path, shape, dtype, init, std) of each leaf, in the order the
#: reference drew them before its families moved into files
LAYOUTS = {
    ("granite-3-2b", "full"): [
        (("embed",), (49155, 2048), "bfloat16", "normal", 0.02),
        (("final_norm",), (2048,), "bfloat16", "ones", 0.0),
        *_dense_rows(("dense_layers",), (40,), 2048, 2048, 512, 8192,
                     "bfloat16", GRANITE_STD, GRANITE_FF_STD)],
    ("granite-3-2b", "smoke"): [
        (("embed",), (256, 64), "float32", "normal", 0.02),
        (("final_norm",), (64,), "float32", "ones", 0.0),
        *_dense_rows(("dense_layers",), (2,), 64, 64, 32, 128, "float32",
                     SMOKE_STD, SMOKE_FF_STD)],
    ("zamba2-7b", "full"): [
        (("embed",), (32000, 3584), "bfloat16", "normal", 0.02),
        (("final_norm",), (3584,), "bfloat16", "ones", 0.0),
        (("layers", "norm"), (81, 3584), "bfloat16", "ones", 0.0),
        (("layers", "mixer", "in_proj"), (81, 3584, 14704), "bfloat16",
         "normal", ZAMBA_STD),
        (("layers", "mixer", "conv_w"), (81, 4, 7424), "bfloat16", "normal",
         0.25),
        (("layers", "mixer", "conv_b"), (81, 7424), "bfloat16", "zeros", 0.0),
        (("layers", "mixer", "A_log"), (81, 112), "float32", "a_log", 0.0),
        (("layers", "mixer", "D"), (81, 112), "float32", "ones", 0.0),
        (("layers", "mixer", "dt_bias"), (81, 112), "float32", "dt_bias",
         0.0),
        (("layers", "mixer", "out_norm"), (81, 7168), "bfloat16", "ones",
         0.0),
        (("layers", "mixer", "out_proj"), (81, 7168, 3584), "bfloat16",
         "normal", 0.01181138978153835),
        *_dense_rows(("shared_attn",), (), 3584, 3584, 3584, 14336,
                     "bfloat16", ZAMBA_STD, ZAMBA_FF_STD),
        (("lm_head",), (3584, 32000), "bfloat16", "normal", ZAMBA_STD)],
    ("zamba2-7b", "smoke"): [
        (("embed",), (256, 64), "float32", "normal", 0.02),
        (("final_norm",), (64,), "float32", "ones", 0.0),
        (("layers", "norm"), (4, 64), "float32", "ones", 0.0),
        (("layers", "mixer", "in_proj"), (4, 64, 328), "float32", "normal",
         SMOKE_STD),
        (("layers", "mixer", "conv_w"), (4, 4, 192), "float32", "normal",
         0.25),
        (("layers", "mixer", "conv_b"), (4, 192), "float32", "zeros", 0.0),
        (("layers", "mixer", "A_log"), (4, 8), "float32", "a_log", 0.0),
        (("layers", "mixer", "D"), (4, 8), "float32", "ones", 0.0),
        (("layers", "mixer", "dt_bias"), (4, 8), "float32", "dt_bias", 0.0),
        (("layers", "mixer", "out_norm"), (4, 128), "float32", "ones", 0.0),
        (("layers", "mixer", "out_proj"), (4, 128, 64), "float32", "normal",
         SMOKE_FF_STD),
        *_dense_rows(("shared_attn",), (), 64, 64, 32, 128, "float32",
                     SMOKE_STD, SMOKE_FF_STD),
        (("lm_head",), (64, 256), "float32", "normal", SMOKE_STD)],
}


def _sizes(name, size):
    if size == "smoke":
        return smoke.smoke_sizes(name)
    path = smoke.BENCH / "configs" / f"{name}.json"
    if path.exists():
        return json.loads(path.read_text())["as_run"]
    from repro_torch.configs.base import get_config
    return {k: v for k, v in asdict(get_config(name)).items()
            if k in smoke.SIZE_KEYS}


@pytest.mark.parametrize("name,size", sorted(LAYOUTS))
def test_the_families_layouts_are_unchanged(name, size):
    lay = models.layout(_sizes(name, size))
    assert [(lf.path, lf.shape, lf.dtype, lf.init, lf.std)
            for lf in lay] == LAYOUTS[name, size]
    # the leaves that stack layers are those the comparison split before
    assert [lf.stacked for lf in lay] == [
        lf.path[0] in ("layers", "dense_layers") for lf in lay]


@pytest.mark.parametrize("name", ["granite-3-2b", "zamba2-7b"])
def test_the_weights_drawn_are_unchanged(name):
    seed = 2**37 + 11
    got = inputs.weights(_sizes(name, "smoke"), seed, CPU)
    rows = LAYOUTS[name, "smoke"]
    for k, row in enumerate(rows):
        want = inputs.leaf(models.Leaf(*row), k, seed, CPU)
        assert torch.equal(models.get(got, row[0]), want), row[0]

    def count(tree):
        return sum(count(v) for v in tree.values()) \
            if isinstance(tree, dict) else 1
    assert count(got) == len(rows)


def test_a_list_valued_size_builds_the_registrys_tuple(tmp_path,
                                                       monkeypatch):
    from dataclasses import dataclass

    from repro_torch.configs import base

    @dataclass(frozen=True)
    class WithIds(base.ModelConfig):
        hybrid_layer_ids: tuple = ()

    root = smoke.make_root(tmp_path, {"t": ("granite-3-2b",
                                            smoke.TRAIN_MIX)})
    path = root / "bench" / "configs" / "granite-3-2b-smoke.json"
    conf = json.loads(path.read_text())
    conf["as_run"]["hybrid_layer_ids"] = [1, 3]
    path.write_text(json.dumps(conf))
    monkeypatch.setattr(base, "ModelConfig", WithIds)
    base.register(WithIds(**asdict(base.get_config("granite-3-2b-smoke")),
                          hybrid_layer_ids=(1, 3)))
    cell = harness.load_cell(root, "t")
    assert cell.sizes["hybrid_layer_ids"] == [1, 3]
    assert harness.model_config(cell).hybrid_layer_ids == (1, 3)


def test_smoke_sizes_keep_a_field_outside_the_size_keys(tmp_path):
    sizes = smoke.smoke_sizes("deepseek-moe-16b")
    assert "num_experts" not in smoke.SIZE_KEYS
    assert sizes["num_experts"] == 4 and sizes["top_k"] == 2
    root = smoke.make_root(tmp_path, {"t": ("deepseek-moe-16b",
                                            smoke.TRAIN_MIX)})
    cfg = harness.model_config(harness.load_cell(root, "t"))
    assert cfg.num_experts == 4
    # the groups of the families the benchmark runs have no such field
    for arch in ("granite-3-2b", "zamba2-7b"):
        assert set(smoke.smoke_sizes(arch)) <= set(smoke.SIZE_KEYS)
