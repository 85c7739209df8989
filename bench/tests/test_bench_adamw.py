"""The reference's AdamW against the program's on leaves wide enough to
take the factored second moment, stacked and not, in f32 and with the
configured bf16 moment."""
import copy

import pytest
import torch

import inputs
import smoke
from reference import ops
from reference.models import get, layout
from reference.train import RefTrainer

SIZES = dict(smoke.smoke_sizes("granite-3-2b"), d_model=128, d_ff=256,
             num_heads=4, num_kv_heads=2, head_dim=32, name="adamw-test")


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_reference_adamw_matches_the_programs(moment):
    from repro_torch.optim import adamw
    o = dict(smoke.TRAIN_MIX["optimizer"], moment_dtype=moment)
    cpu = torch.device("cpu")
    ref_p = inputs.weights(SIZES, 5, cpu)
    prog_p = copy.deepcopy(ref_p)
    opt = adamw.OptConfig(**o)
    state = adamw.init(opt, prog_p)
    ref = RefTrainer(SIZES, o, ref_p, ops.Prec("f32"))
    assert any(isinstance(v, tuple) and v[0].ndim == 2
               for v in ref.v.values())          # stacked and factored
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        g = {lf.path: torch.randn(lf.shape, generator=gen)
             for lf in layout(SIZES)}
        tree = copy.deepcopy(prog_p)
        for lf in layout(SIZES):
            node = tree
            for k in lf.path[:-1]:
                node = node[k]
            node[lf.path[-1]] = g[lf.path].clone()
        adamw.update(opt, tree, state, prog_p)
        ref.update(g)
    for lf in layout(SIZES):
        a, b = get(prog_p, lf.path), get(ref_p, lf.path)
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-5), lf.path
