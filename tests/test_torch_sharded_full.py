"""The dry run at full size on the production mesh (meta tensors):
zamba2-7b's and nemotron-4-340b's train_4k cells on 16 x 16, as one of
256 devices sees them.  Each record says 256 devices; its per-device
argument bytes (parameters, optimizer state and batch) equal the sum of
the local shards' bytes computed from the specs alone; its collectives
are nonzero; its peak fits one H100's 80 GB; no process group is left
open.  (The smoke-size checks against the reference are in
tests/test_torch_sharded.py.)
"""
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, input_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models import abstract_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_bytes(arch, shape_name, layout) -> int:
    """One device's argument bytes from the shapes and specs alone."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = M.make_production_mesh()
    dp, tp, fsdp = tuple(layout["dp"]), layout["tp"], layout["fsdp"]
    params = abstract_params(cfg)
    with torch.device("meta"):
        batch = {k: torch.empty(s.shape, dtype=s.dtype)
                 for k, s in input_specs(cfg, shape).items()}
    moment, _, factored = layout["opt"].partition("/")
    state = adamw.init(adamw.OptConfig(moment_dtype=moment,
                                       factored_v=bool(factored)), params)
    return (S.shard_bytes(params, S.param_shardings(
                cfg, params, mesh, dp, tp, fsdp), mesh)
            + S.shard_bytes(state, S.opt_state_shardings(
                state, mesh, dp, tp, fsdp), mesh)
            + S.shard_bytes(batch, S.batch_shardings(cfg, shape, mesh, dp,
                                                     tp), mesh))


@pytest.mark.parametrize("arch", ["zamba2-7b", "nemotron-4-340b"])
def test_full_size_train_step_on_the_production_mesh(arch):
    rec = dryrun.run_cell(arch, "train_4k")
    assert not dist.is_initialized()
    assert (rec["mesh"], rec["devices"]) == ("16x16", 256)
    assert rec["memory"]["argument_bytes"] == _spec_bytes(
        arch, "train_4k", rec["parallelism"])
    assert sum(rec["hlo"]["collective_bytes"].values()) > 0
    assert rec["memory"]["peak_bytes"] < 80e9
