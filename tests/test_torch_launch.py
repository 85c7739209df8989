"""The port's launch layer (`launch.{mesh,sharding,hlo_analysis,dryrun}`)
against the JAX package's on the same inputs.

  * sharding: every leaf's spec of the parameters, the optimizer state
    and the inputs equals `tuple()` of the reference's `PartitionSpec`
    on a `jax.sharding.AbstractMesh`, for all 10 archs on the 16x16 and
    2x16x16 meshes, FSDP on and off, serving on and off; the reference's
    own rule tests (`tests/test_system.py`) hold on the port;
  * `parallelism_for` equals the reference's on every arch x shape;
  * the dry run against the reference's compiled step on a one-device
    mesh (smoke configs, small train / prefill / decode shapes): the
    argument bytes, 6ND and the analytic FLOPs equal exactly; the traced
    FLOPs equal XLA's dot FLOPs exactly for prefill and decode once B3
    and B4 are counted as the reference's blockwise jnp versions compute
    them (every pair of every block), and the kernels' own formulas move
    only their own rows; a train step lies within [0.98, 1.05] of the
    reference's (the backward's named differences: ROADMAP);
  * the peak tracker on a known alloc/free sequence, and B3 on fake
    tensors at S = 8,192: the peak rises by its output only, no S x S;
    B4's SIMT path in an f32 Mamba2 step: each op adds its output and
    its C·Bᵀ scratch, as the launch allocates them.
"""
import json
import math
import os
from functools import partial

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec, input_specs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.hlo_analysis import (LiveBytes, analyze_step,  # noqa: E402,E501
                                             fake_mode, rounded)
from repro_torch.models import abstract_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "qwen3-4b",
         "nemotron-4-340b", "granite-3-2b", "llama3.2-3b", "whisper-small",
         "phi-3-vision-4.2b", "mamba2-780m", "zamba2-7b"]
#: one dense, one MoE, one hybrid SSM and the encoder-decoder arch
DRY_ARCHS = ["granite-3-2b", "deepseek-moe-16b", "zamba2-7b",
             "whisper-small"]
DRY_S, DRY_B = 64, 2
#: the reference's functions compiled with XLA's LLVM optimisations off
#: and the older CPU fusion emitter (as tests/test_torch_train.py)
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True,
             "xla_cpu_use_fusion_emitters": False,
             "xla_cpu_parallel_codegen_split_count": 1}
#: a train step's traced FLOPs over the reference's (ROADMAP names the
#: backward's differences, up to +4.04 % on deepseek-moe-16b's smoke step)
TRAIN_FLOPS_RATIO = (0.98, 1.05)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Traces of small tensors gain nothing from torch's thread pool,
    whose threads would only compete with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    return pytest.importorskip("jax")


def _ref_dryrun():
    """The reference's dry run: its import sets XLA_FLAGS to 512 host
    devices, which is put back at once so that nothing else in this
    process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as R
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return R


def _ref_mesh(multi: bool):
    jax = _jax()
    if multi:
        return jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return jax.sharding.AbstractMesh((16, 16), ("data", "model"))


_REF_PARAMS: dict = {}


def _ref_abstract(arch):
    if arch not in _REF_PARAMS:
        from repro.configs import get_config as R_get
        from repro.models import abstract_params as R_abstract
        _REF_PARAMS[arch] = R_abstract(R_get(arch))
    return _REF_PARAMS[arch]


def _flat(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}['{key}']").items()}
    return {path: tree}


def _ref_specs(tree) -> dict:
    jax = _jax()
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in leaves}


# ---------------------------------------------------------------------------
# the mesh and the sharding rules
# ---------------------------------------------------------------------------
def test_meshes_are_the_references_shapes():
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    big = M.make_production_mesh(multi_pod=True)
    assert big.axis_names == ("pod", "data", "model") and big.size == 512
    assert M.axes_of(big) == (("pod", "data"), "model")
    assert M.axes_of(M.make_production_mesh()) == (("data",), "model")
    assert M.make_smoke_mesh(1).shape == {"data": 1, "model": 1}
    for multi in (False, True):
        ref = _ref_mesh(multi)
        mine = M.make_production_mesh(multi_pod=multi)
        assert dict(ref.shape) == mine.shape
        from repro.launch.mesh import axes_of
        assert axes_of(ref) == M.axes_of(mine)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, multi):
    from repro.configs import get_config as R_get
    from repro.launch import sharding as RS
    rmesh, mesh = _ref_mesh(multi), M.make_production_mesh(multi_pod=multi)
    dp, tp = M.axes_of(mesh)
    cfg, params = get_config(arch), abstract_params(get_config(arch))
    jax = _jax()
    leaves = jax.tree_util.tree_flatten_with_path(_ref_abstract(arch))[0]
    for fsdp in (True, False):
        for serving in (False, True):
            # the reference's rule leaf by leaf: its NamedSharding refuses
            # some combinations (v3's experts over data twice under
            # serving with FSDP), which its dry run never asks for
            want = {jax.tree_util.keystr(p): tuple(RS.param_spec(
                jax.tree_util.keystr(p), x.shape, rmesh, dp, tp, fsdp,
                serving)) for p, x in leaves}
            got = _flat(S.param_shardings(cfg, params, mesh, dp, tp, fsdp,
                                          serving))
            assert got == want, (fsdp, serving)
    want = _ref_specs(RS.param_shardings(R_get(arch), _ref_abstract(arch),
                                         rmesh, dp, tp))
    assert _flat(S.param_shardings(cfg, params, mesh, dp, tp)) == want


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_shardings_match_reference(arch, multi):
    jax = _jax()
    from repro.launch import sharding as RS
    from repro.optim import adamw as R_adamw
    rmesh, mesh = _ref_mesh(multi), M.make_production_mesh(multi_pod=multi)
    dp, tp = M.axes_of(mesh)
    kw = {"moment_dtype": "bfloat16", "factored_v": True}
    ropt = jax.eval_shape(partial(R_adamw.init, R_adamw.OptConfig(**kw)),
                          _ref_abstract(arch))
    opt = adamw.init(adamw.OptConfig(**kw), abstract_params(get_config(arch)))
    for fsdp in (True, False):
        want = _ref_specs(RS.opt_state_shardings(ropt, rmesh, dp, tp, fsdp))
        got = _flat(S.opt_state_shardings(opt, mesh, dp, tp, fsdp))
        assert got == want, fsdp


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_and_parallelism_match_reference(arch, multi):
    """Every shape's input specs under the mesh's axes and under
    `parallelism_for`'s (pure DP has no tp axis), and `parallelism_for`
    itself, both policies."""
    from repro.configs import get_config as R_get
    from repro.configs.base import SHAPES as R_SHAPES
    from repro.launch import sharding as RS
    R = _ref_dryrun()
    rmesh, mesh = _ref_mesh(multi), M.make_production_mesh(multi_pod=multi)
    cfg, rcfg = get_config(arch), R_get(arch)
    for name, shape in SHAPES.items():
        for policy in ("auto", "baseline"):
            want = R.parallelism_for(rcfg, R_SHAPES[name], rmesh, policy)
            got = dryrun.parallelism_for(cfg, shape, mesh, policy)
            assert got == want, (name, policy)
        for dp, tp in {M.axes_of(mesh), got}:
            want = {k: tuple(v.spec) for k, v in RS.batch_shardings(
                rcfg, R_SHAPES[name], rmesh, dp, tp).items()}
            assert S.batch_shardings(cfg, shape, mesh, dp, tp) == want, \
                (name, dp, tp)


def _spec(path, shape):
    return S.param_spec(path, shape, M.make_production_mesh(), ("data",),
                        "model")


def test_param_specs_core_rules():
    """tests/test_system.py's rule test, on the port."""
    assert _spec("['layers']['attn']['wq']", (32, 2048, 4096)) \
        == (None, "data", "model")
    assert _spec("['layers']['attn']['wo']", (32, 4096, 2048)) \
        == (None, "model", "data")
    assert _spec("['moe_layers']['mlp']['experts']['wi']",
                 (58, 256, 7168, 2048)) == (None, "model", "data", None)
    assert _spec("['embed']", (128256, 4096)) == ("model", "data")
    assert _spec("['layers']['attn']['wq']", (12, 50, 50)) \
        == (None, None, None)
    assert _spec("['mu']['layers']['attn']['wq']['m']", (32, 2048, 4096)) \
        == (None, "data", "model")
    assert _spec("['mu']['layers']['attn']['wq']['v']['row']", (32, 2048)) \
        is not None


def test_batch_shardings_cover_all_inputs():
    """tests/test_system.py's batch test, on the port."""
    mesh = M.make_production_mesh()
    for arch in ("qwen3-4b", "deepseek-v3-671b", "mamba2-780m", "zamba2-7b",
                 "whisper-small", "phi-3-vision-4.2b"):
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if not cfg.supports_shape(shape):
                continue
            sh = S.batch_shardings(cfg, shape, mesh, ("data",), "model")
            specs = input_specs(cfg, shape)
            assert set(sh) == set(specs), (arch, sname)
            for k, spec in sh.items():
                dims = specs[k].shape
                for i, ax in enumerate(spec):
                    if ax is None or i >= len(dims):
                        continue
                    size = mesh.shape[ax] if isinstance(ax, str) else \
                        math.prod(mesh.shape[a] for a in ax)
                    assert dims[i] % size == 0, (arch, sname, k, i)


def test_serving_param_specs_ep2():
    """tests/test_system.py's serving test, on the port."""
    mesh = M.make_production_mesh()
    s = S.param_spec("['moe_layers']['mlp']['experts']['wi']",
                     (58, 256, 7168, 2048), mesh, ("data",), "model",
                     fsdp=False, serving=True)
    assert s == (None, ("data", "model"), None, None)
    s = S.param_spec("['moe_layers']['mlp']['experts']['wi']",
                     (27, 64, 2048, 1408), mesh, ("data",), "model",
                     fsdp=False, serving=True)
    assert s == (None, "model", None, None)
    s = S.param_spec("['dense_layers']['attn']['wq']", (61, 7168, 24576),
                     mesh, ("data",), "model", fsdp=False, serving=True)
    assert s == (None, None, "model")


# ---------------------------------------------------------------------------
# the dry run against the reference's compiled step
# ---------------------------------------------------------------------------
def _ref_blockwise_flops(q_shape, k_shape, v_shape, block: int = 512):
    """Dot FLOPs of the reference's blockwise jnp attention
    (`repro.models.common.flash_attention`): every pair of every key
    block, masked or not."""
    B, Sq, H, hd = q_shape
    Sk, hd_v = k_shape[1], v_shape[-1]
    blk = min(block, Sk)
    return 2 * (hd + hd_v) * B * H * Sq * math.ceil(Sk / blk) * blk


def _ref_ssd_flops(x_shape, b_shape):
    """Dot FLOPs of the reference's chunked jnp SSD: C·Bᵀ and M·X over
    every (Q x Q) pair of a chunk, for each head."""
    BC, Q, nh, hd = x_shape
    return 2 * (b_shape[-1] + hd) * BC * nh * Q * Q


def _port_record(arch, kind, monkeypatch):
    """The port's record, and the kernels' FLOPs counted both ways: by
    their own formulas and as the reference's jnp versions compute."""
    calls = {"flash": 0, "flash_ref": 0, "ssd": 0, "ssd_ref": 0}
    flash_flops, ssd_flops = fa.flash_flops, ssd_scan.ssd_flops

    def flash(q_shape, k_shape, causal, path):
        calls["flash_ref"] += _ref_blockwise_flops(q_shape, k_shape,
                                                   k_shape)
        n = flash_flops(q_shape, k_shape, causal, path)
        calls["flash"] += n
        return n

    def ssd(x_shape, b_shape):
        calls["ssd_ref"] += _ref_ssd_flops(x_shape, b_shape)
        n = ssd_flops(x_shape, b_shape)
        calls["ssd"] += n
        return n
    monkeypatch.setattr(fa, "flash_flops", flash)
    monkeypatch.setattr(ssd_scan, "ssd_flops", ssd)
    rec = dryrun.run_cell(get_config(arch).smoke(),
                          ShapeSpec(kind, DRY_S, DRY_B, kind))
    return rec, calls


_REF_CELLS: dict = {}


def _ref_cell(arch, kind):
    """The reference's `build_cell` for the same smoke cell on a
    one-device mesh, compiled: (argument bytes, HLO stats)."""
    key = (arch, kind)
    if key not in _REF_CELLS:
        R = _ref_dryrun()
        from repro.configs import get_config as R_get
        from repro.configs.base import ShapeSpec as RShape
        from repro.launch.hlo_analysis import analyze
        from repro.launch.mesh import make_smoke_mesh
        rcfg = R_get(arch).smoke()
        get, shapes = R.get_config, R.SHAPES
        R.get_config = lambda name: rcfg
        R.SHAPES = {kind: RShape(kind, DRY_S, DRY_B, kind)}
        try:
            mesh = make_smoke_mesh(1)
            fn, args, _, _ = R.build_cell(arch, kind, mesh)
            with mesh:
                comp = fn.lower(*args).compile(compiler_options=_XLA_FAST)
        finally:
            R.get_config, R.SHAPES = get, shapes
        _REF_CELLS[key] = (comp.memory_analysis().argument_size_in_bytes,
                           analyze(comp.as_text(), 1))
    return _REF_CELLS[key]


@pytest.mark.filterwarnings("ignore:Some donated buffers")
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_dry_run_matches_reference(arch, kind, monkeypatch):
    from repro.configs import get_config as R_get
    from repro.configs.base import ShapeSpec as RShape
    from repro.flops.accounting import model_flops_6nd as R_6nd
    from repro.flops.accounting import step_flops as R_step
    arg_bytes, st = _ref_cell(arch, kind)
    rec, calls = _port_record(arch, kind, monkeypatch)
    rcfg, rshape = R_get(arch).smoke(), RShape(kind, DRY_S, DRY_B, kind)
    assert rec["memory"]["argument_bytes"] == arg_bytes
    analytic = R_step(rcfg, rshape, executed=True,
                      remat=(rcfg.remat != "none"))
    assert rec["model_flops_6nd"] == R_6nd(rcfg, rshape)
    assert rec["analytic_mxu_flops"] == analytic.total_mxu
    assert rec["analytic_vpu_flops"] == analytic.total_vpu
    assert rec["mesh"] == "1" and rec["devices"] == 1
    assert rec["cost_raw"] == {"flops": rec["hlo"]["flops"],
                               "bytes_accessed": rec["hlo"]["traffic_bytes"]}
    assert set(rec["hlo"]["collective_bytes"]) == set(st.collective_bytes)
    assert not any(rec["hlo"]["collective_bytes"].values())
    # the kernels' own formulas move only their own rows
    rows = rec["hlo"]["flops_by_op"]
    assert rows.get("repro_torch.flash_attention", 0) == calls["flash"]
    assert rows.get("repro_torch.ssd_intra", 0) == calls["ssd"]
    as_ref = rec["hlo"]["flops"] - calls["flash"] - calls["ssd"] \
        + calls["flash_ref"] + calls["ssd_ref"]
    if kind == "train":
        lo, hi = TRAIN_FLOPS_RATIO
        assert lo <= as_ref / st.flops <= hi, as_ref / st.flops
    else:
        assert as_ref == st.flops


# ---------------------------------------------------------------------------
# the tracker, and B3 on fake tensors
# ---------------------------------------------------------------------------
def test_tracker_on_a_known_sequence():
    """Allocations of 1,024, 2,048 and 512 bytes with the first freed
    between: live 1,024 -> 3,072 -> 2,048 -> 2,560; a 100-byte argument
    (512 held); an in-place op and a view allocate nothing."""
    def step(x):
        a = torch.empty(256, device=x.device)                   # 1,024 B
        b = torch.empty(512, device=x.device)                   # 2,048 B
        del a
        c = torch.empty(128, device=x.device)                   # 512 B
        c.add_(1.0)
        return (b.view(2, 256), c.view(-1))
    with fake_mode():
        x = torch.empty(25, device="meta")                      # 100 B
    st = analyze_step(step, x)
    assert (st.argument_bytes, st.peak_bytes, st.temp_bytes) \
        == (0, 512 + 3072, 3072)          # x is never read: 0 argument bytes
    assert st.output_bytes == 2048 + 512
    assert st.traffic_bytes == 2 * (1024 + 2048 + 512)
    assert rounded(1) == 512 and rounded(1024) == 1024

    tracker = LiveBytes()
    with fake_mode():
        y = torch.empty(300, device="meta")                     # 1,200 B
    assert tracker.hold([y, y.view(3, 100)]) == (1200, 1536)


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_fake_flash_at_8192_holds_no_scores(device):
    """B3 on fake tensors at Sq = Sk = 8,192 (its op's fake version):
    the peak rises by the output's bytes only, where the plain version's
    f32 scores alone would be 4 x 8,192^2 x 4 bytes (1 GiB); its FLOPs
    are the kernel's formula's; nothing is launched or counted."""
    B, Sq, H, hd = 1, 8192, 4, 64
    with fake_mode():
        q, k, v = (torch.empty((B, Sq, H, hd), dtype=torch.bfloat16,
                               device=device) for _ in range(3))
    before = dict(fa.flash_attention_kernel.launches_by)
    st = analyze_step(
        lambda q, k, v: fa.flash_attention_kernel(q, k, v, causal=True),
        q, k, v)
    out = B * Sq * H * hd * 2
    assert st.temp_bytes == out == st.output_bytes
    assert st.peak_bytes == 3 * out + out
    assert st.flops == fa.flash_flops((B, Sq, H, hd), (B, Sq, H, hd), True,
                                      "wgmma_bf16")
    assert fa.flash_attention_kernel.launches_by == before


def test_fake_ssd_counts_its_formula_and_launches_nothing():
    BC, Q, nh, hd, g, ds = 4, 256, 8, 64, 1, 64
    with fake_mode():
        x = torch.empty((BC, Q, nh, hd), dtype=torch.bfloat16, device="meta")
        dt, dacs = (torch.empty((BC, Q, nh), device="meta") for _ in "ab")
        b, c = (torch.empty((BC, Q, g, ds), dtype=torch.bfloat16,
                            device="meta") for _ in "ab")
    n = ssd_scan.ssd_intra_kernel.launches
    st = analyze_step(ssd_scan.ssd_intra_kernel, x, dt, dacs, b, c)
    assert st.flops == BC * nh * Q * (Q + 1) // 2 * (2 * (ds + hd) + 4)
    assert st.temp_bytes == x.numel() * 2
    assert ssd_scan.ssd_intra_kernel.launches == n


class _SsdSteps(LiveBytes):
    """A tracker that also notes, for each SSD op of the trace, the live
    bytes just before it and just after it returns."""

    def __init__(self):
        super().__init__()
        self.ssd: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.live
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if "ssd_intra" in str(func):
            self.ssd.append((tuple(args[0].shape), tuple(args[3].shape),
                             before, self.live))
        return out


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dry_run_counts_the_simt_ssd_scratch(kind):
    """An f32 Mamba2 smoke step takes the SIMT SSD, whose launch
    allocates its C·Bᵀ scratch beside the output: every SSD op of the
    trace adds both to the live bytes, and the step's peak holds them."""
    import dataclasses
    cfg = dataclasses.replace(get_config("mamba2-780m").smoke(),
                              dtype="float32")
    tracker = _SsdSteps()
    rec = dryrun.run_cell(cfg, ShapeSpec(kind, DRY_S, DRY_B, kind),
                          trackers=[tracker])
    assert tracker.ssd, "the step traced no SSD op"
    for x_shape, b_shape, before, after in tracker.ssd:
        BC, Q, nh, hd = x_shape
        assert ssd_scan.variant(torch.float32, Q, hd, b_shape[-1]) == "simt"
        scratch = ssd_scan.simt_scratch(BC, Q, b_shape[2]) * 4
        assert scratch > 0
        assert after - before == rounded(math.prod(x_shape) * 4) \
            + rounded(scratch)
    assert rec["memory"]["peak_bytes"] == tracker.peak \
        >= max(after for *_, after in tracker.ssd)


def test_flash_formula_counts_the_tilings():
    """wgmma: 128-row tiles by 128 keys (64 past hd 128) up to each
    tile's diagonal; SIMT: 128-row tiles (64 past hd 128) by 64 keys up
    to each tile's diagonal."""
    assert fa.flash_flops((1, 256, 1, 64), (1, 256, 1, 64), True,
                          "wgmma_bf16") == 4 * 64 * 128 * (128 + 256)
    assert fa.flash_flops((1, 256, 1, 192), (1, 256, 1, 192), True,
                          "wgmma_bf16") == 4 * 192 * 128 * (128 + 256)
    assert fa.flash_flops((2, 100, 3, 64), (2, 200, 1, 64), False,
                          "wgmma_bf16") == 4 * 64 * 6 * 128 * 256
    assert fa.flash_flops((1, 64, 1, 16), (1, 64, 1, 16), True,
                          "simt") == 4 * 16 * 128 * 64
    assert fa.flash_flops((1, 70, 1, 16), (1, 40, 1, 16), True,
                          "simt") == 4 * 16 * 128 * 64


def _simt_pairs_by_enumeration(Sq, Sk, hd, causal):
    """The (query, key) pairs the SIMT flash kernel computes, counted one
    by one over its loops: each block of `rows` query rows (the rows past
    Sq included) takes 64-key tiles from key 0 while a tile starts below
    its key limit: Sk, or under `causal` the block's last row + 1 (at
    most Sk); every row of the block meets every key slot of a tile."""
    rows = 64 if hd > 128 else 128
    pairs = 0
    for q0 in range(0, Sq, rows):
        limit = min(Sk, q0 + rows) if causal else Sk
        for j0 in range(0, limit, 64):
            for _row in range(q0, q0 + rows):
                for _key in range(j0, j0 + 64):
                    pairs += 1
    return pairs


@pytest.mark.parametrize("Sq,Sk,hd", [
    (256, 256, 64),          # whole tiles
    (100, 300, 96),          # Sq < Sk
    (300, 100, 112),         # Sq > Sk
    (130, 131, 128),         # ragged both ways
    (200, 230, 192),         # 64-row blocks past hd 128
    (1, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_simt_formula_matches_an_enumeration_of_its_tiles(Sq, Sk, hd,
                                                                causal):
    B, H = 2, 3
    want = 4 * hd * B * H * _simt_pairs_by_enumeration(Sq, Sk, hd, causal)
    assert fa.flash_flops((B, Sq, H, hd), (B, Sk, 1, hd), causal,
                          "simt") == want


def test_main_writes_records_and_skips(tmp_path, capsys):
    out = str(tmp_path)
    dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                 "--out", out])
    dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                 "--out", out])
    rec = json.loads((tmp_path / "granite-3-2b_decode_32k_single.json")
                     .read_text())
    assert rec["trace_device"] == dryrun.trace_device()
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["parallelism"]["serving"] is True
    skipped = json.loads((tmp_path / "granite-3-2b_long_500k_single.json")
                         .read_text())
    assert skipped["skipped"] is True
    dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                 "--out", out])
    assert "[skip-cached] granite-3-2b_decode_32k_single" \
        in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "granite-3-2b"])


def test_trace_device_follows_the_build():
    assert dryrun.trace_device() == (
        "cuda" if torch.backends.cuda.is_built() else "meta")
