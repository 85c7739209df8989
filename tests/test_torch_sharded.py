"""The port's dry run on a device mesh: DTensors over a fake process
group, each cell traced as one device of the mesh sees it.

  * (a) the collective reader on a known sequence: an all-gather, a
    reduce-scatter, an all-reduce and an all-to-all of known sizes on a
    fake 8-rank (2, 4) mesh give the reference's wire bytes and counts;
  * (b) a device's FLOPs are counted once: the product of an
    (8, 256) x (256, 512) split [Shard(0), Replicate()] x
    [Replicate(), Shard(1)] counts the local shards' 262,144;
  * (c) the reference's `build_cell` compiled on a jax (2, 4) mesh
    (smoke configs, in one subprocess) against the port's record on the
    same (2, 4) mesh: argument bytes equal exactly; the FLOPs, the
    kernels counted as the reference's jnp versions compute them, equal
    for prefill and decode but in the cells ROADMAP names (held at their
    ratio), and within `TRAIN_FLOPS_RATIO` for train; the collectives'
    total at each cell's ratio to the reference's (`COLLECTIVE_RATIO`,
    ROADMAP), and every kind
    the reference uses present in the port (or its DTensor counterpart:
    `KIND_STANDS_IN`);
  * (d) real sharded execution: 4 `gloo` ranks on a (2, 2) mesh run
    smoke zamba2-7b, granite-3-2b and deepseek-moe-16b in f32 (and a
    decode step on a (1, 4) mesh, whose caches split the sequence); the
    prefill and decode logits, the caches the decode wrote, one train
    step's loss and updated parameters equal
    the single-process port's within 1e-5 of the row RMS (the step's
    part of a parameter, the gradients and the decode's caches, sums of
    f32 terms in another order, within 1e-4 of theirs);
  * (e), the full-size train cells on the 16 x 16 mesh, is
    tests/test_torch_sharded_full.py (its own file, so that another
    worker runs it beside these);
  * the roofline's collective term and `report`'s tables carry a mesh
    record's wire bytes.

Batch 8 at smoke size: the smallest batch the (2, 4) mesh splits over
all eight devices, as the production meshes split theirs (ROADMAP: a
batch the mesh does not divide stays whole on the port, where XLA pads
it).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze_step  # noqa: E402

DRY_ARCHS = ["granite-3-2b", "deepseek-moe-16b", "zamba2-7b",
             "whisper-small"]
KINDS = ["train", "prefill", "decode"]
MESH_S, MESH_B = 64, 8
#: a train step's traced FLOPs over the reference's (as
#: tests/test_torch_launch.py holds the one-device steps)
TRAIN_FLOPS_RATIO = (0.98, 1.05)
#: cells whose per-device FLOPs XLA's partitioner and DTensor split
#: differently (ROADMAP's deliberate differences), at their ratio
FLOPS_RATIO = {("deepseek-moe-16b", "decode"): 0.9595}
#: the port's collective wire bytes over the reference's, each cell at
#: its measured ratio (ROADMAP's deliberate differences: XLA all-reduces
#: the row-parallel products' partial sums whole where DTensor
#: reduce-scatters them to the sequence split the constraints name,
#: exchanges halos by permutes, and gathers other operands)
COLLECTIVE_RATIO = {
    ("granite-3-2b", "train"): 0.4198,
    ("granite-3-2b", "prefill"): 0.2833,
    ("granite-3-2b", "decode"): 0.4386,
    ("deepseek-moe-16b", "train"): 0.2258,
    ("deepseek-moe-16b", "prefill"): 0.2312,
    ("deepseek-moe-16b", "decode"): 0.4546,
    ("zamba2-7b", "train"): 0.2729,
    ("zamba2-7b", "prefill"): 0.2991,
    ("zamba2-7b", "decode"): 0.9283,
    ("whisper-small", "train"): 0.4087,
    ("whisper-small", "prefill"): 0.3315,
    ("whisper-small", "decode"): 0.6362,
}
#: the kinds DTensor moves the same data with where XLA uses another
#: (ROADMAP): an all-reduce as a reduce-scatter and an all-gather, a
#: collective-permute (halo exchange, shifts) or an all-to-all as an
#: all-gather
KIND_STANDS_IN = {"all-reduce": ("all-reduce", "reduce-scatter"),
                  "collective-permute": ("collective-permute",
                                         "all-gather"),
                  "all-to-all": ("all-to-all", "all-gather"),
                  "all-gather": ("all-gather",),
                  "reduce-scatter": ("reduce-scatter",)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    """The fake (2, 4) ("data", "model") mesh, its device type the card's
    (a "cpu" mesh's all-to-all is an all-gather)."""
    return M.make_smoke_mesh(4, data=2, device_type="cuda")


# ---------------------------------------------------------------------------
# (a), (b): the reader and the FLOP counter on known sequences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis,g", [("model", 4), ("data", 2)])
def test_collective_reader_on_a_known_sequence(axis, g):
    """On one mesh axis of g devices: an all-gather of a (4, 256) f32
    shard into (4g, 256), an all-reduce of (4, 256), a reduce-scatter of
    (4, 256) into (4/g, 256), an all-to-all of a (4, 256) shard; result
    bytes x (g-1)/g each, twice that for the all-reduce."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = _mesh()
    i = mesh.axis_names.index(axis)

    def on(p):
        out = [Replicate(), Replicate()]
        out[i] = p
        return out

    def step(x):
        dm = mesh.device_mesh
        DTensor.from_local(x, dm, on(Shard(0)), run_check=False) \
            .redistribute(dm, on(Replicate()))                  # all-gather
        part = DTensor.from_local(x, dm, on(Partial()), run_check=False)
        part.redistribute(dm, on(Replicate()))                  # all-reduce
        part.redistribute(dm, on(Shard(0)))                     # reduce-scatter
        DTensor.from_local(x, dm, on(Shard(0)), run_check=False) \
            .redistribute(dm, on(Shard(1)))                     # all-to-all
    with M.fake_world(8):
        st = analyze_step(step, torch.empty(4, 256, device="meta"))
    frac, n = (g - 1) / g, 4 * 256 * 4
    assert st.collective_bytes == {
        "all-gather": g * n * frac, "all-reduce": 2 * n * frac,
        "reduce-scatter": n // g * frac, "all-to-all": n * frac,
        "collective-permute": 0.0}
    assert st.collective_counts == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 0}
    assert not dist.is_initialized()


def test_a_devices_flops_are_counted_once():
    """DTensor runs the product on global-shaped fake tensors to learn
    its output's shape, then on the local shards: only the latter are a
    device's, 2 x 4 x 256 x 128 FLOPs of the global 2 x 8 x 256 x 512."""
    mesh = _mesh()
    with M.fake_world(8):
        a = S.distribute(torch.empty(8, 256, device="meta"), ("data", None),
                         mesh)
        b = S.distribute(torch.empty(256, 512, device="meta"),
                         (None, "model"), mesh)
        st = analyze_step(lambda a, b: a @ b, a, b)
    assert st.flops == 262_144
    assert st.argument_bytes == (4 * 256 + 256 * 128) * 4
    assert st.output_bytes == 4 * 128 * 4
    assert not any(st.collective_bytes.values())
    ctx = M.make_ctx(M.make_production_mesh(multi_pod=True))
    assert (ctx.dp, ctx.tp, ctx.ep_axes) == (("pod", "data"), "model",
                                             "model")


def test_factored_adamw_allocates_no_more_than_a_devices_block():
    """The factored second moment's rank-1 reconstruction row ⊗ col is
    formed on each device's own (d/2, f/4) block of a layer's parameter:
    no op of the update allocates more than that block in f32.  DTensor's
    broadcast rule, left to itself, may gather a factor whole first and
    the product with it (PyTorch 2.11 does): a 4x larger temporary here,
    30 GiB a device for nemotron-4-340b's MLP on the 16 x 16 mesh."""
    from repro_torch.launch.hlo_analysis import LiveBytes
    from repro_torch.optim import adamw
    mesh = _mesh()
    oc = adamw.OptConfig(factored_v=True)
    spec = (None, "data", "model")
    tracker = LiveBytes()
    with M.fake_world(8):
        with torch.device("meta"):
            p = torch.empty(2, 256, 512)
            state = adamw.init(oc, {"w": p})
        state = S.distribute_tree(state, {
            "mu": {"w": {"m": spec, "v": {"row": (None, "data"),
                                          "col": (None, "model")}}},
            "count": ()}, mesh)
        p, g = (S.distribute(torch.empty(2, 256, 512, device="meta"), spec,
                             mesh) for _ in range(2))
        analyze_step(lambda p, g, st: adamw.update(oc, {"w": g}, st,
                                                   {"w": p}),
                     p, g, state, trackers=[tracker])
    assert max(r for label, r, *_ in tracker._log
               if label != "argument") == 128 * 128 * 4


# ---------------------------------------------------------------------------
# (c) the reference's compiled cells on a jax (2, 4) mesh
# ---------------------------------------------------------------------------
_REF_SCRIPT = r'''
import json, os, sys
import numpy as np
import jax
saved = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as R
os.environ["XLA_FLAGS"] = saved
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.hlo_analysis import analyze
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False,
        "xla_cpu_parallel_codegen_split_count": 1}
S, B, archs, kinds = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
out = {}
for arch in archs.split(","):
    for kind in kinds.split(","):
        cfg = get_config(arch).smoke()
        R.get_config = lambda name: cfg
        R.SHAPES = {kind: ShapeSpec(kind, S, B, kind)}
        fn, args, _, _ = R.build_cell(arch, kind, mesh)
        with mesh:
            comp = fn.lower(*args).compile(compiler_options=FAST)
        st = analyze(comp.as_text(), 8)
        out[arch + "/" + kind] = {
            "argument_bytes": comp.memory_analysis().argument_size_in_bytes,
            "flops": st.flops, "collective_bytes": st.collective_bytes}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref_cells():
    """The reference's (2, 4) cells, compiled in one subprocess with 8
    host devices (the flag must be set before jax starts)."""
    pytest.importorskip("jax")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(MESH_S), str(MESH_B),
         ",".join(DRY_ARCHS), ",".join(KINDS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _ref_blockwise_flops(q_shape, k_shape, v_shape, block: int = 512):
    """Dot FLOPs of the reference's blockwise jnp attention: every pair
    of every key block, masked or not (a device's heads)."""
    B, Sq, H, hd = q_shape
    Sk, hd_v = k_shape[1], v_shape[-1]
    blk = min(block, Sk)
    return 2 * (hd + hd_v) * B * H * Sq * math.ceil(Sk / blk) * blk


def _ref_ssd_flops(x_shape, b_shape):
    """Dot FLOPs of the reference's chunked jnp SSD on a device's heads."""
    BC, Q, nh, hd = x_shape
    return 2 * (b_shape[-1] + hd) * BC * nh * Q * Q


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_mesh_record_matches_the_reference_per_device(arch, kind, ref_cells,
                                                      monkeypatch):
    ref = ref_cells[f"{arch}/{kind}"]
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
                          ShapeSpec(kind, MESH_S, MESH_B, kind),
                          mesh=_mesh())
    assert not dist.is_initialized()
    assert (rec["mesh"], rec["devices"]) == ("2x4", 8)
    assert rec["memory"]["argument_bytes"] == ref["argument_bytes"]
    as_ref = rec["hlo"]["flops"] - calls["flash"] - calls["ssd"] \
        + calls["flash_ref"] + calls["ssd_ref"]
    ratio = as_ref / ref["flops"]
    if kind == "train":
        lo, hi = TRAIN_FLOPS_RATIO
        assert lo <= ratio <= hi, ratio
    elif (arch, kind) in FLOPS_RATIO:
        assert ratio == pytest.approx(FLOPS_RATIO[arch, kind], abs=1e-4)
    else:
        assert as_ref == ref["flops"]
    mine, theirs = rec["hlo"]["collective_bytes"], ref["collective_bytes"]
    assert sum(mine.values()) / sum(theirs.values()) == pytest.approx(
        COLLECTIVE_RATIO[arch, kind], abs=1e-4)
    for kind_, n in theirs.items():
        if n:
            assert any(mine[k] for k in KIND_STANDS_IN[kind_]), kind_


# ---------------------------------------------------------------------------
# (d) real sharded execution on 4 gloo ranks
# ---------------------------------------------------------------------------
GLOO_ARCHS = ["zamba2-7b", "granite-3-2b", "deepseek-moe-16b"]


def _rows(t):
    t = t.double()
    return t.reshape(-1, t.shape[-1]) if t.ndim else t.reshape(1, 1)


def _rms(rows):
    return rows.square().mean(-1, keepdim=True).sqrt()


def _row_close(got, want, rtol=1e-5, step=None):
    """The worst element's |got - want| over its limit: rtol x the RMS of
    want's row (its last dim), plus, given the `step` that made want,
    1e-4 x the RMS of the step's row."""
    w = _rows(want)
    limit = rtol * _rms(w)
    if step is not None:
        limit = limit + 1e-4 * _rms(_rows(step))
    return ((_rows(got) - w).abs() / (limit + 1e-30)).max().item()


def _gloo_rank(rank, world, path, archs, queue):
    try:
        out = _gloo_work(rank, world, path, archs)
    except Exception:   # report it: the other ranks then stop at a timeout
        import traceback
        queue.put((rank, traceback.format_exc()))
        raise
    if rank == 0:
        queue.put((rank, out))
    dist.destroy_process_group()


def _gloo_work(rank, world, path, archs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    from repro_torch.configs.base import make_inputs
    from repro_torch.models import api as models
    from repro_torch.models.common import ShardCtx, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    mesh = M.make_smoke_mesh(2, data=2, device_type="cpu")
    dp, tp = ("data",), "model"
    ctx = ShardCtx(mesh, dp, tp)
    # eps 1e-3: Adam's step lr·g/(|g| + eps) is +-lr, whatever |g|, at
    # the default 1e-8, so a gradient within rounding of 0 could flip it;
    # here the rounding moves it by lr x noise / eps at most
    oc = adamw.OptConfig(warmup_steps=1, eps=1e-3)
    res = {"factored_adamw": _factored_adamw_close(mesh, dp, tp)}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        out = res[arch] = {}
        # decode on a (1, 4) mesh: 2 kv heads do not split 4 ways, so the
        # caches split the sequence and the softmax combines over shards
        decode_mesh = M.make_smoke_mesh(4, device_type="cpu")
        shape = ShapeSpec("decode", 16, 4, "decode")
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        batch = make_inputs(cfg, shape, device="cpu")
        dparams = S.distribute_tree(params, S.param_shardings(
            cfg, params, decode_mesh, dp, tp), decode_mesh)
        dbatch = S.distribute_tree(batch, S.batch_shardings(
            cfg, shape, decode_mesh, dp, tp), decode_mesh)
        with torch.no_grad():
            want, caches = models.decode_step(cfg, params, batch)
            got, dcaches = models.decode_step(
                cfg, dparams, dbatch, ShardCtx(decode_mesh, dp, tp))
        # the caches at the gradients' 1e-4: the SSM state's step runs
        # on regrouped B/C shards, its products in another order
        out["decode"] = {"logits": _row_close(got.full_tensor(), want),
                         **{k: _row_close(dcaches[k].full_tensor(), c, 1e-4)
                            for k, c in caches.items()}}
        for kind in ("prefill", "train"):
            shape = ShapeSpec(kind, 16, 4, kind)
            params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
            batch = make_inputs(cfg, shape, device="cpu")
            dparams = S.distribute_tree(params, S.param_shardings(
                cfg, params, mesh, dp, tp), mesh)
            dbatch = S.distribute_tree(batch, S.batch_shardings(
                cfg, shape, mesh, dp, tp), mesh)
            if kind == "prefill":
                with torch.no_grad():
                    want = models.forward(cfg, params, batch)
                    got = models.forward(cfg, dparams, dbatch, ctx)
                out["logits"] = _row_close(got.full_tensor(), want)
                continue
            opt = adamw.init(oc, params)
            dopt = S.distribute_tree(opt, S.opt_state_shardings(
                opt, mesh, dp, tp), mesh)
            before = [t.clone() for t in tree_leaves(params)]
            plain, shard = make_train_step(cfg, oc), \
                make_train_step(cfg, oc, ctx)
            _, _, m1 = plain(params, opt, batch)
            _, _, m2 = shard(dparams, dopt, dbatch)
            out["loss"] = abs(m1["loss"].item()
                              - m2["loss"].full_tensor().item()) \
                / (1e-5 * abs(m1["loss"].item()))
            # gradients: f32 sums in another order (rtol 1e-4)
            out["grads"] = max(_row_close(b.full_tensor(), a, 1e-4)
                               for a, b in zip(tree_leaves(plain.grads),
                                               tree_leaves(shard.grads)))
            # parameters: 1e-5 of the row's RMS, and the step's part
            # (p - p0) at the gradients' 1e-4 of its row's RMS (a leaf
            # that starts at 0, as conv_b, is all step)
            out["params"] = {path: _row_close(b.full_tensor(), a, 1e-5,
                                              step=a - a0)
                             for (path, a), a0, b in zip(
                                 _leaves_with_paths(params), before,
                                 tree_leaves(dparams))}
    return res


def _factored_adamw_close(mesh, dp, tp):
    """Two AdamW steps with a factored second moment on a stacked
    (2, 256, 384) leaf split (None, "data", "model"), against the same
    steps unsplit: the parameters' worst distance over 1e-5 of their
    row's RMS plus 1e-4 of the step's."""
    from repro_torch.optim import adamw
    oc = adamw.OptConfig(warmup_steps=1, eps=1e-3, factored_v=True)
    gen = torch.Generator().manual_seed(1)
    p0 = torch.randn(2, 256, 384, generator=gen)
    grads = [torch.randn(2, 256, 384, generator=gen) for _ in range(2)]
    spec = {"w": (None, "data", "model")}
    p, dp_ = {"w": p0.clone()}, S.distribute_tree({"w": p0.clone()}, spec,
                                                  mesh)
    st = adamw.init(oc, p)
    dst = S.distribute_tree(st, {"mu": {"w": {"m": spec["w"], "v": {
        "row": (None, "data"), "col": (None, "model")}}}, "count": ()}, mesh)
    for g in grads:
        adamw.update(oc, {"w": g}, st, p)
        adamw.update(oc, S.distribute_tree({"w": g}, spec, mesh), dst, dp_)
    return _row_close(dp_["w"].full_tensor(), p["w"], 1e-5,
                      step=p["w"] - p0)


def _leaves_with_paths(tree, path: str = ""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves_with_paths(v, f"{path}['{k}']")]
    return [(path, tree)]


@pytest.fixture(scope="module")
def gloo_results():
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_gloo_rank,
                             args=(r, 4, os.path.join(d, "store"),
                                   GLOO_ARCHS, queue)) for r in range(4)]
        for p in procs:
            p.start()
        try:
            rank, out = queue.get(timeout=600)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
    assert isinstance(out, dict), f"rank {rank}: {out}"
    return out


def test_factored_adamw_on_shards_equals_one_process(gloo_results):
    assert gloo_results["factored_adamw"] <= 1.0


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_execution_equals_one_process(arch, gloo_results):
    """Each value: the worst element's distance over its limit (1e-5 of
    its row's RMS; of |loss| for the loss)."""
    got = dict(gloo_results[arch])
    params = got.pop("params")
    decode = got.pop("decode")
    assert all(v <= 1.0 for v in decode.values()), decode
    assert set(got) == {"logits", "loss", "grads"}
    assert all(v <= 1.0 for v in got.values()), got
    assert all(v <= 1.0 for v in params.values()), \
        {k: v for k, v in params.items() if v > 1.0}


def test_the_roofline_reads_the_traces_collectives():
    """A mesh record's collective term is its wire bytes over the link
    rate, and `report`'s tables carry them."""
    from repro_torch.benchmarks import report, roofline
    rec = dryrun.run_cell(get_config("granite-3-2b").smoke(),
                          ShapeSpec("prefill", MESH_S, MESH_B, "prefill"),
                          mesh=_mesh())
    wire = sum(rec["hlo"]["collective_bytes"].values())
    t = roofline.roofline_terms(rec)
    assert wire > 0
    assert t["collective_s"] == wire / roofline.NVLINK_BYTES_PER_S
    recs = {"granite-3-2b-smoke_prefill_single": rec}
    assert f"{wire:.2e}" in report.dryrun_table(recs)
    assert f"{t['collective_s'] * 1e3:.1f} ms" in report.roofline_table(recs)
