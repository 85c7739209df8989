"""The port's model zoo and serving path (`repro_torch.configs` input
functions, `repro_torch.models`, `train.steps`' serve steps,
`launch.serve`) against the JAX package on the same values.

Parity cases initialise each arch's smoke config with the reference
(`jax.random.key(0)`), convert its parameters with `params_from_jax`
and feed both packages `make_inputs`' draws (bitwise equal across the
two).  f32 is held elementwise to rtol 1e-4 and 1e-4 of the row's RMS.
In bf16 the reference's own rounding is as large as the gap: its bf16
logits lie 2.3e-2 (relative L2) from its f32 logits on zamba2's smoke
config, and its scan-compiled layer bodies round otherwise than its
eager ops, so bf16 is held to the reference's 2e-2 as a relative L2
error beyond that allowance: ||port - ref|| / ||ref|| <= 2e-2 +
||ref - ref_f32|| / ||ref_f32||, ref_f32 the reference in f32 on the
same bf16 values.

The `gpu` cases at the end hold the card's forward (through the flash
and SSD kernels) and its decode past the caches' end against the CPU's
plain route and import nothing of JAX:
`pytest -m gpu tests/test_torch_models.py`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _propcheck import given, settings, st  # noqa: E402

from repro_torch.configs import (SHAPES, ShapeSpec, cache_specs,  # noqa: E402
                                 get_config, input_specs, make_inputs)
from repro_torch.models import (abstract_params, decode_step,  # noqa: E402
                                forward, init_params, param_count)
from repro_torch.models import common as T_common  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "qwen3-4b",
         "nemotron-4-340b", "granite-3-2b", "llama3.2-3b", "whisper-small",
         "phi-3-vision-4.2b", "mamba2-780m", "zamba2-7b"]
KINDS = {"train": ("t", 32, 2, "train"), "prefill": ("p", 32, 2, "prefill"),
         "decode": ("d", 16, 2, "decode")}


def _jax():
    return pytest.importorskip("jax")


#: XLA's CPU backend with its LLVM optimisations off, its fusions emitted
#: by the older elemental emitter and each module codegen'd in one piece:
#: the same HLO, so the same operations and roundings, compiled in about a
#: sixth of the default's time (the reference's compiles are most of this
#: file's cost)
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True,
             "xla_cpu_use_fusion_emitters": False,
             "xla_cpu_parallel_codegen_split_count": 1}


def _run(fn, *args):
    """fn(*args) through jax.jit, compiled under `_XLA_FAST`."""
    return _jax().jit(fn).lower(*args).compile(
        compiler_options=_XLA_FAST)(*args)


def _np(x) -> np.ndarray:
    """A jax or torch array as f32 (or integer) NumPy."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    jnp = _jax().numpy
    return np.asarray(x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)


def _rel(want: np.ndarray, got: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close_f32(got, want, what: str = ""):
    got, want = np.atleast_1d(_np(got)), np.atleast_1d(_np(want))
    assert got.shape == want.shape, what
    rms = np.sqrt((want.astype(np.float64) ** 2).mean(-1, keepdims=True))
    err = np.abs(got - want)
    bad = err > 1e-4 * np.abs(want) + 1e-4 * rms
    assert not bad.any(), f"{what}: max |diff| {err.max():.3e}"


def _close_bf16(got, want, want_f32, what: str = ""):
    got, want, want_f32 = _np(got), _np(want), _np(want_f32)
    assert got.shape == want.shape, what
    allowance = _rel(want_f32, want)
    assert _rel(want, got) <= 2e-2 + allowance, \
        f"{what}: rel {_rel(want, got):.3e}, allowance {allowance:.3e}"


# ---------------------------------------------------------------------------
# the reference's side, once an arch
# ---------------------------------------------------------------------------
_REF: dict = {}


def _ref(arch):
    """(reference smoke cfg, its params as f32 NumPy), inited once."""
    if arch not in _REF:
        jax = _jax()
        from repro.configs import get_config as R_get
        from repro.models import init_params as R_init
        cfg = R_get(arch).smoke()
        params = _run(lambda k: R_init(cfg, k), jax.random.key(0))
        _REF[arch] = (cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        params))
    return _REF[arch]


def _as_f32(batch):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in batch.items()}


def _to_jax(batch):
    """Copies (the port's decode writes its caches in place, and a jax
    array made from a NumPy view could alias them)."""
    jnp = _jax().numpy
    return {k: jnp.asarray(np.array(_np(v)), jnp.bfloat16
                           if v.dtype == torch.bfloat16 else v.numpy().dtype)
            for k, v in batch.items()}


_OUT: dict = {}


def _outputs(arch, dtype, kind):
    """Forward logits or (decode logits, caches) of the reference and the
    port for one arch, dtype and kind ("fwd" or "dec"), on the same
    parameters and inputs: the smoke config's bf16 draws, upcast for
    f32.  Cached, since the bf16 cases also read the f32 outputs."""
    key = (arch, dtype, kind)
    if key not in _OUT:
        jax = _jax()
        jnp = jax.numpy
        from repro.models import decode_step as R_decode
        from repro.models import forward as R_forward
        rcfg, rparams = _ref(arch)
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
        jdt = jnp.dtype(dtype)
        jparams = _f32_leaves(jax.tree.map(lambda x: jnp.asarray(x, jdt),
                                           rparams))
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
        params = params_from_jax(rparams, dtype, "cpu")
        spec = ShapeSpec(*KINDS["train" if kind == "fwd" else "decode"])
        batch = make_inputs(get_config(arch).smoke(), spec, device="cpu")
        if dtype == "float32":
            batch = _as_f32(batch)
        jbatch = _to_jax(batch)
        fn = R_forward if kind == "fwd" else R_decode
        want = jax.block_until_ready(
            _run(lambda p, b: fn(rcfg, p, b), jparams, jbatch))
        _OUT[key] = (want, (forward if kind == "fwd" else decode_step)(
            cfg, params, batch))
    return _OUT[key]


def _f32_leaves(tree):
    """The leaves the reference keeps in f32 whatever the model dtype,
    back in f32."""
    from repro_torch.models.convert import F32_LEAVES
    jnp = _jax().numpy
    return {k: (v.astype(jnp.float32) if k in F32_LEAVES else
                _f32_leaves(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# model inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_inputs_bitwise_equal_to_reference(arch, kind):
    from repro.configs import get_config as R_get
    from repro.configs import make_inputs as R_make
    from repro.configs.base import ShapeSpec as R_Shape
    want = R_make(R_get(arch).smoke(), R_Shape(*KINDS[kind]), seed=5)
    got = make_inputs(get_config(arch).smoke(), ShapeSpec(*KINDS[kind]),
                      seed=5, device="cpu")
    assert list(got) == list(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k]
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
        assert tuple(g.shape) == w.shape, k
        if g.dtype == torch.bfloat16:   # the bits themselves
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert np.array_equal(g.numpy(), w), k


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shape):
    from repro.configs import get_config as R_get
    from repro.configs import input_specs as R_specs
    from repro.configs.base import SHAPES as R_SHAPES
    from repro.configs.base import cache_specs as R_cache
    cfg, rcfg = get_config(arch), R_get(arch)

    def same(got, want):
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].device.type == "meta", k
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).removeprefix("torch.") == \
                np.dtype(w.dtype).name, k

    same(input_specs(cfg, SHAPES[shape]), R_specs(rcfg, R_SHAPES[shape]))
    s = SHAPES[shape]
    same(cache_specs(cfg, s.global_batch, s.seq_len, torch.float32),
         R_cache(rcfg, s.global_batch, s.seq_len, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    jax = _jax()
    from repro.configs import get_config as R_get
    from repro.models import abstract_params as R_abstract
    from repro.models import param_count as R_count
    want = R_abstract(R_get(arch))
    got = abstract_params(get_config(arch))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat_g[path] = t
    walk(got, ())
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        g = flat_g[tuple(p.key for p in path)]
        assert tuple(g.shape) == w.shape and g.device.type == "meta", path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name
    assert param_count(got) == R_count(want)


# ---------------------------------------------------------------------------
# whole models: forward and decode, all ten archs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    want, got = _outputs(arch, dtype, "fwd")
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close_f32(got, want, arch)
    else:
        _close_bf16(got, want, _outputs(arch, "float32", "fwd")[0], arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    (want, want_c), (got, got_c) = _outputs(arch, dtype, "dec")
    assert sorted(got_c) == sorted(want_c)
    (want32, want32_c), _ = _outputs(arch, "float32", "dec")
    for name, g, w, w32 in [("logits", got, want, want32)] + [
            (k, got_c[k], want_c[k], want32_c[k]) for k in want_c]:
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name
        if dtype == "float32":
            _close_f32(g, w, f"{arch} {name}")
        else:
            _close_bf16(g, w, w32, f"{arch} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_smoke(arch):
    cfg = get_config(arch).smoke()
    params = init_params(cfg, device="cpu")
    logits = forward(cfg, params, make_inputs(cfg, ShapeSpec("t", 32, 2,
                                                             "train"),
                                              device="cpu"))
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert not torch.isnan(logits.float()).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_smoke(arch):
    cfg = get_config(arch).smoke()
    params = init_params(cfg, device="cpu")
    batch = make_inputs(cfg, ShapeSpec("d", 16, 2, "decode"), device="cpu")
    logits, caches = decode_step(cfg, params, batch)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert not torch.isnan(logits.float()).any()
    for k, v in caches.items():
        assert not torch.isnan(v.float()).any(), k


def test_decode_matches_forward_incrementally():
    """Greedy decode over a cached prefix agrees with the full forward's
    logits at the same position (dense smoke config)."""
    cfg = get_config("granite-3-2b").smoke()
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    T = 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, T)).astype(np.int32))
    caches = {k: torch.zeros(v.shape, dtype=v.dtype)
              for k, v in cache_specs(cfg, 1, 16, torch.float32).items()}
    dec = []
    for t in range(T):
        lg, caches = decode_step(cfg, params, {
            "tokens": toks[:, t:t + 1],
            "cache_index": torch.tensor(t, dtype=torch.int32), **caches})
        dec.append(lg[:, 0].float())
    full = forward(cfg, params, {"tokens": toks}).float()
    for t in range(T):
        torch.testing.assert_close(dec[t], full[:, t], rtol=2e-2, atol=2e-2)


def test_serve_loop_matches_reference_greedy_tokens():
    """The reference's `test_serve_loop_runs_all_families`, on shared f32
    parameters: 4 greedy steps give the reference's tokens."""
    jax = _jax()
    jnp = jax.numpy
    from repro.launch.serve import init_caches as R_init_caches
    from repro.train.steps import make_serve_step as R_serve_step
    from repro_torch.launch.serve import init_caches
    from repro_torch.train.steps import make_serve_step
    for arch in ("granite-3-2b", "mamba2-780m", "deepseek-v3-671b"):
        rcfg, rparams = _ref(arch)
        rcfg = dataclasses.replace(rcfg, dtype="float32")
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        jparams = jax.tree.map(jnp.asarray, rparams)
        params = params_from_jax(rparams, "float32", "cpu")
        r_serve, serve = jax.jit(R_serve_step(rcfg)), make_serve_step(cfg)
        B, S = 2, 16
        rb = {"tokens": jnp.zeros((B, 1), jnp.int32),
              "cache_index": jnp.asarray(0, jnp.int32),
              **R_init_caches(rcfg, B, S)}
        tb = {"tokens": torch.zeros((B, 1), dtype=torch.int32),
              "cache_index": torch.tensor(0, dtype=torch.int32),
              **init_caches(cfg, B, S, "cpu")}
        for i in range(4):
            r_nxt, r_caches = r_serve(jparams, rb)
            nxt, caches = serve(params, tb)
            assert nxt.shape == (B, 1)
            assert (nxt >= 0).all() and (nxt < cfg.vocab_size).all()
            assert np.array_equal(nxt.numpy(), np.asarray(r_nxt)), (arch, i)
            rb = {"tokens": r_nxt.astype(jnp.int32),
                  "cache_index": jnp.asarray(i + 1, jnp.int32), **r_caches}
            tb = {"tokens": nxt.to(torch.int32),
                  "cache_index": torch.tensor(i + 1, dtype=torch.int32),
                  **caches}


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b",
                                  "zamba2-7b", "whisper-small"])
def test_decode_past_the_cache_end_matches_reference(arch):
    """7 greedy tokens over caches of 4 positions (B 2, f32; GQA, MLA, the
    hybrid's shared block, enc-dec): from the 5th token on, the
    reference's `dynamic_update_slice` clamps its write to the last row,
    and the port's clamped write gives the reference's tokens."""
    jax = _jax()
    jnp = jax.numpy
    from repro.launch.serve import init_caches as R_init_caches
    from repro.train.steps import make_serve_step as R_serve_step
    from repro_torch.launch.serve import decode_batch
    from repro_torch.train.steps import make_serve_step
    rcfg, rparams = _ref(arch)
    rcfg = dataclasses.replace(rcfg, dtype="float32")
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    params = params_from_jax(rparams, "float32", "cpu")
    B, S, T = 2, 4, 7
    tb = decode_batch(cfg, B, S, "cpu")
    rb = {"tokens": jnp.zeros((B, 1), jnp.int32),
          "cache_index": jnp.asarray(0, jnp.int32),
          **R_init_caches(rcfg, B, S)}
    if cfg.family == "encdec":
        enc = np.random.default_rng(5).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        tb["encoder_out"] = torch.from_numpy(enc.copy())
        rb["encoder_out"] = jnp.asarray(enc)
    r_serve, serve = jax.jit(R_serve_step(rcfg)), make_serve_step(cfg)
    jparams = jax.tree.map(jnp.asarray, rparams)
    got, want = [], []
    for i in range(T):
        r_nxt, r_caches = r_serve(jparams, rb)
        nxt, caches = serve(params, tb)
        want.append(np.asarray(r_nxt)[:, 0])
        got.append(nxt.numpy()[:, 0])
        rb.update(r_caches, tokens=r_nxt.astype(jnp.int32),
                  cache_index=jnp.asarray(i + 1, jnp.int32))
        tb.update(caches, tokens=nxt.to(torch.int32),
                  cache_index=torch.tensor(i + 1, dtype=torch.int32))
    assert np.array_equal(np.stack(got, 1), np.stack(want, 1)), \
        (arch, np.stack(got, 1), np.stack(want, 1))


def test_serve_main_decodes_past_the_cache_end(capsys):
    """`launch.serve` asked for more tokens than its context holds runs
    to the end, as the reference's does."""
    from repro_torch.launch.serve import main
    main(["--arch", "llama3.2-3b", "--smoke", "--tokens", "6", "--batch",
          "1", "--ctx-len", "4", "--device", "cpu"])
    assert "decoded 6 tokens x 1 seqs" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_loss_fn_matches_reference(arch):
    """The forward-only loss, with deepseek-v3's multi-token-prediction
    head, on shared f32 parameters and inputs."""
    jax = _jax()
    from repro.train.steps import loss_fn as R_loss
    from repro_torch.train.steps import loss_fn
    rcfg, rparams = _ref(arch)
    rcfg = dataclasses.replace(rcfg, dtype="float32")
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    batch = _as_f32(make_inputs(get_config(arch).smoke(),
                                ShapeSpec(*KINDS["train"]), device="cpu"))
    want, want_aux = _run(lambda p, b: R_loss(rcfg, p, b),
                          jax.tree.map(jax.numpy.asarray, rparams),
                          _to_jax(batch))
    got, aux = loss_fn(cfg, params_from_jax(rparams, "float32", "cpu"),
                       batch)
    assert sorted(aux) == sorted(want_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5)


def test_serve_main_runs_on_cpu_when_told(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "zamba2-7b", "--smoke", "--tokens", "3", "--batch", "2",
          "--ctx-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("decoded 3 tokens x 2 seqs in ")
    assert out[0].endswith(" tok/s)")
    assert out[1].startswith("sample: [")


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch.serve import main
    from repro_torch.models.convert import params_from_jax as convert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-3-2b").smoke()
    for call in (lambda: init_params(cfg),
                 lambda: make_inputs(cfg, ShapeSpec(*KINDS["train"])),
                 lambda: convert({"w": np.zeros(2, np.float32)}, "float32"),
                 lambda: main(["--arch", "granite-3-2b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# module by module, in f32 (the reference's functions on the same values)
# ---------------------------------------------------------------------------
def _arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(*arrays):
    jnp = _jax().numpy
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _flash_case(Sq, Sk, H, KV, hd, hd_v, causal):
    def run(rng):
        from repro.models.common import flash_attention as R_flash
        (q, k, v), (tq, tk, tv) = _both(
            _arr(rng, (2, Sq, H, hd)), _arr(rng, (2, Sk, KV, hd)),
            _arr(rng, (2, Sk, KV, hd_v)))
        return (R_flash(q, k, v, causal=causal),
                T_common.flash_attention(tq, tk, tv, causal=causal))
    return run


def _flash_q_offset(rng):
    """The reference's query block placed at positions 30-37 of a
    40-key causal sequence equals the last 8 rows of the port's causal
    flash over the 38 positions the block sees."""
    from repro.models.common import flash_attention as R_flash
    (q, k, v), (tq, tk, tv) = _both(_arr(rng, (2, 8, 4, 16)),
                                    _arr(rng, (2, 40, 2, 16)),
                                    _arr(rng, (2, 40, 2, 16)))
    q_full = torch.cat([torch.zeros((2, 30, 4, 16)), tq], 1)
    got = T_common.flash_attention(q_full, tk[:, :38], tv[:, :38],
                                   causal=True)[:, 30:]
    return R_flash(q, k, v, causal=True, q_offset=30, block=16), got


def _flash_kv_len(rng):
    """The reference's one query against a cache's first 23 positions
    (kv_len) equals the port's decode attention at cache_index 22."""
    jnp = _jax().numpy
    from repro.models.common import flash_attention as R_flash
    (q, k, v), (tq, tk, tv) = _both(_arr(rng, (2, 1, 4, 16)),
                                    _arr(rng, (2, 40, 2, 16)),
                                    _arr(rng, (2, 40, 2, 16)))
    return (R_flash(q, k, v, causal=False, kv_len=jnp.asarray(23), block=16),
            T_common.decode_attention(tq, tk, tv,
                                      torch.tensor(22, dtype=torch.int32)))


def _rms_norm(rng):
    from repro.models.common import rms_norm
    (x, s), (tx, ts) = _both(_arr(rng, (2, 8, 32)), _arr(rng, (32,)))
    return rms_norm(x, s), T_common.rms_norm(tx, ts)


def _apply_rope(rng):
    from repro.models.common import apply_rope
    (x,), (tx,) = _both(_arr(rng, (2, 8, 4, 16)))
    pos = np.arange(3, 11)
    return (apply_rope(x, _jax().numpy.asarray(pos), 10_000.0),
            T_common.apply_rope(tx, torch.from_numpy(pos), 10_000.0))


def _decode_attention(rng):
    from repro.models.common import decode_attention
    (q, k, v), (tq, tk, tv) = _both(_arr(rng, (2, 1, 4, 16)),
                                    _arr(rng, (2, 12, 2, 16)),
                                    _arr(rng, (2, 12, 2, 16)))
    jnp = _jax().numpy
    return (decode_attention(q, k, v, jnp.asarray(6, jnp.int32)),
            T_common.decode_attention(tq, tk, tv,
                                      torch.tensor(6, dtype=torch.int32)))


def _ssd_inputs(rng, S=32, nh=4, hd=8, g=2, ds=6):
    x, Bm, Cm = (_arr(rng, (2, S, nh, hd)), _arr(rng, (2, S, g, ds), 0.5),
                 _arr(rng, (2, S, g, ds), 0.5))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (2, S, nh))
                ).astype(np.float32)
    A = -rng.uniform(1, 16, nh).astype(np.float32)
    return x, dt, A, Bm, Cm


def _ssd_chunked(rng):
    from repro.models.ssm import ssd_chunked
    from repro_torch.models.ssm import ssd_chunked as T_ssd
    arrays = _ssd_inputs(rng) + (_arr(rng, (2, 4, 8, 6)),)
    j, t = _both(*arrays)
    y, h = ssd_chunked(*j[:5], 8, init_state=j[5], return_final=True)
    ty, th = T_ssd(*t[:5], 8, init_state=t[5], return_final=True)
    return (y, h), (ty, th)


def _ops_ssd(rng):
    """`mamba_apply`'s kernel route (`ops.ssd`) against the reference's
    plain scan."""
    from repro.models.ssm import ssd_chunked
    from repro_torch.kernels import ops
    j, t = _both(*_ssd_inputs(rng))
    return ssd_chunked(*j, 8), ops.ssd(*t, chunk=8)


def _ssd_step(rng):
    from repro.models.ssm import ssd_step
    from repro_torch.models.ssm import ssd_step as T_step
    x, dt, A, Bm, Cm = _ssd_inputs(rng, S=1)
    j, t = _both(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                 _arr(rng, (2, 4, 8, 6)))
    return ssd_step(*j), T_step(*t)


def _causal_conv(rng):
    from repro.models.ssm import causal_conv, conv_step
    from repro_torch.models.ssm import causal_conv as T_conv
    from repro_torch.models.ssm import conv_step as T_step
    j, t = _both(_arr(rng, (2, 9, 12)), _arr(rng, (4, 12)), _arr(rng, (12,)),
                 _arr(rng, (2, 3, 12)))
    return ((causal_conv(*j[:3]), conv_step(j[0][:, 0], j[3], *j[1:3])),
            (T_conv(*t[:3]), T_step(t[0][:, 0], t[3], *t[1:3])))


def _moe_apply(rng):
    from repro.models.moe import moe_apply
    from repro_torch.models.moe import moe_apply as T_moe
    cfg, params = _ref("deepseek-moe-16b")
    p = params["moe_layers"]
    jax = _jax()
    jp = jax.tree.map(lambda a: jax.numpy.asarray(a[0]), p)
    tp = params_from_jax(jax.tree.map(lambda a: a[0], p), "float32", "cpu")
    (x,), (tx,) = _both(_arr(rng, (2, 16, cfg.d_model), 0.5))
    tcfg = get_config("deepseek-moe-16b").smoke()
    return (moe_apply(cfg, jp["mlp"], x, None, router_stats=True),
            T_moe(tcfg, tp["mlp"], tx, router_stats=True))


def _mla_decode(rng):
    jax = _jax()
    jnp = jax.numpy
    from repro.models.attention import mla_decode
    from repro_torch.models.attention import mla_decode as T_mla
    cfg, params = _ref("deepseek-v3-671b")
    p = jax.tree.map(lambda a: a[0], params["dense_layers"]["attn"])
    tcfg = get_config("deepseek-v3-671b").smoke()
    cache = _arr(rng, (2, 12, cfg.kv_lora_rank + cfg.qk_rope_dim))
    (x, c), (tx, tc) = _both(_arr(rng, (2, 1, cfg.d_model)), cache)
    out, kv = mla_decode(cfg, jax.tree.map(jnp.asarray, p), x, c,
                         jnp.asarray(5, jnp.int32), ctx=None)
    t_kv = tc.clone()
    t_out = T_mla(tcfg, params_from_jax(p, "float32", "cpu"), tx, t_kv,
                  torch.tensor(5, dtype=torch.int32))
    return (out, kv), (t_out, t_kv)


MODULE_CASES = {
    "rms_norm": _rms_norm,
    "apply_rope": _apply_rope,
    "flash_causal": _flash_case(32, 32, 4, 4, 16, 16, True),
    "flash_full": _flash_case(32, 32, 4, 4, 16, 16, False),
    "flash_gqa": _flash_case(32, 32, 4, 2, 16, 16, True),
    "flash_cross": _flash_case(8, 20, 4, 2, 16, 16, False),
    "flash_hd_v_narrower": _flash_case(16, 16, 4, 4, 24, 16, True),
    "flash_q_offset": _flash_q_offset,
    "flash_kv_len": _flash_kv_len,
    "decode_attention": _decode_attention,
    "ssd_chunked_init_state_final": _ssd_chunked,
    "ops_ssd": _ops_ssd,
    "ssd_step": _ssd_step,
    "causal_conv_and_conv_step": _causal_conv,
    "moe_apply_aux": _moe_apply,
    "mla_decode": _mla_decode,
}


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_matches_reference(case):
    want, got = MODULE_CASES[case](np.random.default_rng(7))
    jax = _jax()
    want, got = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        _close_f32(g, w, case)


# ---------------------------------------------------------------------------
# MoE routing (the reference's test_system.py cases, on the port)
# ---------------------------------------------------------------------------
def _moe_params(seed):
    from repro_torch.models.moe import moe_init
    cfg = get_config("deepseek-moe-16b").smoke()
    with torch.device("cpu"):
        p = moe_init(torch.Generator().manual_seed(seed), cfg, torch.float32)
    return cfg, p


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_moe_routing_finite_and_balanced(seed):
    from repro_torch.models.moe import moe_apply
    cfg, p = _moe_params(seed % 1000)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_arr(rng, (2, 16, cfg.d_model), 0.5))
    y, aux = moe_apply(cfg, p, x, router_stats=True)
    assert y.shape == x.shape
    assert torch.isfinite(y).all()
    assert float(aux) >= 0.9  # load-balance loss >= ~1 at uniform


def test_moe_decode_single_group_matches_batched():
    """The one-group decode routing equals routing the same tokens as a
    (1, B) sequence."""
    from repro_torch.models.moe import moe_apply
    cfg, p = _moe_params(3)
    xb = torch.from_numpy(_arr(np.random.default_rng(0), (8, 1, cfg.d_model),
                               0.5))
    y_dec = moe_apply(cfg, p, xb)
    y_seq = moe_apply(cfg, p, xb.reshape(1, 8, -1))
    torch.testing.assert_close(y_dec.reshape(8, -1), y_seq[0], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: the kernels inside the models
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _expected_launches(cfg) -> tuple[int, int]:
    """(flash, SSD) kernel launches of one forward."""
    if cfg.family == "ssm":
        return 0, cfg.num_layers
    if cfg.family == "hybrid":
        return len(range(0, cfg.num_layers, cfg.attn_every)), cfg.num_layers
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers, 0
    return cfg.num_layers, 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_card_forward_matches_cpu(cuda, arch):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    params = init_params(cfg, device="cpu")
    batch = make_inputs(cfg, ShapeSpec(*KINDS["train"]), device="cpu")
    want = forward(cfg, params, batch)
    to = T_common.tree_map(lambda t: t.to(cuda), params)
    n = (flash_attention_kernel.launches, ssd_intra_kernel.launches)
    got = forward(cfg, to, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches - n[0],
            ssd_intra_kernel.launches - n[1]) == _expected_launches(cfg)
    _close_f32(got.cpu(), want, arch)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b",
                                  "zamba2-7b", "whisper-small"])
def test_card_decode_past_the_cache_end_matches_cpu(cuda, arch):
    """7 greedy tokens over caches of 4 positions on the card, f32: the
    clamped write raises no device-side assert, and the tokens and the
    caches equal the CPU's."""
    from repro_torch.launch.serve import decode_batch, generate
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    params = init_params(cfg, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        p = T_common.tree_map(lambda t: t.to(dev), params)
        batch = decode_batch(cfg, 2, 4, dev)
        if cfg.family == "encdec":
            batch["encoder_out"] = torch.from_numpy(
                np.random.default_rng(5).standard_normal(
                    (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            ).to(dev)
        with torch.inference_mode():
            toks = generate(cfg, p, batch, 7)
        torch.cuda.synchronize()
        runs[str(dev)] = (toks.cpu(), {k: v.cpu() for k, v in batch.items()
                                       if k.endswith(("cache", "state"))})
    (tc, cc), (tg, cg) = runs["cpu"], runs[str(cuda)]
    assert torch.equal(tg, tc), (arch, tg, tc)
    for k in cc:
        _close_f32(cg[k], cc[k], f"{arch} {k}")
