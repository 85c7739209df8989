"""The port's fused OFU histogram (`repro_torch.kernels.fleet_hist`)
against the JAX package's: the plain PyTorch version and the CPU dispatch
of `ofu_bucket_hist` are held to `bucket_hist_ref` and to the Pallas
kernel in interpret mode on the same inputs (counts bitwise, sums rtol
1e-5); the CUDA kernel is held to the plain version on the card.

The JAX reference is imported inside the tests that use it, so the GPU
tests here also run on a machine without JAX:
`pytest -m gpu tests/test_torch_fleet_hist.py`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fleet_hist import (bucket_hist_torch,  # noqa: E402
                                            ofu_bucket_hist, rows_per_block)

EDGES = np.linspace(0.0, 1.1, 129)


def _grid(D, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (D, S)).astype(np.float32),
            rng.uniform(900, 1558, (D, S)).astype(np.float32))


def _edge_exact():
    """Every OFU value sits exactly on an f32 edge: comparison binning
    must put each in the bin the edge opens (searchsorted side='right')."""
    e32 = EDGES.astype(np.float32)[:-1]
    tpa = np.tile(e32, (3, 1))
    return tpa, np.ones_like(tpa), 1.0, np.arange(128) // 32, 4


CASES = {
    # deliberately unaligned row count, aligned 10-column buckets
    "unaligned_513x40": lambda: (*_grid(513, 40, 0), 1 / 1558.0,
                                 np.arange(40) // 10, 4),
    # uneven bucket widths: the Pallas path falls back to XLA here, the
    # CUDA kernel reads col_bucket per column
    "ragged_map": lambda: (*_grid(64, 25, 1), 1 / 1558.0,
                           np.repeat([0, 1, 2, 3], [3, 9, 9, 4]), 4),
    "edge_exact": _edge_exact,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference_and_pallas(case):
    jnp = pytest.importorskip("jax").numpy
    from repro.kernels.fleet_hist import bucket_hist_ref
    from repro.kernels.fleet_hist import ofu_bucket_hist as ofu_bucket_hist_jax
    tpa, clk, inv_fmax, col, nb = CASES[case]()
    kw = dict(inv_fmax=inv_fmax, edges=EDGES, col_bucket=col, n_buckets=nb)
    hr, sr = bucket_hist_ref(tpa, clk, **kw)
    assert hr.sum() == tpa.size               # every sample lands once
    hp, sp = ofu_bucket_hist_jax(jnp.asarray(tpa), jnp.asarray(clk),
                                 use_pallas=True, **kw)   # interpret mode
    for fn in (bucket_hist_torch, ofu_bucket_hist):
        h, s = fn(torch.from_numpy(tpa), torch.from_numpy(clk), **kw)
        assert h.dtype == torch.int64 and s.dtype == torch.float64
        np.testing.assert_array_equal(h.numpy(), hr)
        np.testing.assert_array_equal(h.numpy(), np.asarray(hp))
        np.testing.assert_allclose(s.numpy(), sr, rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-5)


def test_rejects_bad_edges_and_inputs():
    t = torch.ones((2, 2))
    kw = dict(inv_fmax=1.0, col_bucket=np.zeros(2, int), n_buckets=1)
    with pytest.raises(ValueError, match="strictly-increasing"):
        ofu_bucket_hist(t, t, edges=np.array([0.0, 1.0, 0.5]), **kw)
    with pytest.raises(ValueError, match="strictly-increasing"):
        ofu_bucket_hist(t, t, edges=np.array([0.0]), **kw)
    with pytest.raises(TypeError, match="torch tensors"):
        ofu_bucket_hist(t.numpy(), t, edges=EDGES, **kw)
    with pytest.raises(ValueError, match="one \\(D, S\\) shape"):
        ofu_bucket_hist(t, torch.ones((2, 3)), edges=EDGES, **kw)
    with pytest.raises(ValueError, match="col_bucket has shape"):
        ofu_bucket_hist(t, t, edges=EDGES, inv_fmax=1.0,
                        col_bucket=np.zeros(3, int), n_buckets=1)
    with pytest.raises(ValueError, match=r"lie in \[0, 1\)"):
        ofu_bucket_hist(t, t, edges=EDGES, inv_fmax=1.0,
                        col_bucket=np.array([0, 1]), n_buckets=1)


def test_cpu_dispatch_never_counts_a_launch():
    tpa, clk = _grid(8, 12, 2)
    before = ofu_bucket_hist.launches
    ofu_bucket_hist(torch.from_numpy(tpa), torch.from_numpy(clk),
                    inv_fmax=1 / 1558.0, edges=EDGES,
                    col_bucket=np.arange(12) // 4, n_buckets=3)
    assert ofu_bucket_hist.launches == before


@pytest.mark.parametrize("D,S", [(1, 1), (513, 40), (1563, 2880),
                                 (100_032, 2880), (5_000_000, 1)])
def test_rows_per_block_covers_every_row(D, S):
    rpb = rows_per_block(D, S)
    row_tiles = -(-D // rpb)
    assert rpb >= 1 and row_tiles * rpb >= D and (row_tiles - 1) * rpb < D
    assert row_tiles <= 65535                 # CUDA grid.y limit
    assert rpb >= min(D, 64)


# ---------------------------------------------------------------------------
# the CUDA kernel itself: only on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES) + ["main_path_1563x2880"])
def test_kernel_matches_plain_version(cuda, case):
    if case == "main_path_1563x2880":
        tpa, clk = _grid(1563, 2880, 3)
        inv_fmax, col, nb = 1 / 1500.0, np.arange(2880) // 10, 288
    else:
        tpa, clk, inv_fmax, col, nb = CASES[case]()
    kw = dict(inv_fmax=inv_fmax, edges=EDGES, col_bucket=col, n_buckets=nb)
    t, c = torch.from_numpy(tpa).to(cuda), torch.from_numpy(clk).to(cuda)
    before = ofu_bucket_hist.launches
    h, s = ofu_bucket_hist(t, c, **kw)
    torch.cuda.synchronize()
    assert ofu_bucket_hist.launches == before + 1
    assert h.dtype == torch.int32 and h.device.type == "cuda"
    hp, sp = bucket_hist_torch(t, c, **kw)
    assert torch.equal(h.long(), hp)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0.0)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    t = torch.ones((4, 8), device=cuda)
    kw = dict(inv_fmax=1.0, edges=EDGES, col_bucket=np.zeros(4, int),
              n_buckets=1)
    with pytest.raises(ValueError, match="contiguous"):
        ofu_bucket_hist(t.t(), t.t(), **kw)
    with pytest.raises(TypeError, match="float32"):
        ofu_bucket_hist(t.t().contiguous().double(),
                        t.t().contiguous().double(), **kw)
