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
                                            ofu_bucket_hist, plan,
                                            rows_per_block)

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


MAPS = {
    "main_path": (np.arange(2880) // 10, 288),
    "ragged": (np.repeat([0, 1, 2, 3], [3, 9, 9, 4]), 4),
    "unaligned_tail": (np.arange(300) // 7, 43),   # S % 128 != 0
    "random": (np.random.default_rng(5).integers(0, 200, 400), 200),
    "one_column": (np.zeros(1, int), 1),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_plan_maps_every_column_to_its_bucket(name):
    """The kernel's plan: per 128-column tile, each column's slot indexes
    a table row that holds its bucket; slots number a tile's distinct
    buckets densely from 0, in bucket order; unused slots hold -1."""
    col, nb = MAPS[name]
    arr, n_slots = plan(col, nb)
    S = col.size
    slot, table = arr[:S], arr[S:].reshape(-1, n_slots)
    tile = np.arange(S) // 128
    assert arr.dtype == np.int32 and table.shape[0] == tile[-1] + 1
    np.testing.assert_array_equal(table[tile, slot], col)
    for t in range(table.shape[0]):
        mine = np.unique(col[tile == t])
        np.testing.assert_array_equal(table[t, :mine.size], mine)
        assert (table[t, mine.size:] == -1).all()
    assert n_slots == max(np.unique(col[tile == t]).size
                          for t in range(table.shape[0]))


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


def _geometric_edges():
    return np.geomspace(1e-3, 1.1, 129)


def _binning_case(name):
    """(tpa, clock, inv_fmax, edges, col_bucket, n_buckets) of one case
    that the comparison binning must get right bitwise."""
    rng = np.random.default_rng(len(name))
    if name == "geometric_edges":          # far from uniform: the search
        tpa, clk = _grid(300, 2880, 7)
        return tpa, clk, 1 / 1558.0, _geometric_edges(), \
            np.arange(2880) // 10, 288
    if name == "out_of_range":              # below the first, above the last
        tpa = rng.uniform(-0.5, 2.0, (256, 640)).astype(np.float32)
        return tpa, np.full_like(tpa, 1558.0), 1 / 1558.0, EDGES, \
            np.arange(640) // 10, 64
    if name == "nan_and_inf":               # NaN counts every edge
        tpa, clk = _grid(128, 512, 8)
        tpa.ravel()[rng.choice(tpa.size, 300, replace=False)] = np.nan
        tpa[5, :7] = np.inf
        tpa[6, :7] = -np.inf
        return tpa, clk, 1 / 1558.0, EDGES, np.arange(512) // 10, 52
    if name == "s_not_multiple_of_4":       # the 4-byte loads
        tpa, clk = _grid(257, 2879, 9)
        return tpa, clk, 1 / 1558.0, _geometric_edges(), \
            np.arange(2879) // 10, 288
    if name == "ragged_map_geometric":
        tpa, clk = _grid(64, 25, 1)
        return tpa, clk, 1 / 1558.0, _geometric_edges(), \
            np.repeat([0, 1, 2, 3], [3, 9, 9, 4]), 4
    if name == "random_map":                # up to 128 slots a tile
        tpa, clk = _grid(96, 400, 10)
        return tpa, clk, 1 / 1558.0, EDGES, rng.integers(0, 200, 400), 200
    raise KeyError(name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["geometric_edges", "out_of_range",
                                  "nan_and_inf", "s_not_multiple_of_4",
                                  "ragged_map_geometric", "random_map"])
def test_kernel_bins_by_comparison(cuda, case):
    """Counts bitwise equal to the plain version's for non-uniform edges
    (the guess misses and the search decides), values outside the edges,
    NaN and infinities, an S that is not a multiple of 4 and column maps
    that are ragged or random; sums within rtol 1e-5 (NaN where the
    plain sum is NaN)."""
    tpa, clk, inv_fmax, edges, col, nb = _binning_case(case)
    kw = dict(inv_fmax=inv_fmax, edges=edges, col_bucket=col, n_buckets=nb)
    t, c = torch.from_numpy(tpa).to(cuda), torch.from_numpy(clk).to(cuda)
    h, s = ofu_bucket_hist(t, c, **kw)
    hp, sp = bucket_hist_torch(t, c, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h.long(), hp)
    assert int(h.sum()) == tpa.size
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0.0, equal_nan=True)


@pytest.mark.gpu
def test_kernel_takes_a_grid_that_is_not_16_byte_aligned(cuda):
    """A contiguous view one float into its storage: the kernel's 4-byte
    loads, counts bitwise as ever."""
    tpa, clk = _grid(200, 640, 11)
    kw = dict(inv_fmax=1 / 1558.0, edges=EDGES,
              col_bucket=np.arange(640) // 10, n_buckets=64)
    t, c = (torch.cat([torch.zeros(1), torch.from_numpy(a).ravel()])
            .to(cuda)[1:].view(200, 640) for a in (tpa, clk))
    assert t.is_contiguous() and t.data_ptr() % 16
    h, s = ofu_bucket_hist(t, c, **kw)
    hp, sp = bucket_hist_torch(t, c, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h.long(), hp)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0.0)
