"""The port's DTW and median-filter ops (whisper_tpu_torch/ops/dtw.py,
ops/median.py) vs the JAX package's numpy paths and its Pallas kernels
(interpret mode). On the CPU the wrappers run their plain versions; the CUDA
kernels are held against those on a card (the `cuda` tests here, and
chip_smoke.py).

Tolerance: none. The DTW trace and path are equal (both accumulate in
float64 with the same decision rule), and the median is equal (a median
selects one of its inputs)."""

import numpy as np
import pytest
import torch

from whisper_tpu.ops.dtw import _dtw_table_np, dtw_np
from whisper_tpu.ops.median import median_filter_jax, median_filter_np
from whisper_tpu.ops.pallas_kernels import dtw_pallas, dtw_trace_pallas, median_filter_pallas
from whisper_tpu_torch.ops import dtw as pdtw
from whisper_tpu_torch.ops import median as pmed

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)


def _port_trace(x):
    return pdtw.dtw_trace(torch.from_numpy(x)).numpy()


# ---- DTW ----------------------------------------------------------------------


@pytest.mark.parametrize("N, M", [(10, 20), (32, 16), (123, 378), (60, 200)])
def test_dtw_matches_np_and_pallas(N, M):
    """The shapes of tests/test_pallas_kernels.py, on randn costs."""
    x = np.random.RandomState(1).randn(N, M).astype(np.float32)
    trace = _port_trace(x)
    assert trace.dtype == np.int8 and trace.shape == (N + 1, M + 1)
    np.testing.assert_array_equal(trace, _dtw_table_np(x.astype(np.float64)))
    np.testing.assert_array_equal(trace[1:, 1:], dtw_trace_pallas(x, interpret=True)[1:, 1:])
    path = pdtw.dtw(torch.from_numpy(x))
    np.testing.assert_array_equal(path, dtw_np(x))
    np.testing.assert_array_equal(path, dtw_pallas(x, interpret=True))


@pytest.mark.parametrize("N, M", [(10, 20), (40, 75), (123, 378)])
def test_dtw_on_tied_costs(N, M):
    """Integer-valued costs are full of exact ties, where the strict
    comparisons decide between diagonal, up and left."""
    x = np.random.RandomState(4).randint(-2, 3, size=(N, M)).astype(np.float32)
    trace = _port_trace(x)
    np.testing.assert_array_equal(trace, _dtw_table_np(x.astype(np.float64)))
    np.testing.assert_array_equal(trace[1:, 1:], dtw_trace_pallas(x, interpret=True)[1:, 1:])
    np.testing.assert_array_equal(pdtw.dtw(torch.from_numpy(x)), dtw_np(x))


@pytest.mark.parametrize("N, M", [(10, 20), (32, 16), (123, 1500), (234, 189)])
def test_dtw_recovers_a_planted_path(N, M):
    """The property test of tests/test_timing_ops.py:12-44: a planted
    low-cost monotone path comes back, mismatched consecutive steps
    collapsing into diagonal moves."""
    rng = np.random.RandomState(42)
    steps = np.concatenate([np.zeros(N - 1), np.ones(M - 1)])
    rng.shuffle(steps)
    x = rng.random((N, M)).astype(np.float32)
    i, j, k = 0, 0, 0
    planted = []
    while True:
        x[i, j] -= 1
        planted.append((i, j))
        if k == len(steps):
            break
        if k + 1 < len(steps) and steps[k] != steps[k + 1]:
            i, j, k = i + 1, j + 1, k + 2
            continue
        i, j, k = i + (steps[k] == 0), j + (steps[k] == 1), k + 1
    path = pdtw.dtw(torch.from_numpy(x))
    np.testing.assert_array_equal(path, np.array(planted).T)
    np.testing.assert_array_equal(path, dtw_np(x))
    np.testing.assert_array_equal(path, dtw_pallas(x, interpret=True))


def test_dtw_wrapper_routes_by_device():
    """CPU tensors take the plain version and launch nothing; a device that
    is neither CPU nor CUDA is refused."""
    pdtw.dtw_trace.launches = 0
    pdtw.dtw_trace(torch.zeros(3, 4))
    assert pdtw.dtw_trace.launches == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pdtw.dtw_trace(torch.zeros(3, 4, device="meta"))


# ---- median filter ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 15), (4, 5, 345), (12, 240)])
@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_median_matches_np_and_pallas(shape, width):
    """The shapes and widths of tests/test_pallas_kernels.py:20-27."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    got = pmed.median_filter(torch.from_numpy(x), width).numpy()
    np.testing.assert_array_equal(got, median_filter_np(x, width))
    np.testing.assert_array_equal(got, median_filter_pallas(x, width, interpret=True))


@pytest.mark.parametrize("n_valid", [4, 51, 199, 200])
def test_median_reflects_at_n_valid(n_valid):
    """The boundary is the valid column count, not the array's edge: the
    valid columns equal median_filter_np of the sliced array, on inputs
    rounded to a coarse grid so that equal values occur; the columns past
    the boundary are the input's."""
    x = np.round(np.random.RandomState(3).randn(6, 200) * 2) / 2
    x = x.astype(np.float32)
    got = pmed.median_filter(torch.from_numpy(x), 7, n_valid=n_valid).numpy()
    np.testing.assert_array_equal(got[:, :n_valid], median_filter_np(x[:, :n_valid], 7))
    np.testing.assert_array_equal(got[:, n_valid:], x[:, n_valid:])


def _special_rows(seed, rows, T):
    """Rows with planted NaN (one, three and four in a window of 7), +-inf,
    and 0.0 beside -0.0, among coarse-grid numbers."""
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(rows, T) * 2) / 2
    x[0, 10] = np.nan  # one NaN
    x[1, [20, 22, 24]] = np.nan  # three: the median is still a number
    x[2, 30:34] = np.nan  # four: the median is NaN
    x[3, [0, 2]] = np.nan  # at the reflected edge
    x[4, [5, 40]], x[4, [6, 41]] = np.inf, -np.inf
    x[5, 50:56] = [0.0, -0.0, 0.0, -0.0, -0.0, 1.0]
    u = rng.rand(rows, T)
    x[6:] = np.where(u[6:] < 0.2, np.nan, np.where(u[6:] < 0.3, np.inf, np.where(u[6:] < 0.4, -0.0, x[6:])))
    return x.astype(np.float32)


@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_median_orders_nan_last_as_the_jax_package(width):
    """NaN sorts above every number, as jnp.sort and np.sort put it: the
    plain version equals median_filter_np and median_filter_jax (the
    word-timing path's jnp.sort rule) at n_valid = T, and median_filter_np
    of the sliced rows at n_valid < T, NaN where they have NaN."""
    x = _special_rows(width, 10, 64)
    got = pmed.median_filter(torch.from_numpy(x), width).numpy()
    np.testing.assert_array_equal(got, median_filter_np(x, width))
    np.testing.assert_array_equal(got, np.asarray(median_filter_jax(x, width)))
    if width == 7:
        assert np.isnan(got[2, 31:33]).all() and np.isfinite(got[1, 22]) and np.isfinite(got[0, 10])
    for n_valid in (7, 37):
        got = pmed.median_filter(torch.from_numpy(x), width, n_valid=n_valid).numpy()
        np.testing.assert_array_equal(got[:, :n_valid], median_filter_np(x[:, :n_valid], width))
        np.testing.assert_array_equal(got[:, n_valid:], x[:, n_valid:])


def test_median_identity_and_argument_checks():
    x = torch.from_numpy(np.random.RandomState(5).random((10, 2)).astype(np.float32))
    assert torch.equal(pmed.median_filter(x, 7), x)  # T <= width // 2: identity
    with pytest.raises(ValueError, match="odd"):
        pmed.median_filter(torch.zeros(2, 9), 4)
    with pytest.raises(ValueError, match="n_valid"):
        pmed.median_filter(torch.zeros(2, 9), 7, n_valid=3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pmed.median_filter(torch.zeros(2, 9, device="meta"), 3)


# ---- CUDA kernels vs plain versions (on a card) -------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N, M, tied",
    [(252, 1500, False), (40, 750, True), (10, 20, True), (1023, 40, True), (33, 31, False)],
)
def test_dtw_kernel_matches_plain(cuda_device, N, M, tied):
    rng = np.random.RandomState(N)
    x = rng.randint(-2, 3, size=(N, M)) if tied else rng.randn(N, M)
    x = torch.from_numpy(x.astype(np.float32))
    got = pdtw.dtw_trace(x.to(cuda_device)).cpu()
    assert torch.equal(got, pdtw.dtw_trace_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [1500, 551])
@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_median_kernel_orders_nan_last(cuda_device, n_valid, width):
    x = torch.from_numpy(_special_rows(width, 300, 1500))
    got = pmed.median_filter(x.to(cuda_device), width, n_valid=n_valid).cpu()
    want = pmed.median_filter_plain(x, width, n_valid=n_valid)
    np.testing.assert_array_equal(got.numpy(), want.numpy())  # NaN where NaN


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [1500, 551])
@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_median_kernel_matches_plain(cuda_device, n_valid, width):
    x = np.round(np.random.RandomState(width).randn(300, 1500) * 4) / 4
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    got = pmed.median_filter(x, width, n_valid=n_valid)
    assert torch.equal(got, pmed.median_filter_plain(x, width, n_valid=n_valid))
