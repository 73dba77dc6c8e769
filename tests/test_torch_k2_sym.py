"""K2's symmetric route (``ops/gram.gram_matvec_sym``): the schedule that the
card's walk takes (``ops/_cuda.sym_schedule``), the walk's sums emulated on
the host from that schedule, the CPU route, and the CG's use of the route.

The kernel itself (``csrc/gram_eval.cuh::sym_walk``) runs only on the card,
where ``chip_smoke.py`` holds it to ``gram_matvec`` and to float64 rows; the
emulation here follows its slots and its order of summation.
"""

import contextlib

import numpy as np
import pytest
import torch

from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.models import iterative
from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
from linpde_gp_tpu_torch.ops import _cuda
from linpde_gp_tpu_torch.ops.gram import gram_matvec, gram_matvec_sym, gram_plain
from linpde_gp_tpu_torch.specs import load_specs

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

SPECS = load_specs()
OBS = SPECS["obs"]


def _points(n, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return torch.tensor(np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1), dtype=dtype)


def _walk(sched):
    """The tile pairs each chunk visits, in order, as the kernel walks them."""
    out = []
    for i, j, count, _ in sched.chunks.tolist():
        pairs = []
        for _ in range(count):
            pairs.append((i, j))
            j += 1
            if j == sched.tiles:
                i += 1
                j = i
        out.append(pairs)
    return out


# (n, tile, blocks): ragged n, n below one tile, the f64 and plain tiles at
# N = 1e5 with the H100's persistent grids, more blocks than pairs.
CASES = [(1, 256, 660), (100, 256, 660), (256, 256, 4), (257, 256, 4), (1000, 256, 7), (5000, 512, 3),
         (99_997, 256, 660), (100_000, 256, 528), (100_000, 512, 924), (2049, 256, 1000)]


@pytest.mark.parametrize("n,tile,blocks", CASES)
def test_schedule_covers_each_tile_pair_once(n, tile, blocks):
    """Every unordered tile pair (I, J), J >= I, lies in exactly one chunk;
    chunks differ by at most one pair; each chunk's first pair index and
    the row blocks' chunk ranges agree with the walk."""
    sched = _cuda.sym_schedule(n, tile, blocks)
    nb = -(-n // tile)
    assert sched.tiles == nb and sched.pairs == nb * (nb + 1) // 2
    assert len(sched.chunks) == min(blocks, sched.pairs)
    assert sched.chunks.dtype == np.int32 and sched.rows.dtype == np.int32
    counts = sched.chunks[:, 2]
    assert counts.min() >= 1 and counts.max() - counts.min() <= 1 and counts.sum() == sched.pairs
    walked = _walk(sched)
    flat = [p for chunk in walked for p in chunk]
    assert flat == [(i, j) for i in range(nb) for j in range(i, nb)]
    assert sched.chunks[:, 3].tolist() == np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
    for i in range(nb):
        holders = [c for c, chunk in enumerate(walked) if any(p[0] == i for p in chunk)]
        assert sched.rows[i].tolist() == [holders[0], holders[-1]]
        assert holders == list(range(holders[0], holders[-1] + 1))


@pytest.mark.parametrize("n,tile,blocks", [(1000, 256, 7), (99_997, 256, 660)])
def test_row_runs_have_distinct_slots(n, tile, blocks):
    """A run of one row block inside one chunk writes its row sums to slot
    pairs + c + I: distinct for every run, and inside the scratch."""
    sched = _cuda.sym_schedule(n, tile, blocks)
    runs = {(c, i) for c, chunk in enumerate(_walk(sched)) for i, _ in chunk}
    slots = {sched.pairs + c + i for c, i in runs}
    assert len(slots) == len(runs) and max(slots) < sched.slots


def _emulate(sched, K, v, tile):
    """K @ v by the kernel's walk on the host: each tile pair once, column
    sums to the pair's slot, row sums to each run's slot, then the second
    pass's sums in its order."""
    n, r = v.shape
    nb = sched.tiles
    pad = nb * tile
    Kp = np.zeros((pad, pad))
    Kp[:n, :n] = K
    vp = np.zeros((pad, r))
    vp[:n] = v
    col = np.full((sched.pairs, tile, r), np.nan)
    row = np.full((len(sched.chunks) + nb - 1, tile, r), np.nan)
    for c, chunk in enumerate(_walk(sched)):
        tot = np.zeros((tile, r))
        for k, (i, j) in enumerate(chunk):
            blk = Kp[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            rows_g = np.triu(blk) if i == j else blk  # row i takes the columns j >= i
            cols_g = np.triu(blk, 1) if i == j else blk  # column j the rows i < j
            tot += rows_g @ vp[j * tile:(j + 1) * tile]
            col[sched.chunks[c, 3] + k] = cols_g.T @ vp[i * tile:(i + 1) * tile]
            if k + 1 == len(chunk) or j + 1 == nb:
                row[c + i] = tot
                tot = np.zeros((tile, r))
    out = np.empty((pad, r))
    for jt in range(nb):
        first, last = sched.rows[jt]
        acc = sum(row[c + jt] for c in range(first, last + 1))
        p = jt
        for i in range(jt + 1):
            acc = acc + col[p]
            p += nb - i - 1
        out[jt * tile:(jt + 1) * tile] = acc
    return out[:n]


@pytest.mark.parametrize("n,tile,blocks,r", [(1, 8, 4, 1), (37, 8, 5, 1), (64, 8, 3, 2), (101, 16, 9, 4),
                                             (100, 16, 100, 3)])
def test_walk_by_the_schedule_sums_the_whole_product(n, tile, blocks, r):
    """The walk's slots and second pass give K v for a symmetric K, on a
    ragged n, n below one tile and more blocks than pairs, reading no slot
    left unwritten."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    K = A + A.T
    v = rng.standard_normal((n, r))
    got = _emulate(_cuda.sym_schedule(n, tile, blocks), K, v, tile)
    np.testing.assert_allclose(got, K @ v, rtol=1e-12, atol=1e-12 * np.abs(K).sum(1).max() * np.abs(v).max())


@pytest.mark.parametrize("case", ["n", "tile", "blocks"])
def test_schedule_rejects_empty_arguments(case):
    args = dict(n=10, tile=8, blocks=4)
    args[case] = 0
    with pytest.raises(ValueError, match="sym_schedule"):
        _cuda.sym_schedule(**args)


@pytest.mark.parametrize("r", [1, 2, 4, 6])
def test_cpu_route_equals_the_cross_form(r, monkeypatch):
    """On CPU tensors the symmetric entry is gram_matvec(spec, X, X, v), on
    the narrow widths and the multi-column width, held to the plain Gram's
    product, and never reaches the CUDA wrappers."""

    def refuse(*args, **kwargs):
        raise AssertionError("CPU tensor routed to a CUDA wrapper")

    for name in ("gram_matvec", "gram_matvec_sym"):
        monkeypatch.setattr(_cuda, name, refuse)
    X = _points(300, 5)
    v = torch.tensor(np.random.default_rng(6).standard_normal((300, r)))
    before = dict(_cuda.launches)
    got = gram_matvec_sym(OBS, X, v, "f64")
    assert torch.equal(got, gram_matvec(OBS, X, X, v, "f64"))
    torch.testing.assert_close(got, OBS[0] * gram_plain(OBS[1], X, X, "f64") @ v, rtol=1e-12, atol=1e-10)
    assert _cuda.launches == before


def _regressor(n=600):
    rng = np.random.default_rng(2)
    X = np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)
    return IterativeGPRegressor.from_specs(SPECS["obs"], SPECS["cross"], X, rng.standard_normal(n),
                                           noise_variance=1e-4, precond_rank=128, tol=1e-8, mode="f64",
                                           device="cpu")


def test_cg_takes_the_symmetric_entry_and_the_mean_does_not(monkeypatch):
    """Every matvec of the CG goes through gram_matvec_sym on (X, X), one a
    CG iteration; the mean's cross form (k L*)(xq, X) goes through
    gram_matvec."""
    calls = {"sym": [], "cross": []}

    def sym(spec, X, v, mode):
        calls["sym"].append(X)
        return gram_matvec_sym(spec, X, v, mode)

    def cross(spec, X0, X1, v, mode):
        calls["cross"].append((X0, X1))
        return gram_matvec(spec, X0, X1, v, mode)

    monkeypatch.setattr(iterative, "gram_matvec_sym", sym)
    monkeypatch.setattr(iterative, "gram_matvec", cross)
    reg = _regressor()
    reg.representer_weights
    iters = reg.solve_info[0]
    assert iters > 0 and len(calls["sym"]) == iters and not calls["cross"]
    assert all(X is reg.X for X in calls["sym"])
    reg.mean(_points(16, 9).numpy())
    assert len(calls["sym"]) == iters and len(calls["cross"]) == 1
    assert calls["cross"][0][1] is reg.X and calls["cross"][0][0] is not reg.X


def test_scratch_is_kept_per_stream_and_grown(monkeypatch):
    """The route's scratch: one buffer a (device, stream), each in a memory
    pool of its own, reused by every call that fits in it, whatever its
    dtype, and replaced by a larger one only when a call needs more."""
    pools = []

    @contextlib.contextmanager
    def use_mem_pool(pool, device):
        pools.append((pool, device))
        before = dict(_cuda._sym_scratch)
        yield
        # No pool is dropped while another one is allocated to.
        assert _cuda._sym_scratch == before

    monkeypatch.setattr(_cuda, "_sym_scratch", {})
    monkeypatch.setattr(_cuda, "_sym_room", lambda device: 10**9)
    monkeypatch.setattr(torch.cuda, "MemPool", object)
    monkeypatch.setattr(torch.cuda, "use_mem_pool", use_mem_pool)
    cpu = torch.device("cpu")
    a = _cuda._sym_buffer(cpu, 7, torch.float64, (1, 100))
    b = _cuda._sym_buffer(cpu, 7, torch.float32, (2, 100))
    assert a.shape == (1, 100) and b.shape == (2, 100) and b.dtype == torch.float32
    assert a.data_ptr() == b.data_ptr() and len(pools) == 1
    c = _cuda._sym_buffer(cpu, 8, torch.float64, (1, 100))
    assert c.data_ptr() != a.data_ptr() and len(_cuda._sym_scratch) == 2 and len(pools) == 2
    d = _cuda._sym_buffer(cpu, 7, torch.float64, (1, 101))
    assert d.shape == (1, 101) and _cuda._sym_scratch[cpu, 7][1].numel() == 808 and len(pools) == 3
    assert _cuda._sym_buffer(cpu, 7, torch.float64, (1, 50)).data_ptr() == d.data_ptr()
    assert all(dev == cpu for _, dev in pools) and _cuda._sym_scratch[cpu, 7][0] is pools[-1][0]


@pytest.fixture
def fake_pools(monkeypatch):
    """The scratch's pools as plain objects, its table empty, and 1,000
    bytes of room on the device."""
    monkeypatch.setattr(_cuda, "_sym_scratch", {})
    monkeypatch.setattr(_cuda, "_sym_room", lambda device: 1000)
    monkeypatch.setattr(torch.cuda, "MemPool", object)
    monkeypatch.setattr(torch.cuda, "use_mem_pool", lambda pool, device: contextlib.nullcontext())


def test_scratch_beyond_its_share_of_free_memory_raises(fake_pools):
    """A scratch that would take more than SYM_SCRATCH_SHARE of the room
    raises an out-of-memory error that names the scratch and keeps none;
    one within it is taken, and is not measured against the room again."""
    cpu = torch.device("cpu")
    limit = int(_cuda.SYM_SCRATCH_SHARE * 1000) // 8
    with pytest.raises(torch.cuda.OutOfMemoryError, match="scratch .* grows as n\\^2"):
        _cuda._sym_buffer(cpu, 7, torch.float64, (1, limit + 1))
    assert not _cuda._sym_scratch
    a = _cuda._sym_buffer(cpu, 7, torch.float64, (1, limit))
    assert a.shape == (1, limit) and len(_cuda._sym_scratch) == 1
    assert _cuda._sym_buffer(cpu, 7, torch.float32, (1, 2 * limit)).data_ptr() == a.data_ptr()


def test_release_sym_scratch_drops_every_buffer(fake_pools):
    """release_sym_scratch drops the scratch of every stream; the next call
    takes a new one."""
    cpu = torch.device("cpu")
    a = _cuda._sym_buffer(cpu, 7, torch.float64, (1, 10))
    _cuda._sym_buffer(cpu, 8, torch.float64, (1, 10))
    pool = _cuda._sym_scratch[cpu, 7][0]
    _cuda.release_sym_scratch()
    assert not _cuda._sym_scratch
    b = _cuda._sym_buffer(cpu, 7, torch.float64, (1, 10))
    assert _cuda._sym_scratch[cpu, 7][0] is not pool and b.shape == a.shape
