"""The port's on-device auction matcher against the JAX package's
``auction_match`` on the same f32 cost batches: the assignment and the
``repaired_gt`` count must be identical, not close (every step is a max, an
argmax, an add or a compare in f32).  The batches are those of
tests/test_losses.py's auction tests, plus the flagship step's shape, a
single query, and bidding wars long enough that the cap binds at several
points of a chunk."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from spike2former_tpu.losses.matcher import auction_match as jax_auction
from spike2former_tpu_torch.losses.matcher import BIG_COST, auction_match


@functools.cache
def _jax_auction(**kw):
    """JAX's ``auction_match`` jitted once per option set: dispatched op by
    op, each call compiles its while loop anew.  Its steps are maxes,
    argmaxes, adds and compares in f32, which jit leaves exact."""
    return jax.jit(functools.partial(jax_auction, with_stats=True, **kw))


def _both(c, **kw):
    """(JAX's matched, repaired), (the port's matched, repaired, stats)."""
    jm, jrep = _jax_auction(**kw)(jnp.asarray(c))
    tm, stats = auction_match(torch.from_numpy(c), with_stats=True, **kw)
    return (np.asarray(jm), int(jrep)), (tm.numpy(), int(stats.repaired),
                                         stats)


def _assert_identical(c, **kw):
    (jm, jrep), (tm, trep, stats) = _both(c, **kw)
    np.testing.assert_array_equal(tm, jm)
    assert trep == jrep
    return tm, trep, stats


def _tight_gaps():
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 0.4, (1, 10, 6)).astype(np.float32)
            for _ in range(50)]


def _padded(b=8, nq=100, g=32, n_valid=16, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 8, (b, nq, g)).astype(np.float32)
    c[:, :, n_valid:] = BIG_COST
    return c


def _war(b=3, nq=6, g=4, margin=2.0, seed=0):
    """Columns 0-2 all prefer queries 0 and 1 by ``margin``: the prices of
    the two rise by about eps an iteration until one column gives up, a
    bidding war of ~100 iterations."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 0.01, (b, nq, g)).astype(np.float32) + margin
    c[:, :2, :3] = rng.uniform(0, 0.001, (b, 2, 3))
    return c


def test_auction_identical_on_tight_gaps():
    for c in _tight_gaps():
        m, _, _ = _assert_identical(c)
        assert sorted(m[0].tolist()) == sorted(set(m[0].tolist()))
        assert (m >= 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_auction_identical_with_parked_columns(seed):
    """[8, 100, 32] with 16 BIG_COST columns: parked columns come back -1,
    the others complete, unique and within G_valid * eps of scipy."""
    c = _padded(seed=seed)
    m, rep, _ = _assert_identical(c)
    assert rep == 0 and (m[:, 16:] == -1).all()
    for i in range(c.shape[0]):
        assert len(set(m[i, :16].tolist())) == 16 and (m[i, :16] >= 0).all()
        r, cols = linear_sum_assignment(c[i, :, :16].T)
        opt = c[i, :, :16].T[r, cols].sum()
        got = sum(c[i, m[i, j], j] for j in range(16))
        assert got - opt <= 16 * 0.02 + 1e-5


def test_auction_identical_at_the_flagship_step_shape():
    """The cost batch of one flagship train step: L*B = 7*6 problems of
    100 queries by 32 compacted slots, 10-30 of them valid."""
    rng = np.random.default_rng(3)
    c = rng.normal(0, 4, (42, 100, 32)).astype(np.float32)
    n_valid = rng.integers(10, 31, 42)
    for i, n in enumerate(n_valid):
        c[i, :, n:] = BIG_COST
    m, rep, stats = _assert_identical(c)
    assert rep == 0
    assert stats.syncs <= int(stats.iterations) and int(stats.iterations) > 0


@pytest.mark.parametrize("repair", [True, False])
def test_auction_identical_when_capped(repair):
    """num_iters=1 cannot finish 6 columns: with repair every valid column
    gets a distinct free query, without it some stay -1; both equal
    JAX's, and so does the count."""
    rng = np.random.default_rng(1)
    c = rng.normal(0, 1, (4, 12, 8)).astype(np.float32)
    c[:, :, 6:] = BIG_COST
    m, rep, stats = _assert_identical(c, num_iters=1, repair=repair)
    assert rep > 0 and stats.syncs == 1 and int(stats.iterations) == 1
    assert (m[:, 6:] == -1).all()
    if repair:
        for i in range(4):
            assert min(m[i, :6]) >= 0 and len(set(m[i, :6].tolist())) == 6
    else:
        assert (m[:, :6] < 0).any()


@pytest.mark.parametrize("num_iters", [2, 3, 5, 11, 13, 29, 44, 61, 600])
def test_auction_cap_stops_at_exactly_num_iters(num_iters):
    """A bidding war of ~100 iterations capped inside and between the
    chunks of 4, 8, 16, 16, ... iterations the port runs between its reads
    of the loop condition."""
    c = _war()
    _, rep, stats = _assert_identical(c, num_iters=num_iters)
    if num_iters < 600:
        assert int(stats.iterations) == num_iters and rep > 0
    else:
        assert rep == 0 and 50 < int(stats.iterations) < 600


@pytest.mark.parametrize("g", [1, 3])
def test_auction_identical_with_one_query(g):
    """nq = 1: no second-best exists (second = top), and every column but
    one is parked or left to the repair."""
    rng = np.random.default_rng(4)
    c = rng.normal(0, 1, (3, 1, g)).astype(np.float32)
    c[:, :, 1:] = BIG_COST
    m, rep, _ = _assert_identical(c)
    assert (m[:, 0] == 0).all() and (m[:, 1:] == -1).all() and rep == 0

