"""SDPA reader + problem IR tests on the in-repo instances (tests/data)."""

import io

import numpy as np
import pytest

import instances
from hdsdp_tpu.io.sdpa import read_sdpa
from hdsdp_tpu.models.problem import SDPProblem

SMALL = """\
* toy problem
2
2
{2, -2}
1.0 2.0
0 1 1 1 2.0
0 1 1 2 1.0
1 1 1 1 1.0
2 1 2 2 3.0
1 2 1 1 1.0
2 2 2 2 5.0
"""


def test_read_small_with_lp():
    data = read_sdpa(io.StringIO(SMALL))
    assert data.m == 2
    assert data.block_dims == [2]
    assert data.lp is not None and data.lp.ncols == 2
    np.testing.assert_allclose(data.b, [1.0, 2.0])
    blk = data.blocks[0]
    # objective entries negated, lower-tri normalized
    obj = {(int(r), int(c)): v for r, c, v in zip(blk.row[blk.con == 0], blk.col[blk.con == 0], blk.val[blk.con == 0])}
    assert obj[(0, 0)] == -2.0
    assert obj[(1, 0)] == -1.0


def test_read_maxcut100():
    data = read_sdpa(instances.path("maxcut100.dat-s"))
    assert data.m == 100
    assert data.block_dims == [100]
    assert data.lp is None
    # maxcut relaxations: diag(X) = b with every b_i nonzero
    assert np.all(data.b != 0)


def test_read_control10():
    data = read_sdpa(instances.path("control10.dat-s"))
    assert data.m == 55
    assert data.block_dims == [10, 10]


def test_read_theta50_gpp100():
    t = read_sdpa(instances.path("theta50.dat-s"))
    assert t.m == 104 and t.block_dims == [50]
    g = read_sdpa(instances.path("gpp100.dat-s"))
    assert g.m == 101 and g.block_dims == [100]


@pytest.mark.parametrize("fname", sorted(instances.SDPA))
def test_data_file_round_trip(fname):
    """Each committed instance is exactly what its seeded generator
    writes, and reading it back restores the generator's structure."""
    with open(instances.path(fname)) as fh:
        assert fh.read() == instances.sdpa_text(fname)
    gen = instances.SDPA[fname]()
    with open(instances.path(fname)) as fh:  # the Python reader
        data = read_sdpa(fh)
    assert data.m == gen.m
    assert data.block_dims == gen.block_dims
    np.testing.assert_array_equal(data.b, gen.b)
    assert len(data.blocks) == len(gen.blocks)
    for got, want in zip(data.blocks, gen.blocks):
        nz = np.abs(want.val) >= 1e-12  # the reader drops zero entries
        kg = np.lexsort((got.col, got.row, got.con))
        kw = np.lexsort((want.col[nz], want.row[nz], want.con[nz]))
        np.testing.assert_array_equal(got.con[kg], want.con[nz][kw])
        np.testing.assert_array_equal(got.row[kg], want.row[nz][kw])
        np.testing.assert_array_equal(got.val[kg], want.val[nz][kw])


@pytest.mark.parametrize("fname", sorted(instances.LP))
def test_lp_data_file_round_trip(fname):
    with open(instances.path(fname)) as fh:
        assert fh.read() == instances.mps_text(fname)


def test_problem_build_maxcut100():
    data = read_sdpa(instances.path("maxcut100.dat-s"))
    prob = SDPProblem.from_sdpa(data)
    assert prob.m == 100
    assert len(prob.groups) == 1
    grp = prob.groups[0]
    assert grp.dim == 100 and grp.nblk == 1
    # all maxcut constraints are e_i e_i^T: rank-1 bucket, no dense bucket
    assert grp.md == 0
    assert grp.R == 100
    # implied trace structure should be detected (diag(X) = b)
    assert prob.features.implied_trace
    # reconstruct A'y from buckets and compare against raw entries
    y = np.random.default_rng(0).normal(size=prob.m)
    W = np.einsum("grn,gr,grm->gnm", grp.F, grp.lam * y[grp.seg], grp.F)[0]
    A_full = np.zeros((100, 100))
    blk = data.blocks[0]
    msk = blk.con > 0
    np.add.at(A_full, (blk.row[msk], blk.col[msk]), y[blk.con[msk] - 1] * blk.val[msk])
    A_full = A_full + np.tril(A_full, -1).T
    np.testing.assert_allclose(W, A_full, atol=1e-12)


def test_problem_build_theta50():
    data = read_sdpa(instances.path("theta50.dat-s"))
    prob = SDPProblem.from_sdpa(data)
    grp = prob.groups[0]
    # theta constraint 1 is the identity (trace constraint)
    assert prob.features.implied_trace
    # check bucket reconstruction of a few constraints against raw data
    blk = data.blocks[0]
    n = grp.dim
    for icon in [1, 2, 50]:
        msk = blk.con == icon
        A_raw = np.zeros((n, n))
        np.add.at(A_raw, (blk.row[msk], blk.col[msk]), blk.val[msk])
        A_raw = A_raw + np.tril(A_raw, -1).T
        # from buckets
        A_b = np.zeros((n, n))
        sel = grp.seg[0] == (icon - 1)
        if sel.any():
            Fv = grp.F[0][sel]
            A_b += (Fv.T * grp.lam[0][sel]) @ Fv
        for k in range(grp.md):
            if grp.didx[k] == icon - 1:
                A_b += grp.Ad[k]
        np.testing.assert_allclose(A_b, A_raw, atol=1e-10)


def test_low_rank_exactness():
    # random rank-2 matrix must be recovered exactly by restricted eig
    rng = np.random.default_rng(1)
    n = 30
    u = rng.normal(size=n)
    v = rng.normal(size=n)
    A = np.outer(u, u) - 2.0 * np.outer(v, v)
    r, c = np.tril_indices(n)
    vals = A[r, c]
    nz = vals != 0
    from hdsdp_tpu.models.coeffs import analyze_coeff

    info = analyze_coeff(n, r[nz], c[nz], vals[nz], rank_cap=8)
    assert info.rank == 2
    A_rec = (info.vecs.T * info.lam) @ info.vecs
    np.testing.assert_allclose(A_rec, A, atol=1e-8)
