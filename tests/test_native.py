"""Native C++ SDPA tokenizer must agree with the pure-Python reader."""

import numpy as np
import pytest

import instances
from hdsdp_tpu.io import sdpa as pysdpa
from hdsdp_tpu.native import sdpa_native

@pytest.mark.parametrize("fname", sorted(instances.SDPA))
def test_native_matches_python(fname):
    path = instances.path(fname)
    dn = sdpa_native.read(path)
    if dn is None:
        pytest.skip("native tokenizer unavailable (no g++?)")
    with open(path) as fh:  # bypass the native fast path
        dp = pysdpa.read_sdpa(fh)

    assert dn.m == dp.m
    assert dn.block_dims == dp.block_dims
    np.testing.assert_allclose(dn.b, dp.b)
    for bn, bp in zip(dn.blocks, dp.blocks):
        kn = np.lexsort((bn.col, bn.row, bn.con))
        kp = np.lexsort((bp.col, bp.row, bp.con))
        np.testing.assert_array_equal(bn.con[kn], bp.con[kp])
        np.testing.assert_array_equal(bn.row[kn], bp.row[kp])
        np.testing.assert_array_equal(bn.col[kn], bp.col[kp])
        np.testing.assert_allclose(bn.val[kn], bp.val[kp])
    assert (dn.lp is None) == (dp.lp is None)
    if dp.lp is not None:
        assert dn.lp.ncols == dp.lp.ncols
        kn = np.lexsort((dn.lp.var, dn.lp.con))
        kp = np.lexsort((dp.lp.var, dp.lp.con))
        np.testing.assert_allclose(dn.lp.val[kn], dp.lp.val[kp])
