"""core_tpu_torch QMC sequences equal core_tpu's bit for bit.

Indices are made with numpy from a seed (plus the edge values 0, 2**31 and
2**32-1) and handed to both packages; float samples are compared as raw
float32 bits, hashes as integers.
"""
import numpy as np
import pytest
import torch

from core_tpu.sampling import qmc as jq
from core_tpu_torch.sampling import qmc as tq

torch.set_num_threads(1)


def _indices(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    rand = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([edge, rand])


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _same_bits(j, t):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))
    else:
        np.testing.assert_array_equal(j.astype(np.int64), t)


@pytest.mark.parametrize("fn", ["ri_vdc", "ri_s", "ri_lp"])
@pytest.mark.parametrize("scrambled", [False, True])
def test_radical_inverses_base2(fn, scrambled):
    i = _indices(1)
    s = _indices(2)
    if scrambled:
        _same_bits(getattr(jq, fn)(i, s), getattr(tq, fn)(_t(i), _t(s)))
    else:
        _same_bits(getattr(jq, fn)(i), getattr(tq, fn)(_t(i)))


def test_fnv32a():
    i = _indices(3)
    _same_bits(jq.fnv32a(i), tq.fnv32a(_t(i)))
    # the render's per-pixel hash fnv(y * fnv(x)) with uint32 wrap-around
    y = np.arange(64, dtype=np.uint32)
    x = np.arange(64, dtype=np.uint32)[::-1].copy()
    want = jq.fnv32a(y * np.asarray(jq.fnv32a(x)))
    got = tq.fnv32a((_t(y) * tq.fnv32a(_t(x))) & tq.MASK32)
    _same_bits(want, got)


def test_radical_inverse_base3():
    """Base 3 is what the NEE's second light-sample dimension uses."""
    i = _indices(4)
    _same_bits(jq.radical_inverse(3, i), tq.radical_inverse(3, _t(i)))


def test_radical_inverse_higher_bases_within_an_ulp():
    """core_tpu's jitted CPU build contracts digit multiply-adds into FMAs
    at bases >= 5; the port rounds each product, so they agree to 1 ulp."""
    i = _indices(5)
    for base in (5, 7):
        j = np.asarray(jq.radical_inverse(base, i))
        t = tq.radical_inverse(base, _t(i)).numpy()
        np.testing.assert_array_max_ulp(j, t, maxulp=1)


# every scr_halton dimension the path tracer reaches at bounces <= 5
# (path.py:213-218: 2, then 4d+3 and 4d+4), plus the rest up to 24 and the
# dim >= 50 fallback
@pytest.mark.parametrize("dims", [list(range(2, 13)), list(range(13, 25)),
                                  [41, 49, 50, 57]])
def test_scr_halton(dims):
    i = _indices(6)
    for dim in dims:
        _same_bits(jq.scr_halton(dim, i), tq.scr_halton(dim, _t(i)))


def test_faure_permutations():
    for b in (2, 3, 5, 7, 11, 31, 64, 97, 227):
        assert tuple(int(x) for x in jq._faure_permutation(b)) \
            == tq._faure_permutation(b)
