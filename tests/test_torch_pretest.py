"""Kernel 1's division-free pre-test (csrc/intersect.cu, closest_hit_kernel)
never rejects a row that the exact test accepts.

The kernel runs the exact Möller-Trumbore test of
geometry/intersect.closest_hit_torch only on the rows that pass the
pre-test, so its hits are the plain version's only if the pre-test passes
every row the exact test accepts.  The header of csrc/intersect.cu argues
why; these tests replay both tests in float32 (each operation rounded on
its own, as in the kernel built with --fmad=false) on ray-triangle pairs
aimed at the tests' edges: rays at triangle edges and vertices, slivers
with |det| near 1e-12, tmin, tcap and the best t within a few ulps of the
hit, negative and zero tmin, open and infinite caps, at scales from 1e-6
to 1e12 (beyond them |det| falls below 1e-12 or the float32 products
overflow, and no row is accepted).  With no slack the same pairs show
rejected accepts, so they reach the edges the slack covers.
"""
import numpy as np
import pytest
import torch

F32 = torch.float32
BIG = 3.0e38
SCALES = (1e-6, 1e-3, 1.0, 1e3, 1e6, 1e9, 1e12)


def _fold(x, det):
    """x times (det < 0 ? -1 : 1) as a flip of det's sign bit (fold)."""
    sb = det.view(torch.int32) & torch.tensor(-2**31, dtype=torch.int32)
    return (x.view(torch.int32) ^ sb).view(F32)


def _tests(o, d, tmin, tcap, bt, tri, slack):
    """(exact, pre) acceptance of one triangle per ray: the exact test of
    closest_hit_torch against best t bt, and kernel 1's pre-test with
    relative slack `slack` (2^-18 in the kernel)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(1)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    un = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vn = dx * qx + dy * qy + dz * qz
    tn = e2x * qx + e2y * qy + e2z * qz
    det_ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    u, v, t = un * inv, vn * inv, tn * inv
    exact = det_ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
        & (t > tmin) & (t < tcap) & (t < bt)
    dd = det.abs()
    un, vn, tn = _fold(un, det), _fold(vn, det), _fold(tn, det)
    hi = torch.tensor(1.0 + slack, dtype=F32)
    lo = torch.tensor(-slack, dtype=F32)
    tmin_ok = tmin >= 0
    tlo = torch.where(tmin_ok, 0.0, -torch.inf).to(F32)
    c = torch.minimum(tcap, bt)
    pc = torch.where(tmin_ok & (c >= 2.0**-60), c * hi,
                     torch.full_like(c, torch.inf))
    pre = (dd > 1e-12) & (un >= dd * lo) & (vn >= dd * lo) \
        & (un + vn <= dd * hi) & (tn > tlo) & (tn < pc * dd)
    return exact, pre


def _ulps(x, k, rng):
    step = rng.integers(-k, k + 1, size=x.shape).astype(np.int64)
    return (x.view(np.int32).astype(np.int64) + step).astype(
        np.int32).view(np.float32)


def _pairs(scale, rng, n=20_000):
    """Six sets of n rays, each aimed at its own triangle: interior points,
    the edges u = 0, v = 0, u + v = 1, vertex v0, and slivers."""
    out = []
    for mode in range(6):
        v0, e1, e2 = (rng.normal(size=(n, 3)) * scale for _ in range(3))
        if mode == 5:
            e2 = e1 * (1 + rng.normal(size=(n, 1)) * 1e-6) \
                + rng.normal(size=(n, 3)) * 1e-7 * scale
        a = rng.random(n)
        b = rng.random(n) * (1 - a)
        if mode == 1:
            a = np.zeros(n)
        elif mode == 2:
            b = np.zeros(n)
        elif mode == 3:
            b = 1 - a
        elif mode == 4:
            a, b = np.zeros(n), np.zeros(n)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dist = rng.random(n) * 10 * scale + 1e-30
        o = v0 + a[:, None] * e1 + b[:, None] * e2 - d * dist[:, None]
        tri = _ulps(np.concatenate([v0, e1, e2], 1).astype(np.float32), 2,
                    rng)
        o = _ulps(o.astype(np.float32), 3, rng)
        d = _ulps(d.astype(np.float32), 2, rng)
        dist = dist.astype(np.float32)

        def pick(p, x, y):
            return np.where(rng.random(n) < p, x, y).astype(np.float32)

        tmin = pick(0.3, _ulps(dist, 40, rng), 5e-5)
        tmin = pick(0.1, 0.0, tmin)
        tmin = pick(0.1, -rng.random(n) * scale, tmin)
        tcap = pick(0.4, _ulps(dist, 40, rng), BIG)
        tcap = pick(0.1, np.inf, tcap)
        tcap = np.where(tcap <= 0, np.float32(BIG), tcap)
        bt = pick(0.4, _ulps(dist, 40, rng), BIG)
        bt = pick(0.05, rng.random(n) * 1e-30, bt)
        out.append([torch.from_numpy(np.ascontiguousarray(x))
                    for x in (o, d, tmin, tcap, bt, tri)])
    return out


@pytest.mark.parametrize("scale", SCALES)
def test_pretest_passes_every_accepted_row(scale):
    """The kernel's slack 2^-18 passes every accepted row; with no slack
    some accepted rows fail the pre-test."""
    accepted = rejected = 0
    rng = np.random.default_rng(int(np.log2(scale)) + 100)
    for args in _pairs(scale, rng):
        exact, pre = _tests(*args, slack=2.0**-18)
        accepted += int(exact.sum())
        assert not bool((exact & ~pre).any())
        exact, pre = _tests(*args, slack=0.0)
        rejected += int((exact & ~pre).sum())
    assert accepted > 1000 and rejected > 0
