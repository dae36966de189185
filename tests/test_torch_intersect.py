"""The plain PyTorch versions of the intersection kernels agree with
core_tpu's Pallas kernels run in interpret mode (as tests/test_bvh.py runs
them): identical prim and occlusion bits, t/u/v within rtol 1e-6.

Inputs are the Cornell geometry and 2048 rays made with numpy from a seed,
with exclusion ids and dead, open and bounded caps.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from core_tpu import vec as jvec
from core_tpu.geometry import pallas_intersect as pk
from core_tpu.scenes import cornell_box
from core_tpu_torch import vec as tvec
from core_tpu_torch.geometry import cuda_intersect as ck
from core_tpu_torch.geometry import intersect as isect

torch.set_num_threads(1)
N = 2048


@pytest.fixture(scope="module")
def geom():
    g = cornell_box(resx=8, resy=8, light_samples=1, intersector="brute").geom
    tri = isect.pack_tris(torch.from_numpy(np.array(g.verts)),
                          torch.from_numpy(np.array(g.tri_vidx)))
    return g, tri


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _v3(a):
    return jvec.v3(jnp.asarray(a)), tvec.v3(torch.from_numpy(a))


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(a)


def test_pack_tris_matches(geom):
    g, tri = geom
    want, n = pk._pack_tris(g.verts, g.tri_vidx)
    np.testing.assert_array_equal(np.asarray(want)[:n], tri.numpy())


def test_closest_hit_matches_pallas(geom):
    g, tri = geom
    rng = np.random.default_rng(5)
    # half camera-like rays from outside the box, half interior rays from
    # above the blocks (tall block top: y=330).  A ray starting inside a
    # block can hit its bottom face and the floor under it, two coplanar
    # triangles at the same t: such a tie is decided by the last ulp, and
    # the interpret-mode reference contracts multiply-adds into FMAs, so
    # which of the two wins is not a property of the kernel.
    o = np.concatenate([
        np.array([278.0, 273.0, -500.0], np.float32)
        + rng.normal(0, 40, (N // 2, 3)).astype(np.float32),
        rng.uniform([10, 335, 10], [546, 538, 549], (N // 2, 3))
        .astype(np.float32)])
    tgt = rng.uniform(50, 500, (N, 3)).astype(np.float32)
    d = np.concatenate([tgt[:N // 2] - o[:N // 2], _unit(rng, N // 2)])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.uniform(size=N) < 0.5,
                    rng.uniform(10, 900, N), -1.0).astype(np.float32)
    tmin = np.full(N, 5e-5, np.float32)
    ex0 = rng.integers(-2, g.n_tris, N).astype(np.int32)
    ex1 = rng.integers(-2, g.n_tris, N).astype(np.int32)
    (jo, to), (jd, td) = _v3(o), _v3(d)
    (jtmin, ttmin), (jtmax, ttmax) = _pair(tmin), _pair(tmax)
    (jex0, tex0), (jex1, tex1) = _pair(ex0), _pair(ex1)
    want = pk.closest_hit_pallas_s(
        g, jvec.RaysS(o=jo, d=jd, tmin=jtmin, tmax=jtmax),
        exclude_prim=jex0, exclude_prim2=jex1, interpret=True)
    got = isect.closest_hit_torch(
        tri, tvec.RaysS(o=to, d=td, tmin=ttmin, tmax=ttmax),
        exclude_prim=tex0, exclude_prim2=tex1)
    np.testing.assert_array_equal(np.asarray(want.prim), got.prim.numpy())
    assert (got.prim.numpy() >= 0).mean() > 0.5
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6)
    # on CPU tensors the kernel wrapper takes the plain version
    via = ck.closest_hit_cuda(
        tri, tvec.RaysS(o=to, d=td, tmin=ttmin, tmax=ttmax),
        exclude_prim=tex0, exclude_prim2=tex1)
    assert torch.equal(via.prim, got.prim) and torch.equal(via.t, got.t)


@pytest.mark.parametrize("K", [2, 8])
def test_any_hit_nee_matches_pallas(geom, K):
    """Shared-origin bundle: light-bound (bounded), open, bounded random
    and dead (0 < tcap <= tmin) rays, with exclusions."""
    g, tri = geom
    rng = np.random.default_rng(11 + K)
    n = N // K
    # origins on the floor and inside the box
    o = np.concatenate([
        np.stack([rng.uniform(10, 540, n // 2), np.full(n // 2, 1.0),
                  rng.uniform(10, 540, n // 2)], 1),
        rng.uniform([10, 10, 10], [546, 538, 549], (n - n // 2, 3))]
    ).astype(np.float32)
    dirs, caps = [], []
    for k in range(K):
        kind = k % 4
        if kind == 0:     # toward the ceiling light, backed off its surface
            tgt = np.stack([rng.uniform(213, 343, n), np.full(n, 548.0),
                            rng.uniform(227, 332, n)], -1)
            dv = (tgt - o).astype(np.float32)
            t = np.linalg.norm(dv, axis=1).astype(np.float32)
            dirs.append((dv / t[:, None]).astype(np.float32))
            caps.append((t - 0.5).astype(np.float32))
        else:
            dirs.append(_unit(rng, n))
            caps.append({1: np.full(n, -1.0),
                         2: rng.uniform(5, 700, n),
                         3: np.full(n, 2.5e-4)}[kind].astype(np.float32))
    tmin = np.full(n, 5e-4, np.float32)
    ex0 = rng.integers(-2, g.n_tris, n).astype(np.int32)
    ex1 = rng.integers(-2, g.n_tris, n).astype(np.int32)
    jo, to = _v3(o)
    jd, td = zip(*[_v3(d) for d in dirs])
    jc, tc = zip(*[_pair(c) for c in caps])
    (jtmin, ttmin), (jex0, tex0), (jex1, tex1) = \
        _pair(tmin), _pair(ex0), _pair(ex1)
    want = np.asarray(pk.any_hit_nee_pallas_s(
        g, jo, jtmin, list(jd), list(jc), exclude_prim=jex0,
        exclude_prim2=jex1, interpret=True))
    got = isect.any_hit_nee_torch(tri, to, ttmin, list(td), list(tc),
                                  exclude_prim=tex0, exclude_prim2=tex1)
    assert got.dtype == torch.bool and got.shape == (K * n,)
    np.testing.assert_array_equal(want, got.numpy())
    bits = got.numpy().reshape(K, n)
    assert bits.any() and not bits.all()
    if K >= 4:
        assert not bits[3::4].any()          # dead rays never occlude
    via = ck.any_hit_nee_cuda(tri, to, ttmin, list(td), list(tc),
                              exclude_prim=tex0, exclude_prim2=tex1)
    assert torch.equal(via, got)


def test_plain_versions_chunk_like_one_pass(geom, monkeypatch):
    """Chunking the rays (bounded [n, T] intermediates) changes nothing."""
    _, tri = geom
    rng = np.random.default_rng(3)
    o = rng.uniform([10, 10, 10], [546, 538, 549], (300, 3)).astype(np.float32)
    rays = tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                      d=tvec.v3(torch.from_numpy(_unit(rng, 300))),
                      tmin=torch.full((300,), 5e-5),
                      tmax=torch.full((300,), -1.0))
    dirs = [tvec.v3(torch.from_numpy(_unit(rng, 300))) for _ in range(2)]
    caps = [torch.full((300,), 400.0), torch.full((300,), -1.0)]
    whole = isect.closest_hit_torch(tri, rays)
    whole_nee = isect.any_hit_nee_torch(tri, rays.o, rays.tmin, dirs, caps)
    monkeypatch.setattr(isect, "CHUNK_ELEMS", 7 * tri.shape[0])
    part = isect.closest_hit_torch(tri, rays)
    part_nee = isect.any_hit_nee_torch(tri, rays.o, rays.tmin, dirs, caps)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    assert torch.equal(whole_nee, part_nee)



def test_count_tests_replay_each_ray(geom):
    """count_tests of the brute occlusion plain versions: the tests each
    ray needs in index order, against a replay one triangle at a time.  A
    dead ray (0 < cap <= tmin) needs none; a live one is tested up to its
    first occluder (T if none); a NEE lane's origin terms up to the last
    of its live rays' stops."""
    _, tri = geom
    T = tri.shape[0]
    rng = np.random.default_rng(11)
    n, K = 96, 4
    o = torch.from_numpy(rng.uniform(20.0, 530.0, (n, 3)).astype(np.float32))
    dirs = [torch.from_numpy(_unit(rng, n)) for _ in range(K)]
    kind = rng.integers(0, 3, (K, n))
    caps = [torch.from_numpy(np.where(
        kind[k] == 0, -1.0, np.where(kind[k] == 1, 2.5e-4, 300.0))
        .astype(np.float32)) for k in range(K)]
    tmin = torch.full((n,), 5e-4)
    bits, lane_t, dir_t = isect.any_hit_nee_torch(
        tri, tvec.v3(o), tmin, [tvec.v3(d) for d in dirs], caps,
        count_tests=True)
    rays = [tvec.RaysS(o=tvec.v3(o), d=tvec.v3(d), tmin=tmin, tmax=c)
            for d, c in zip(dirs, caps)]
    stops = torch.zeros((K, n), dtype=torch.int64)
    for k in range(K):
        hit = torch.stack([isect.any_hit_torch(tri[j:j + 1], rays[k])
                           for j in range(T)])           # [T, n]
        first = torch.where(hit.any(0), hit.to(torch.uint8).argmax(0) + 1, T)
        stops[k] = torch.where(torch.from_numpy(kind[k] == 1), 0, first)
        any_bits, any_t = isect.any_hit_torch(tri, rays[k], count_tests=True)
        assert torch.equal(any_bits, bits[k * n:(k + 1) * n])
        assert torch.equal(any_t, stops[k])
    assert torch.equal(dir_t, stops.sum(0))
    assert torch.equal(lane_t, stops.max(0).values)
    assert 0 < int(stops.eq(0).sum()) and 0 < int(bits.sum()) < K * n
