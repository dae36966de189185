"""The port's grouped-cluster path against core_tpu on the same numpy inputs:
the host build (build_clusters, group_clusters) exactly, the choice of
path by cluster count, the NEE bucket key exactly, and the plain versions
of kernels 7 and 8 (closest hit, any hit, the re-bucketed NEE bundle)
against core_tpu's jnp brute-force intersector (geometry/intersect.py):
identical prim and occlusion bits, t/u/v within rtol 1e-6.

Geometry: the port's small mesh_scene (n_grid=24, torus 24x12, 1,634
triangles; its leaves equal core_tpu's, see test_torch_mesh_scene.py),
grouped as tests/test_grouped_cluster.py forces it (group=8).  The plain
versions also run with 32-triangle clusters, which gives 8 groups of 8, so
the walk crosses groups and octets.  Rays: 2,048 made with numpy from a
seed.  core_tpu's grouped Pallas kernels are not run here: its own tests
hold them to the brute force (tests/test_grouped_cluster.py), and interpret
mode costs minutes.  The brute force runs under jax.disable_jit, op by op:
compiled, its scan body lets XLA:CPU contract multiply-adds into FMAs,
which moves a small barycentric u or v by a few 1e-6 (5 of 2,048 lanes
here), while the port rounds every product as its kernels do.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from core_tpu.types import Rays
from core_tpu.geometry import cluster_intersect as jck
from core_tpu.geometry import intersect as jisect
from core_tpu_torch import vec as tvec
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry import cuda_cluster
from core_tpu_torch.scenes import mesh_scene

torch.set_num_threads(1)
N = 2048


@pytest.fixture(scope="module")
def geo():
    sc = mesh_scene(resx=8, resy=8, n_grid=24, torus_u=24, torus_v=12,
                    ibl_samples=2, sun_samples=1, device="cpu")
    return (sc.geom.verts.numpy(), sc.geom.tri_vidx.numpy(),
            sc.camera.pos.numpy(), sc.geom)


def _accel(geo, max_leaf):
    verts, vidx, cam, _ = geo
    cl = ci.build_clusters(verts, vidx, max_leaf=max_leaf)
    return ci.to_device(ci.group_clusters(cl, group=8, sort_origin=cam),
                        "cpu")


@pytest.mark.parametrize("max_leaf", [None, 32])
def test_build_and_group_equal_core_tpu(geo, max_leaf):
    verts, vidx, cam, _ = geo
    jc = jck.build_clusters(verts, vidx, max_leaf=max_leaf)
    tc = ci.build_clusters(verts, vidx, max_leaf=max_leaf)
    assert jc.grouped is None               # below the auto-group size
    np.testing.assert_array_equal(np.asarray(jc.aabb), tc.aabb)
    np.testing.assert_array_equal(np.asarray(jc.tris), tc.tris)
    jg = jck.group_clusters(jc, group=8, sort_origin=cam)
    tg = ci.group_clusters(tc, group=8, sort_origin=cam)
    for f in ("g_aabb", "c_aabb", "o_aabb"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f), err_msg=f)
    # core_tpu keeps the triangle block field-major [C, 16, L] for the TPU
    np.testing.assert_array_equal(
        np.swapaxes(np.asarray(jg.tris), 1, 2)[:, :, :10], tg.tris)
    acc = ci.to_device(tg, "cpu")
    assert int(acc.count.sum()) == vidx.shape[0]
    assert acc.g_aabb.shape[0] == (1 if max_leaf is None else 8)


def _rays(seed, n=N):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, n), rng.uniform(0.2, 3.0, n),
                  rng.uniform(-3, 3, n)], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jgeom(geo):
    """The geometry fields core_tpu's brute-force intersector reads."""
    return SimpleNamespace(verts=jnp.asarray(geo[0]),
                           tri_vidx=jnp.asarray(geo[1]))


def _brute(fn, *args, **kw):
    """core_tpu's brute force, run op by op (see the module docstring)."""
    with jax.disable_jit():
        return fn(*args, **kw)


def test_nee_bucket_key_equals_core_tpu(geo):
    acc = _accel(geo, 32)
    o, d = _rays(3)
    rng = np.random.default_rng(4)
    tmin = np.full(N, 5e-4, np.float32)
    tcap = rng.choice(np.array([-1.0, 2.5e-4, 3.0, 50.0], np.float32), N)
    o[:64] *= 40.0                       # origins outside the scene bounds
    args = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tcap, tmin]
    want = jck._nee_bucket_key(*[jnp.asarray(a) for a in args],
                               jnp.asarray(acc.g_aabb.numpy()))
    got = ci._nee_bucket_key(*[torch.from_numpy(a) for a in args],
                             acc.g_aabb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 1 << 24).sum() == (tcap == np.float32(2.5e-4)).sum()


def _rays_s(o, d, tmin, tmax):
    return tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                      d=tvec.v3(torch.from_numpy(d)),
                      tmin=torch.from_numpy(tmin), tmax=torch.from_numpy(tmax))


@pytest.mark.parametrize("max_leaf", [None, 32])
def test_plain_grouped_closest_hit_matches_brute(geo, max_leaf):
    acc = _accel(geo, max_leaf)
    jg = _jgeom(geo)
    o, d = _rays(1)
    rng = np.random.default_rng(2)
    tmin = np.full(N, 5e-4, np.float32)
    tmax = np.where(rng.uniform(size=N) < 0.5, -1.0,
                    rng.uniform(0.5, 6.0, N)).astype(np.float32)
    ex = rng.integers(-2, geo[1].shape[0], N).astype(np.int32)
    want = _brute(
        jisect.closest_hit_brute, jg,
        Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
             jnp.asarray(tmax)), exclude_prim=jnp.asarray(ex))
    calls = ci.closest_hit_grouped_torch.calls
    # the kernel's CPU branch is its plain version
    got, tests, slabs = ci.closest_hit_grouped_torch(
        acc, _rays_s(o, d, tmin, tmax), torch.from_numpy(ex),
        count_tests=True)
    again = cuda_cluster.closest_hit_grouped_cuda(
        acc, _rays_s(o, d, tmin, tmax), torch.from_numpy(ex))
    assert ci.closest_hit_grouped_torch.calls == calls + 2
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    for f in "tuv":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
        assert torch.equal(getattr(got, f), getattr(again, f))
    hit = got.prim.numpy() >= 0
    assert 0.3 < hit.mean() < 0.95
    # the walk culls: a hit ray tests far fewer triangles than the scene has
    assert (tests.numpy()[hit] > 0).all()
    assert tests.numpy().mean() < 0.5 * geo[1].shape[0]
    # every group box, and more under the groups a hit ray enters
    G = acc.g_aabb.shape[0]
    assert (slabs.numpy() >= G).all() and (slabs.numpy()[hit] > G).all()


def test_plain_grouped_closest_slab_count_matches_a_walk(geo):
    """The slab tests that the plain grouped closest hit counts equal those
    of a walk of each ray on its own, in visit order: every group box, the
    octet boxes of each group whose gate passes with min(tcap, best t on
    entering it), and the cluster boxes of each octet that passes on
    entering it, also when none of its clusters then passes.  The walk's
    hits equal the plain version's too."""
    acc = _accel(geo, 32)
    n = 128
    o, d = _rays(13, n)
    rng = np.random.default_rng(14)
    tmin = np.full(n, 5e-4, np.float32)
    tmax = rng.choice(np.array([-1.0, 2.5e-4, 1.0, 4.0], np.float32), n)
    rays = _rays_s(o, d, tmin, tmax)
    hits, _, slabs = ci.closest_hit_grouped_torch(acc, rays, count_tests=True)
    r = ci._ray_fields(rays, None, None, ci._cap(rays.tmax))
    G, n_oct = acc.o_aabb.shape[:2]
    o_box, c_box = acc.o_aabb.reshape(-1, 8), acc.c_aabb.reshape(-1, 8)
    # each (ray, cluster) pair's closest accepted triangle, best t aside
    C = c_box.shape[0]
    ray_of = torch.arange(n).repeat_interleave(C)
    pt, pp = ci._mt_closest(acc, r, ray_of, torch.arange(C).repeat(n))[:2]
    pt, pp = pt.view(n, C), pp.view(n, C)
    want, prims, boxes_without_tests = [], [], 0
    for i in range(n):
        ri = {k: v[i] for k, v in r.items()}
        if ri["tcap"] <= ri["tmin"]:
            want.append(0)
            prims.append(-1)
            continue
        bt, prim, count = torch.tensor(ci.BIG), -1, G

        def gate(box):
            return bool(ci._slab(box, ri, torch.minimum(ri["tcap"], bt)))
        for g in range(G):
            if not gate(acc.g_aabb[g]):
                continue
            count += n_oct
            for oc in range(g * n_oct, (g + 1) * n_oct):
                if not gate(o_box[oc]):
                    continue
                count += ci.OCTET
                tested = False
                for c in range(oc * ci.OCTET, (oc + 1) * ci.OCTET):
                    if gate(c_box[c]):
                        tested = True
                        if pt[i, c] < bt:
                            bt, prim = pt[i, c], int(pp[i, c])
                boxes_without_tests += not tested
        want.append(count)
        prims.append(prim)
    assert slabs.tolist() == want
    assert hits.prim.tolist() == prims
    assert boxes_without_tests > 0


@pytest.mark.parametrize("max_leaf", [None, 32])
def test_plain_grouped_any_hit_matches_brute(geo, max_leaf):
    acc = _accel(geo, max_leaf)
    jg = _jgeom(geo)
    o, d = _rays(5)
    rng = np.random.default_rng(6)
    tmin = np.full(N, 5e-4, np.float32)
    tmax = rng.choice(np.array([-1.0, 2.5e-4, 1.0, 4.0], np.float32), N)
    ex0 = rng.integers(-2, geo[1].shape[0], N).astype(np.int32)
    ex1 = rng.integers(-2, geo[1].shape[0], N).astype(np.int32)
    want = np.asarray(_brute(
        jisect.any_hit_brute, jg,
        Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
             jnp.asarray(tmax)), exclude_prim=jnp.asarray(ex0),
        exclude_prim2=jnp.asarray(ex1)))
    got, tests, slabs = ci.any_hit_grouped_torch(
        acc, _rays_s(o, d, tmin, tmax), torch.from_numpy(ex0),
        torch.from_numpy(ex1), count_tests=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9
    dead = tmax == np.float32(2.5e-4)
    assert not got.numpy()[dead].any() and (tests.numpy()[dead] == 0).all()
    # a dead ray needs no gate; an open one that misses tests every group
    assert (slabs.numpy()[dead] == 0).all()
    miss = (tmax == -1.0) & ~want
    assert (slabs.numpy()[miss] >= acc.g_aabb.shape[0]).all()


def test_plain_rebucketed_nee_bundle_matches_brute(geo):
    """K=3 shadow rays per lane from shared origins, with open, bounded and
    dead caps, re-bucketed, swept and scattered back: the bits equal the
    brute force on the concatenated rays, in the [K*n] K-major layout."""
    acc = _accel(geo, 32)
    jg = _jgeom(geo)
    n = N // 2
    o, _ = _rays(7, n)
    rng = np.random.default_rng(8)
    dirs, caps = [], []
    for cap in (-1.0, 3.0, 2.5e-4):
        dirs.append(_rays(9 + len(dirs), n)[1])
        caps.append(np.full(n, cap, np.float32))
    tmin = np.full(n, 5e-4, np.float32)
    ex = rng.integers(-2, geo[1].shape[0], n).astype(np.int32)
    K = len(dirs)
    want = np.asarray(_brute(
        jisect.any_hit_brute, jg, Rays(jnp.asarray(np.tile(o, (K, 1))),
                 jnp.asarray(np.concatenate(dirs)),
                 jnp.asarray(np.tile(tmin, K)),
                 jnp.asarray(np.concatenate(caps))),
        exclude_prim=jnp.asarray(np.tile(ex, K))))
    got = ci.any_hit_nee_clusters_s(
        acc, tvec.v3(torch.from_numpy(o)), torch.from_numpy(tmin),
        [tvec.v3(torch.from_numpy(d)) for d in dirs],
        [torch.from_numpy(c) for c in caps], torch.from_numpy(ex), None,
        ci.any_hit_grouped_torch)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want[:2 * n].mean() < 0.95 and not want[2 * n:].any()


@pytest.mark.parametrize("n_tris", [4_097, 131_583, 131_584])
def test_accel_path_follows_core_tpu(n_tris):
    """Above 4,096 triangles core_tpu takes the grouped path when the
    median split gives >= 1,024 clusters (of <= 256 triangles below
    262,144), else the flat sweep: 4,097 triangles give 17 clusters and
    131,583 give 1,023 (flat, kernels 4-6), 131,584 give 1,024 (grouped).
    The port decides the same way, with the same boxes and triangles."""
    from core_tpu_torch.environment import accel_for
    rng = np.random.default_rng(n_tris)
    centers = rng.uniform(-5.0, 5.0, (n_tris, 1, 3))
    verts = (centers + rng.normal(scale=0.05, size=(n_tris, 3, 3))) \
        .reshape(-1, 3).astype(np.float32)
    vidx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    cam = np.array([5.0, 3.0, -5.0], np.float32)
    jc = jck.build_clusters(verts, vidx, sort_origin=cam)
    acc = accel_for(verts, vidx, cam, "cpu")
    if jc.grouped is None:
        assert jc.aabb.shape[0] == {4_097: 17, 131_583: 1023}[n_tris]
        assert isinstance(acc, ci.ClusterAccel) and acc.leaf == 256
        np.testing.assert_array_equal(acc.aabb.numpy(), np.asarray(jc.aabb))
        tris = np.asarray(jc.tris)
        np.testing.assert_array_equal(acc.tris.numpy(), tris[..., :9])
        np.testing.assert_array_equal(acc.tri_id.numpy(), tris[..., 9])
        assert int(acc.count.sum()) == n_tris
        return
    assert isinstance(acc, ci.GroupedAccel)
    assert acc.g_aabb.shape[0] == 16 and acc.leaf == 256
    for f in ("g_aabb", "c_aabb", "o_aabb"):
        np.testing.assert_array_equal(getattr(acc, f).numpy(),
                                      np.asarray(getattr(jc.grouped, f)))


def test_scene_any_hit_routes_by_accel(geo):
    """scene.any_hit_s answers through kernel 3's path on the brute scene
    and through kernel 8's on a grouped one, and both agree."""
    import dataclasses
    from core_tpu_torch import scene as tscene
    from core_tpu_torch.geometry import intersect as isect
    sc = mesh_scene(resx=8, resy=8, n_grid=24, torus_u=24, torus_v=12,
                    ibl_samples=2, sun_samples=1, device="cpu")
    o, d = _rays(11, 256)
    tmin = np.full(256, 5e-4, np.float32)
    tmax = np.full(256, 4.0, np.float32)
    rays = _rays_s(o, d, tmin, tmax)
    calls = isect.any_hit_torch.calls
    brute = tscene.any_hit_s(sc, rays)
    assert isect.any_hit_torch.calls == calls + 1
    assert torch.equal(brute, isect.any_hit_torch(sc.tri, rays))
    acc = _accel(geo, 32)
    got = tscene.any_hit_s(dataclasses.replace(sc, accel=acc), rays)
    assert torch.equal(got, ci.any_hit_grouped_torch(acc, rays))
    assert torch.equal(got, brute) and 0.05 < float(got.float().mean()) < 0.95
