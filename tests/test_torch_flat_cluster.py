"""The port's flat cluster sweep against core_tpu on the same numpy inputs:
the plain versions of kernels 4, 5 and 6 (closest hit, one-ray any hit,
the shared-origin NEE bundle) against core_tpu's entry points
(closest_hit_clusters_s, any_hit_clusters_s, any_hit_nee_clusters_s),
whose Pallas kernels run in interpret mode, as tests/test_cluster_intersect.py
runs them: identical prim and occlusion bits, t/u/v within rtol 1e-6.  And
the slice: a 16x16 directlight render of a flat mesh scene against the same
scene forced brute.

Geometry: the Cornell box split into clusters of <= 8 triangles (8 clusters,
as tests/test_cluster_intersect.py splits it), so the sweep crosses
clusters.  Rays: 2,048 made with numpy from a seed, with two exclusion ids,
open, bounded and dead (0 < tcap <= tmin) caps.  The closest-hit rays avoid
last-ulp ties as tests/test_torch_intersect.py's do: interpret mode
contracts multiply-adds into FMAs, so which of two coplanar triangles at the
same t wins (a block's bottom face on the floor) is not a property of the
kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from core_tpu import vec as jvec
from core_tpu.geometry import cluster_intersect as jck
from core_tpu.scenes import cornell_box
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import vec as tvec
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry import cuda_cluster
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.render import RenderOptions, render_chunk, \
    scene_material_types
from core_tpu_torch.scenes import mesh_scene

torch.set_num_threads(1)
N = 2048


@pytest.fixture(scope="module")
def accels():
    g = cornell_box(resx=8, resy=8, light_samples=1, intersector="brute").geom
    verts, vidx = np.asarray(g.verts), np.asarray(g.tri_vidx)
    jcl = jck.build_clusters(verts, vidx, max_leaf=8)
    acc = ci.to_device(ci.build_clusters(verts, vidx, max_leaf=8), "cpu")
    return jcl, acc, int(vidx.shape[0])


def test_flat_accel_crosses_through_convert(accels):
    """A core_tpu scene with a flat ClusterData accel becomes a port scene
    with the same ClusterAccel, and converts back to the same leaves."""
    jcl, acc, _ = accels
    js = dataclasses.replace(cornell_box(resx=8, resy=8, light_samples=1,
                                         intersector="brute"), accel=jcl)
    leaves, static = convert.scene_to_numpy(js)
    assert static["accel"] == "flat"
    back = convert.scene_from_numpy(leaves, static, device="cpu")
    for f in ci.ClusterAccel._fields:
        assert torch.equal(getattr(back.accel, f), getattr(acc, f)), f
    again, _ = convert.scene_to_numpy(back)
    for f in ci.ClusterData._fields:
        np.testing.assert_array_equal(again[f"accel.{f}"],
                                      leaves[f"accel.{f}"])


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _rays(o, d, tmin, tmax):
    """The same rays as core_tpu's and the port's RaysS."""
    j = jvec.RaysS(o=jvec.v3(jnp.asarray(o)), d=jvec.v3(jnp.asarray(d)),
                   tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax))
    t = tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                   d=tvec.v3(torch.from_numpy(d)),
                   tmin=torch.from_numpy(tmin), tmax=torch.from_numpy(tmax))
    return j, t


def test_accel_equals_core_tpu(accels):
    jcl, acc, n_tris = accels
    assert jcl.grouped is None and jcl.n_clusters == acc.aabb.shape[0] == 8
    np.testing.assert_array_equal(acc.aabb.numpy(), np.asarray(jcl.aabb))
    tris = np.asarray(jcl.tris)
    np.testing.assert_array_equal(acc.tris.numpy(), tris[..., :9])
    np.testing.assert_array_equal(acc.tri_id.numpy(), tris[..., 9])
    assert int(acc.count.sum()) == n_tris


def test_closest_hit_matches_core_tpu(accels):
    jcl, acc, n_tris = accels
    rng = np.random.default_rng(5)
    # camera-like rays from outside the box, and interior rays from above
    # the blocks (tall block top: y=330)
    o = np.concatenate([
        np.array([278.0, 273.0, -500.0], np.float32)
        + rng.normal(0, 40, (N // 2, 3)).astype(np.float32),
        rng.uniform([10, 335, 10], [546, 538, 549], (N // 2, 3))
        .astype(np.float32)])
    tgt = rng.uniform(50, 500, (N, 3)).astype(np.float32)
    d = np.concatenate([tgt[:N // 2] - o[:N // 2], _unit(rng, N // 2)])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    kind = rng.uniform(size=N)
    tmax = np.where(kind < 0.4, rng.uniform(10, 900, N),
                    np.where(kind < 0.9, -1.0, 2.5e-5)).astype(np.float32)
    tmin = np.full(N, 5e-5, np.float32)
    ex0 = rng.integers(-2, n_tris, N).astype(np.int32)
    ex1 = rng.integers(-2, n_tris, N).astype(np.int32)
    jr, tr = _rays(o, d, tmin, tmax)
    (jex0, tex0), (jex1, tex1) = _pair(ex0), _pair(ex1)
    want = jck.closest_hit_clusters_s(jcl, jr, exclude_prim=jex0,
                                      exclude_prim2=jex1, interpret=True)
    got, tests, slabs = ci.closest_hit_flat_torch(acc, tr, tex0, tex1,
                                                  count_tests=True)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    for f in "tuv":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    hit = got.prim.numpy() >= 0
    assert 0.4 < hit.mean() < 0.9
    dead = tmax == np.float32(2.5e-5)
    assert not hit[dead].any() and (tests.numpy()[dead] == 0).all()
    # the best-t gate culls: a hit ray tests fewer than all triangles
    assert (tests.numpy()[hit] > 0).all()
    assert tests.numpy()[hit].mean() < n_tris
    # the flat walk slab-tests every cluster box of a live ray
    assert (slabs.numpy() == np.where(dead, 0, 8)).all()
    # on CPU tensors the kernel's wrapper is its plain version
    calls = ci.closest_hit_flat_torch.calls
    via = cuda_cluster.closest_hit_flat_cuda(acc, tr, tex0, tex1)
    assert ci.closest_hit_flat_torch.calls == calls + 1
    assert all(torch.equal(a, b) for a, b in zip(via, got))


def test_any_hit_matches_core_tpu(accels):
    jcl, acc, n_tris = accels
    rng = np.random.default_rng(7)
    o = rng.uniform([10, 10, 10], [546, 538, 549], (N, 3)).astype(np.float32)
    d = _unit(rng, N)
    tmax = rng.choice(np.array([-1.0, 2.5e-4, 60.0, 250.0], np.float32), N)
    tmin = np.full(N, 5e-4, np.float32)
    ex0 = rng.integers(-2, n_tris, N).astype(np.int32)
    ex1 = rng.integers(-2, n_tris, N).astype(np.int32)
    jr, tr = _rays(o, d, tmin, tmax)
    (jex0, tex0), (jex1, tex1) = _pair(ex0), _pair(ex1)
    want = np.asarray(jck.any_hit_clusters_s(
        jcl, jr, exclude_prim=jex0, exclude_prim2=jex1, interpret=True))
    got, tests, slabs = ci.any_hit_flat_torch(acc, tr, tex0, tex1,
                                              count_tests=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.8
    dead = tmax == np.float32(2.5e-4)
    assert not want[dead].any() and (tests.numpy()[dead] == 0).all()
    # an occluded ray stops at its first occluder
    assert (tests.numpy()[want] > 0).all()
    # ... and slab-tests the boxes up to that cluster's
    s = slabs.numpy()
    assert (s[dead] == 0).all() and (s[~want & ~dead] == 8).all()
    assert (s[want] >= 1).all() and (s[want] <= 8).all()
    assert torch.equal(cuda_cluster.any_hit_flat_cuda(acc, tr, tex0, tex1),
                       got)


@pytest.mark.parametrize("K", [2, 8])
def test_nee_bundle_matches_core_tpu(accels, K):
    """Shared-origin bundle: light-bound (bounded), open, bounded random
    and dead rays, with exclusions, straight to kernel 6 (no
    re-bucketing on the flat path)."""
    jcl, acc, n_tris = accels
    rng = np.random.default_rng(11 + K)
    n = N // K
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
    ex0 = rng.integers(-2, n_tris, n).astype(np.int32)
    ex1 = rng.integers(-2, n_tris, n).astype(np.int32)
    (jtmin, ttmin), (jex0, tex0), (jex1, tex1) = \
        _pair(tmin), _pair(ex0), _pair(ex1)
    want = np.asarray(jck.any_hit_nee_clusters_s(
        jcl, jvec.v3(jnp.asarray(o)), jtmin,
        [jvec.v3(jnp.asarray(d)) for d in dirs],
        [jnp.asarray(c) for c in caps], exclude_prim=jex0,
        exclude_prim2=jex1, interpret=True))
    to = tvec.v3(torch.from_numpy(o))
    td = [tvec.v3(torch.from_numpy(d)) for d in dirs]
    tc = [torch.from_numpy(c) for c in caps]
    got, lane_tests, dir_tests, slabs = ci.any_hit_nee_flat_torch(
        acc, to, ttmin, td, tc, tex0, tex1, count_tests=True)
    assert got.dtype == torch.bool and got.shape == (K * n,)
    np.testing.assert_array_equal(got.numpy(), want)
    bits = want.reshape(K, n)
    assert bits.any() and not bits.all()
    if K >= 4:
        assert not bits[3::4].any()          # dead rays never occlude
    # a lane's triangles get their origin terms once for all directions
    lt, dt = lane_tests.numpy(), dir_tests.numpy()
    assert (lt <= dt).all() and (dt <= K * lt).all() and lt.max() <= n_tris
    # each live direction slab-tests the boxes up to its first occluder's
    live = sum((c <= 0) | (c > tmin) for c in caps)
    assert (slabs.numpy() <= 8 * live).all() and (slabs.numpy() > 0).all()
    assert torch.equal(cuda_cluster.any_hit_nee_flat_cuda(
        acc, to, ttmin, td, tc, tex0, tex1), got)


def test_flat_render_equals_brute():
    """The slice in the port alone: a 16x16 directlight chunk of a flat
    mesh scene (4,274 triangles, 32 clusters) against the same scene forced
    brute.  Flat and brute orders can break exact-t ties between coplanar
    triangles differently, so the image is held at the mesh test's
    tolerance: >= 99% of pixel channels within rtol 1e-4 / atol 1e-5 and
    the mean within 1e-5 relative."""
    sc = mesh_scene(resx=16, resy=16, n_grid=44, torus_u=24, torus_v=12,
                    ibl_samples=2, sun_samples=1, device="cpu")
    assert isinstance(sc.accel, ci.ClusterAccel) and sc.geom.n_tris == 4274
    opts = RenderOptions(aa_samples=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))
    imgs = []
    cuda_cluster.reset_counts()
    for scene in (sc, dataclasses.replace(sc, accel=None)):
        with torch.no_grad():
            f = render_chunk(scene, scene_material_types(scene), opts,
                             tfilm.make_film(16, 16, device="cpu"), 0, 1, 0)
        imgs.append(tfilm.normalized(f).numpy())
    # the flat scene went through the plain versions of kernels 4 and 6
    assert ci.closest_hit_flat_torch.calls == 2      # camera + glossy chain
    assert ci.any_hit_nee_flat_torch.calls == 4      # IBL + sun, twice
    flat, brute = imgs
    assert np.isfinite(flat).all()
    close = np.abs(flat - brute) <= 1e-5 + 1e-4 * np.abs(brute)
    assert close[..., :3].mean() >= 0.99, close[..., :3].mean()
    bm, fm = brute[..., :3].mean(), flat[..., :3].mean()
    assert abs(fm - bm) <= 1e-5 * abs(bm), (fm, bm)
    assert bm > 0.05 and brute[:4, :, 2].mean() > 0.05
