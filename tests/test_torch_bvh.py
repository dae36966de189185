"""The BVH: core_tpu_torch/geometry/bvh.py and its native builder
(core_tpu_torch/native.py) against core_tpu's geometry/bvh.py and
native/.

The numpy builds agree array for array on the Cornell box, and the native
builds on a 30,000-triangle soup (a permutation whose leaves cover every
triangle once and whose parents contain their children, as
tests/test_bvh.py checks core_tpu's); closest and any hits of 512 random
rays equal core_tpu's traversal (the same prims, t within rel 1e-4); a
16x16 directlight render through the BVH equals the port's brute render
with at most 0.5% of hit lanes off on coplanar ties; convert.py carries
the accel across.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from core_tpu import native as j_native
from core_tpu.geometry import bvh as j_bvh
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert, native, vec
from core_tpu_torch import scene as scene_mod
from core_tpu_torch.geometry import bvh
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.render import RenderOptions, render_image

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell():
    js = j_cornell_box(resx=16, resy=16, light_samples=2,
                       intersector="brute")
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


def _soup(T=30000, seed=1):
    """tests/test_bvh.py's random triangle soup."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 100, (T, 3)).astype(np.float32)
    verts = np.concatenate([base, base + rng.uniform(0.1, 1.0, (T, 3)),
                            base + rng.uniform(0.1, 1.0, (T, 3))], axis=0)
    tris = np.stack([np.arange(T), np.arange(T) + T, np.arange(T) + 2 * T],
                    axis=1).astype(np.int32)
    return verts.astype(np.float32), tris


def _assert_same(got: bvh.BVHData, want):
    for name, a, b in zip(bvh.BVHData._fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_numpy_build_equals_core_tpu(cornell):
    js, ts = cornell
    g = js.geom
    want = j_bvh.build_bvh(np.asarray(g.verts), np.asarray(g.tri_vidx))
    got = bvh.build_bvh(ts.geom.verts.numpy(), ts.geom.tri_vidx.numpy(),
                        device="cpu")
    _assert_same(got, want)
    # convert.py carries a BVH accel of either package across
    for acc in (got, want):
        sc = convert.scene_from_numpy(*convert.scene_to_numpy(
            dataclasses.replace(js, accel=acc)), device="cpu")
        assert scene_mod.accel_kind(sc.accel) == "bvh"
        _assert_same(sc.accel, want)


def test_native_build_equals_core_tpu_native():
    verts, tris = _soup()
    got = native.build_bvh_native(verts, tris)
    nmin, nmax, left, count, order = got
    T = tris.shape[0]
    assert sorted(order.tolist()) == list(range(T))
    leaves = left < 0
    assert count[leaves].sum() == T
    inner = ~leaves
    for child in (left[inner], left[inner] + 1):
        assert (nmin[inner] <= nmin[child] + 1e-4).all()
        assert (nmax[inner] >= nmax[child] - 1e-4).all()
    if not j_native.available():
        pytest.fail("core_tpu's native builder does not build here")
    _assert_same(bvh.to_device(got, "cpu"),
                 j_native.build_bvh_native(verts, tris))
    # build_bvh takes the native builder at NATIVE_THRESHOLD triangles
    assert T >= bvh.NATIVE_THRESHOLD
    _assert_same(bvh.build_bvh(verts, tris, device="cpu"),
                 bvh.to_device(got, "cpu"))


def test_closest_and_any_hit_equal_core_tpu(cornell):
    js, ts = cornell
    rng = np.random.default_rng(0)
    n = 512
    o = rng.uniform(50, 500, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, -1.0,
                    rng.uniform(10, 600, n)).astype(np.float32)
    ex = rng.integers(-1, 36, n).astype(np.int32)
    jb = j_bvh.build_bvh(np.asarray(js.geom.verts),
                         np.asarray(js.geom.tri_vidx))
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d), tmin=jnp.full(n, 1e-4),
               tmax=jnp.asarray(tmax))
    jh = j_bvh.closest_hit_bvh(js.geom, jb, jr,
                               exclude_prim=jnp.asarray(ex))
    ja = j_bvh.any_hit_bvh(js.geom, jb, jr, exclude_prim=jnp.asarray(ex),
                           exclude_prim2=jnp.asarray(ex[::-1].copy()))
    tb = bvh.to_device(jb, "cpu")
    rs = vec.RaysS(o=vec.v3(torch.tensor(o)), d=vec.v3(torch.tensor(d)),
                   tmin=torch.full((n,), 1e-4), tmax=torch.tensor(tmax))
    tex = torch.tensor(ex)
    th = bvh.closest_hit_bvh(ts.tri, tb, rs, exclude_prim=tex)
    ta = bvh.any_hit_bvh(ts.tri, tb, rs, exclude_prim=tex,
                         exclude_prim2=tex.flip(0))
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    hit = th.prim.numpy() >= 0
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-4)
    np.testing.assert_allclose(th.u.numpy()[hit], np.asarray(jh.u)[hit],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # the NEE bundle is the concatenated wavefront
    K = 3
    dirs = [vec.v3(torch.tensor(np.roll(d, k, axis=0))) for k in range(K)]
    caps = [torch.tensor(np.roll(tmax, k)) for k in range(K)]
    bundle = bvh.any_hit_nee_bvh(ts.tri, tb, rs.o, rs.tmin, dirs, caps, tex)
    flat = isect.any_hit_torch(ts.tri, vec.RaysS(
        o=vec.V3(*[c.repeat(K) for c in rs.o]),
        d=vec.V3(*[torch.cat([getattr(v, f) for v in dirs])
                   for f in "xyz"]),
        tmin=rs.tmin.repeat(K), tmax=torch.cat(caps)), tex.repeat(K))
    assert (bundle == flat).float().mean() > 0.995


def test_bvh_render_equals_brute(cornell):
    """A 16x16 directlight render (raydepth 1) with the BVH as the scene's
    accel against the brute render: the scene routes all three queries to
    the traversal, the camera hits agree on >= 99.5% of hit lanes, and the
    images agree."""
    _, ts = cornell
    tsb = bvh.with_bvh_accel(ts)
    assert scene_mod.accel_kind(tsb.accel) == "bvh"
    from core_tpu_torch.render import _pixel_grid_raster
    from core_tpu_torch.cameras import shoot_ray
    x, y, _ = _pixel_grid_raster(16, 16, 1, "cpu")
    rays, _ = shoot_ray(ts.camera, x.float() + 0.5, y.float() + 0.5)
    rs = vec.rays_to_soa(rays)
    hb = scene_mod.closest_hit_s(tsb, rs)
    hr = scene_mod.closest_hit_s(ts, rs)
    hit = (hb.prim >= 0) | (hr.prim >= 0)
    assert float((hb.prim != hr.prim)[hit].float().mean()) <= 0.005
    opts = RenderOptions(integrator_opts=DirectOptions(raydepth=1))
    img_b = render_image(tsb, opts)[0]
    img = render_image(ts, opts)[0]
    diff = (img_b - img).abs()
    assert float((diff > 1e-4).float().mean()) <= 0.005
    assert float(diff.mean()) < 1e-3
