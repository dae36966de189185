"""The CUDA intersection kernels against their plain PyTorch versions on
the card (the small-size twin of chip_smoke.py's kernel phases): kernels
1-3 on the Cornell box, the flat cluster kernels 4-6 on a 4,274-triangle
mesh scene, the grouped kernels 7-8 on a forced-grouped small mesh scene,
and renders through the kernels against renders through the plain
versions.

Marked `cuda`: each test asks its fixture for a CUDA device and skips
without one.  Run on a GPU host with
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""
import pytest
import torch

from core_tpu_torch import vec
from core_tpu_torch.geometry import cuda_intersect as ck
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import RenderOptions, render_image
from core_tpu_torch.scenes import cornell_box

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _unit(v):
    return v / v.norm(dim=-1, keepdim=True)


def _inputs(device, n, seed=0):
    scene = cornell_box(resx=16, resy=16, light_samples=1, device=device)
    tri = scene.tri
    g = torch.Generator(device=device).manual_seed(seed)
    o = torch.tensor([10.0, 10.0, 10.0], device=device) + torch.rand(
        (n, 3), generator=g, device=device) * torch.tensor(
        [536.0, 528.0, 539.0], device=device)
    d = _unit(torch.randn((n, 3), generator=g, device=device))
    tmax = torch.where(torch.rand(n, generator=g, device=device) < 0.5,
                       torch.rand(n, generator=g, device=device) * 800,
                       torch.full((n,), -1.0, device=device))
    ex = torch.randint(-2, scene.geom.n_tris, (n,), generator=g,
                       device=device, dtype=torch.int32)
    rays = vec.RaysS(o=vec.v3(o), d=vec.v3(d),
                     tmin=torch.full((n,), 5e-5, device=device), tmax=tmax)
    return scene, tri, rays, ex, g


@pytest.mark.parametrize("n", [1, 1000, 70_000])
def test_closest_hit_kernel_matches_plain(device, n):
    _, tri, rays, ex, _ = _inputs(device, n)
    launches = ck.closest_hit_cuda.launches
    got = ck.closest_hit_cuda(tri, rays, exclude_prim=ex)
    want = isect.closest_hit_torch(tri, rays, exclude_prim=ex)
    torch.cuda.synchronize()
    assert ck.closest_hit_cuda.launches == launches + 1
    assert torch.equal(got.prim, want.prim)
    for f in ("t", "u", "v"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", ck.NEE_K)
def test_any_hit_nee_kernel_matches_plain(device, K):
    n = 4000
    _, tri, rays, ex, g = _inputs(device, n, seed=K)
    dirs = [vec.v3(_unit(torch.randn((n, 3), generator=g, device=device)))
            for _ in range(K)]
    caps = [torch.where(torch.rand(n, generator=g, device=device) < 0.3,
                        torch.full((n,), -1.0, device=device),
                        torch.rand(n, generator=g, device=device) * 600)
            for _ in range(K)]
    caps[-1] = torch.full((n,), 2.5e-4, device=device)      # dead rays
    tmin = torch.full((n,), 5e-4, device=device)
    got = ck.any_hit_nee_cuda(tri, rays.o, tmin, dirs, caps, ex, ex.flip(0))
    want = isect.any_hit_nee_torch(tri, rays.o, tmin, dirs, caps, ex,
                                   ex.flip(0))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got[(K - 1) * n:].any())


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    _, tri, rays, ex, _ = _inputs(device, 64)
    with pytest.raises(ValueError):
        ck.closest_hit_cuda(tri, rays, exclude_prim=ex.long())
    bad = rays._replace(tmin=rays.tmin.double())
    with pytest.raises(ValueError):
        ck.closest_hit_cuda(tri, bad)
    with pytest.raises(ValueError):
        ck.any_hit_nee_cuda(tri, rays.o, rays.tmin, [rays.d] * 3,
                            [rays.tmax] * 3)


def test_render_through_kernels_equals_plain(device):
    opts = RenderOptions(aa_samples=1, integrator_opts=PathOptions(
        path_samples=2, bounces=3, raydepth=2))
    imgs = []
    for isec in ("cuda", "torch"):
        scene = cornell_box(resx=16, resy=16, light_samples=2,
                            intersector=isec, device=device)
        imgs.append(render_image(scene, opts)[0])
    assert torch.equal(imgs[0], imgs[1])


# ---- the grouped cluster kernels (7 and 8) ----

def _grouped_scene(device, intersector="cuda"):
    """The small mesh scene with the grouped accel forced (group=8, 32-tri
    clusters: 8 groups of 8), as tests/test_torch_cluster.py builds it."""
    import dataclasses
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.scenes import mesh_scene
    sc = mesh_scene(resx=32, resy=32, n_grid=24, torus_u=24, torus_v=12,
                    ibl_samples=2, sun_samples=1, device=device)
    cl = ci.build_clusters(sc.geom.verts.cpu().numpy(),
                           sc.geom.tri_vidx.cpu().numpy(), max_leaf=32)
    acc = ci.to_device(ci.group_clusters(
        cl, group=8, sort_origin=sc.camera.pos.cpu().numpy()), device)
    return dataclasses.replace(sc, accel=acc, intersector=intersector)


def _mesh_rays(device, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    lo = torch.tensor([-3.0, 0.2, -3.0], device=device)
    o = lo + torch.rand((n, 3), generator=g, device=device) * torch.tensor(
        [6.0, 2.8, 6.0], device=device)
    d = _unit(torch.randn((n, 3), generator=g, device=device))
    tmax = torch.where(torch.rand(n, generator=g, device=device) < 0.5,
                       torch.rand(n, generator=g, device=device) * 6.0,
                       torch.full((n,), -1.0, device=device))
    ex = torch.randint(-2, 1634, (n,), generator=g, device=device,
                       dtype=torch.int32)
    return vec.RaysS(o=vec.v3(o), d=vec.v3(d),
                     tmin=torch.full((n,), 5e-4, device=device),
                     tmax=tmax), ex, g


@pytest.mark.parametrize("n", [1, 5000])
def test_grouped_closest_hit_kernel_matches_plain(device, n):
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _grouped_scene(device).accel
    rays, ex, _ = _mesh_rays(device, n, seed=n)
    launches = cc.closest_hit_grouped_cuda.launches
    got = cc.closest_hit_grouped_cuda(acc, rays, ex, ex.flip(0))
    want = ci.closest_hit_grouped_torch(acc, rays, ex, ex.flip(0))
    torch.cuda.synchronize()
    assert cc.closest_hit_grouped_cuda.launches == launches + 1
    assert torch.equal(got.prim, want.prim)
    for f in ("t", "u", "v"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=1e-6)


def test_grouped_any_hit_and_nee_kernels_match_plain(device):
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _grouped_scene(device).accel
    n = 5000
    rays, ex, g = _mesh_rays(device, n, seed=3)
    rays = rays._replace(tmax=torch.where(rays.tmax < 0.5, 2.5e-4,
                                          rays.tmax))       # some dead
    got = cc.any_hit_grouped_cuda(acc, rays, ex)
    assert torch.equal(got, ci.any_hit_grouped_torch(acc, rays, ex))
    K = 4
    dirs = [vec.v3(_unit(torch.randn((n, 3), generator=g, device=device)))
            for _ in range(K)]
    caps = [torch.full((n,), c, device=device)
            for c in (-1.0, 3.0, 0.5, 2.5e-4)]
    kern = ci.any_hit_nee_clusters_s(acc, rays.o, rays.tmin, dirs, caps, ex,
                                     None, cc.any_hit_grouped_cuda)
    plain = ci.any_hit_nee_clusters_s(acc, rays.o, rays.tmin, dirs, caps, ex,
                                      None, ci.any_hit_grouped_torch)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    assert not bool(kern[3 * n:].any()) and 0.05 < float(
        kern[:n].float().mean()) < 0.95


def test_grouped_render_through_kernels_equals_plain(device):
    from core_tpu_torch.integrators.direct import DirectOptions
    opts = RenderOptions(aa_samples=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))
    imgs = [render_image(_grouped_scene(device, isec), opts)[0]
            for isec in ("cuda", "torch")]
    assert torch.equal(imgs[0], imgs[1])


# ---- kernel 3 (brute any hit) and the flat cluster kernels (4-6) ----

def test_any_hit_kernel_matches_plain(device):
    n = 70_000
    _, tri, rays, ex, _ = _inputs(device, n, seed=5)
    rays = rays._replace(tmax=torch.where(rays.tmax < 100.0, 2.5e-5,
                                          rays.tmax))        # some dead
    launches = ck.any_hit_cuda.launches
    got = ck.any_hit_cuda(tri, rays, ex, ex.flip(0))
    want = isect.any_hit_torch(tri, rays, ex, ex.flip(0))
    torch.cuda.synchronize()
    assert ck.any_hit_cuda.launches == launches + 1
    assert torch.equal(got, want)
    assert 0.05 < float(got.float().mean()) < 0.95


def _flat_scene(device, intersector="cuda", dirac=False):
    """A small flat mesh scene (4,274 triangles, 32 clusters), optionally
    with the dirac variant's lights."""
    import dataclasses
    from core_tpu_torch.scenes import add_dirac_lights, mesh_builder, \
        mesh_scene
    size = dict(n_grid=44, torus_u=24, torus_v=12)
    if dirac:
        sc = add_dirac_lights(mesh_builder(32, 32, **size,
                                           device=device)).compile_scene()
    else:
        sc = mesh_scene(resx=32, resy=32, ibl_samples=2, sun_samples=1,
                        **size, device=device)
    return dataclasses.replace(sc, intersector=intersector)


def test_flat_closest_and_any_kernels_match_plain(device):
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _flat_scene(device).accel
    assert isinstance(acc, ci.ClusterAccel)
    n = 5000
    rays, ex, _ = _mesh_rays(device, n, seed=11)
    got = cc.closest_hit_flat_cuda(acc, rays, ex, ex.flip(0))
    want = ci.closest_hit_flat_torch(acc, rays, ex, ex.flip(0))
    torch.cuda.synchronize()
    assert torch.equal(got.prim, want.prim)
    for f in ("t", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    rays = rays._replace(tmax=torch.where(rays.tmax < 0.5, 2.5e-4,
                                          rays.tmax))       # some dead
    got = cc.any_hit_flat_cuda(acc, rays, ex)
    assert torch.equal(got, ci.any_hit_flat_torch(acc, rays, ex))
    assert 0.05 < float(got.float().mean()) < 0.95


@pytest.mark.parametrize("K", ck.NEE_K)
def test_flat_nee_kernel_matches_plain(device, K):
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _flat_scene(device).accel
    n = 3000
    rays, ex, g = _mesh_rays(device, n, seed=20 + K)
    dirs = [vec.v3(_unit(torch.randn((n, 3), generator=g, device=device)))
            for _ in range(K)]
    caps = [torch.full((n,), (-1.0, 3.0, 0.5, 2.5e-4)[k % 4], device=device)
            for k in range(K)]
    launches = cc.any_hit_nee_flat_cuda.launches
    got = cc.any_hit_nee_flat_cuda(acc, rays.o, rays.tmin, dirs, caps, ex)
    want = ci.any_hit_nee_flat_torch(acc, rays.o, rays.tmin, dirs, caps, ex)
    torch.cuda.synchronize()
    assert cc.any_hit_nee_flat_cuda.launches == launches + 1
    assert torch.equal(got, want)
    bits = got.view(K, n)
    assert not bool(bits[3::4].any()) and 0.05 < float(
        bits[0].float().mean()) < 0.95


@pytest.mark.parametrize("dirac", [False, True])
def test_flat_render_through_kernels_equals_plain(device, dirac):
    from core_tpu_torch.integrators.direct import DirectOptions
    opts = RenderOptions(aa_samples=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))
    imgs = [render_image(_flat_scene(device, isec, dirac), opts)[0]
            for isec in ("cuda", "torch")]
    assert torch.equal(imgs[0], imgs[1])
