"""The CUDA intersection kernels against their plain PyTorch versions on
the card (the small-size twin of chip_smoke.py's kernel phases): kernels
1-3 on the Cornell box, the flat cluster kernels 4-6 on a 4,274-triangle
mesh scene, the grouped kernels 7-8 on a forced-grouped small mesh scene,
the edge cases of the cooperative walks of kernels 4-8, kernel 2 on
bundles with all-dead lanes and dead rays at 36, 257 and 4,096
triangles, kernels 1 and 3 on the edges of their tests (dead rays, edges
and vertices, t at tmin and tcap, |det| near 1e-12, ties, exclusions) at
36, 257, 1,634 and 4,096 triangles, and renders through the kernels
against renders through the plain versions (among them the 64x64 light
zoo, dl and pt, on the brute kernels 1-3, and the 64x64 glass-and-glossy
box under photonmapping, SPPM and photon caustics; the 64x64
bidirectional, translucent-box SSS and debug renders; the five 64x64
volume and adaptive-pass renders of chip_smoke's phase 22; a 64x64
Cornell scene file through the CLI; a 64x64 render_image_rowsharded
over a one-rank NCCL group, and the BVH's torch traversal on the card), the
photonmapping, SPPM and bidirectional goldens at
tests/test_golden_photon_family.py's bands, and the volume golden at
tests/test_golden_volume.py's.  The 28 edge cases of kernels 1 and 3 run
as one item each, which names every failing case, and so do kernel 2's
bundle widths and its dead-lane cases.

Marked `cuda`: each test asks its fixture for a CUDA device and skips
without one.  Run on a GPU host with
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""
import numpy as np
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


def test_closest_hit_kernel_matches_plain(device):
    """At 1, 1,000 and 70,000 rays, one item (each size named on failure)."""
    for n in (1, 1000, 70_000):
        _, tri, rays, ex, _ = _inputs(device, n)
        launches = ck.closest_hit_cuda.launches
        got = ck.closest_hit_cuda(tri, rays, exclude_prim=ex)
        want = isect.closest_hit_torch(tri, rays, exclude_prim=ex)
        torch.cuda.synchronize()
        assert ck.closest_hit_cuda.launches == launches + 1, n
        assert torch.equal(got.prim, want.prim), n
        for f in ("t", "u", "v"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=1e-6, atol=1e-6,
                                       msg=lambda m: f"n={n} {f}: {m}")


def test_any_hit_nee_kernel_matches_plain(device):
    """Kernel 2 against the plain version at each bundle width K (one
    item; a failing K is reported by name)."""
    failed = []
    for K in ck.NEE_K:
        try:
            _nee_matches_plain(device, K)
        except AssertionError as e:
            failed.append(f"K={K}: {e!r}")
    assert not failed, "\n".join(failed)


def _nee_matches_plain(device, K):
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
    opts = RenderOptions(aa_samples=1, integrator="pathtracing",
                         integrator_opts=PathOptions(path_samples=2,
                                                     bounces=3, raydepth=2))
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


def test_flat_nee_kernel_matches_plain(device):
    """Kernel 6 against the plain version at each bundle width K of
    ck.NEE_K (one item; a failing K is reported by name)."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _flat_scene(device).accel
    n = 3000
    failed = []
    for K in ck.NEE_K:
        rays, ex, g = _mesh_rays(device, n, seed=20 + K)
        dirs = [vec.v3(_unit(torch.randn((n, 3), generator=g,
                                         device=device)))
                for _ in range(K)]
        caps = [torch.full((n,), (-1.0, 3.0, 0.5, 2.5e-4)[k % 4],
                           device=device) for k in range(K)]
        launches = cc.any_hit_nee_flat_cuda.launches
        got = cc.any_hit_nee_flat_cuda(acc, rays.o, rays.tmin, dirs, caps,
                                       ex)
        want = ci.any_hit_nee_flat_torch(acc, rays.o, rays.tmin, dirs, caps,
                                         ex)
        torch.cuda.synchronize()
        try:
            assert cc.any_hit_nee_flat_cuda.launches == launches + 1
            assert torch.equal(got, want)
            bits = got.view(K, n)
            assert not bool(bits[3::4].any()) and 0.05 < float(
                bits[0].float().mean()) < 0.95
        except AssertionError as e:
            failed.append(f"K={K}: {e!r}")
    assert not failed, "\n".join(failed)


@pytest.mark.parametrize("dirac", [False, True])
def test_flat_render_through_kernels_equals_plain(device, dirac):
    from core_tpu_torch.integrators.direct import DirectOptions
    opts = RenderOptions(aa_samples=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))
    imgs = [render_image(_flat_scene(device, isec, dirac), opts)[0]
            for isec in ("cuda", "torch")]
    assert torch.equal(imgs[0], imgs[1])


# ---- the cooperative sweeps of kernels 6 and 8 on edge cases ----

EDGE_CASES = ("single", "dead", "open", "n1", "n127", "n129", "excluded")


def _bundle(device, acc, case, K=4):
    """A NEE bundle (o3, tmin, dirs, caps, ex) over a small mesh scene's
    accel: "single", one ray of one lane reaches the geometry (every other
    ray points up, out of the scene); "dead", every cap 0 < tcap <= tmin;
    "open", every cap open; "n1"/"n127"/"n129", that many lanes with mixed
    caps; "excluded", each ray capped just past its closest hit and each
    lane excluded from its first ray's hit triangle, its only occluder."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    n = {"n1": 1, "n127": 127, "n129": 129}.get(case, 256)
    rays, ex, g = _mesh_rays(device, n, seed=len(case))
    o3, tmin = rays.o, rays.tmin
    dirs = [vec.v3(_unit(torch.randn((n, 3), generator=g, device=device)))
            for _ in range(K)]
    caps = [torch.full((n,), (-1.0, 3.0, 0.5, 2.5e-4)[k % 4], device=device)
            for k in range(K)]
    if case == "single":
        o3 = vec.v3(torch.tensor([0.1, 10.0, 0.2], device=device)
                    .repeat(n, 1))
        up = torch.tensor([0.0, 1.0, 0.0], device=device).repeat(n, 1)
        dirs = [vec.v3(up) for _ in range(K)]
        dirs[0].y[n // 2] = -1.0       # down, through the torus's hole
        caps = [torch.full((n,), -1.0, device=device) for _ in range(K)]
    elif case == "dead":
        caps = [torch.full((n,), 2.5e-4, device=device) for _ in range(K)]
    elif case == "open":
        caps = [torch.full((n,), -1.0, device=device) for _ in range(K)]
    elif case == "excluded":
        closest = (ci.closest_hit_flat_torch
                   if isinstance(acc, ci.ClusterAccel)
                   else ci.closest_hit_grouped_torch)
        hits = [closest(acc, vec.RaysS(o=o3, d=d, tmin=tmin,
                                       tmax=torch.full((n,), -1.0,
                                                       device=device)))
                for d in dirs]
        caps = [torch.where(h.prim >= 0, h.t * 1.0001, -1.0) for h in hits]
        ex = hits[0].prim
    return o3, tmin, dirs, caps, ex


def _expect(case, bits, caps, ex):
    """What each edge case must show beyond equality with the plain
    version (bits: [K, n])."""
    n = bits.shape[1]
    if case == "single":
        assert bool(bits[0, n // 2]) and int(bits.sum()) == 1
    elif case == "dead":
        assert not bool(bits.any())
    elif case == "open":
        assert 0.05 < float(bits.float().mean()) < 0.95
    elif case == "excluded":
        hit = ex >= 0
        assert int(hit.sum()) > n // 4
        assert float(bits[0][hit].float().mean()) < 0.1
        # the other rays keep their own closest hit as an occluder
        capped = torch.stack(caps[1:]) > 0
        assert float((bits[1:] == capped).float().mean()) > 0.9


def test_flat_nee_kernel_edge_cases(device):
    """Kernel 6 against the plain version on each of EDGE_CASES (one item;
    a failing case is reported by name)."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _flat_scene(device).accel
    failed = []
    for case in EDGE_CASES:
        o3, tmin, dirs, caps, ex = _bundle(device, acc, case)
        got = cc.any_hit_nee_flat_cuda(acc, o3, tmin, dirs, caps, ex)
        want = ci.any_hit_nee_flat_torch(acc, o3, tmin, dirs, caps, ex)
        torch.cuda.synchronize()
        try:
            assert torch.equal(got, want)
            _expect(case, got.view(len(dirs), -1), caps, ex)
        except AssertionError as e:
            failed.append(f"case={case}: {e!r}")
    assert not failed, "\n".join(failed)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_grouped_any_kernel_edge_cases(device, case):
    """Kernel 8 on the bundle's rays as they come and through the
    re-bucketed NEE route."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _grouped_scene(device).accel
    o3, tmin, dirs, caps, ex = _bundle(device, acc, case)
    K = len(dirs)
    rays = vec.RaysS(o=vec.V3(*[c.repeat(K) for c in o3]),
                     d=vec.V3(*[torch.cat([getattr(d, f) for d in dirs])
                                for f in "xyz"]),
                     tmin=tmin.repeat(K), tmax=torch.cat(caps))
    got = cc.any_hit_grouped_cuda(acc, rays, ex.repeat(K))
    want = ci.any_hit_grouped_torch(acc, rays, ex.repeat(K))
    route = ci.any_hit_nee_clusters_s(acc, o3, tmin, dirs, caps, ex, None,
                                      cc.any_hit_grouped_cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(route, want)
    _expect(case, got.view(K, -1), caps, ex)


# ---- the cooperative walks of kernels 5 and 7 on edge cases ----

@pytest.mark.parametrize("case", EDGE_CASES + ("leaf30",))
def test_flat_any_kernel_edge_cases(device, case):
    """Kernel 5 on each edge-case bundle's K*n rays, one ray per lane, and
    ("leaf30") on mixed rays over the scene's triangles clustered 30 to a
    leaf, so that leaf % 4 != 0 and clusters are staged word by word."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc = _flat_scene(device).accel
    if case == "leaf30":
        geom = _flat_scene(device).geom
        acc = ci.to_device(ci.build_clusters(geom.verts.cpu().numpy(),
                                             geom.tri_vidx.cpu().numpy(),
                                             max_leaf=30), device)
        assert isinstance(acc, ci.ClusterAccel) and acc.leaf % 4
        rays, ex, _ = _mesh_rays(device, 3000, seed=30)
        rays = rays._replace(tmax=torch.where(rays.tmax < 0.5, 2.5e-4,
                                              rays.tmax))   # some dead
        ex0, ex1, caps, K = ex, ex.flip(0), None, 1
    else:
        o3, tmin, dirs, caps, ex = _bundle(device, acc, case)
        K = len(dirs)
        rays = vec.RaysS(o=vec.V3(*[c.repeat(K) for c in o3]),
                         d=vec.V3(*[torch.cat([getattr(d, f) for d in dirs])
                                    for f in "xyz"]),
                         tmin=tmin.repeat(K), tmax=torch.cat(caps))
        ex0, ex1 = ex.repeat(K), None
    launches = cc.any_hit_flat_cuda.launches
    got = cc.any_hit_flat_cuda(acc, rays, ex0, ex1)
    want = ci.any_hit_flat_torch(acc, rays, ex0, ex1)
    torch.cuda.synchronize()
    assert cc.any_hit_flat_cuda.launches == launches + 1
    assert torch.equal(got, want)
    if case == "leaf30":
        assert 0.05 < float(got.float().mean()) < 0.95
    else:
        _expect(case, got.view(K, -1), caps, ex)


CLOSEST_CASES = ("n1", "n127", "n129", "miss", "excluded", "open", "tie",
                 "coherent")


def _closest_case(device, case):
    """(grouped accel, rays, ex0, ex1) of a kernel-7 edge case: "n1",
    "n127", "n129", that many mixed rays with both exclusion slots set;
    "miss", rays from above the scene pointing up, the first half and some
    others dead; "excluded",
    each ray excluded from its first and second hit triangles; "open",
    every cap open; "tie", the scene's triangles twice over, so that every
    hit is at the equal t of two identical triangles; "coherent", rays of
    one origin in a narrow cone over those triangles, so that most of a
    warp's rays pass each cluster together (the thread-per-ray branch of
    the test)."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    sc = _grouped_scene(device)
    acc = sc.accel
    if case in ("tie", "coherent"):
        vidx = sc.geom.tri_vidx.cpu().numpy()
        cl = ci.build_clusters(sc.geom.verts.cpu().numpy(),
                               np.concatenate([vidx, vidx]), max_leaf=32)
        acc = ci.to_device(ci.group_clusters(
            cl, group=8, sort_origin=sc.camera.pos.cpu().numpy()), device)
    n = {"n1": 1, "n127": 127, "n129": 129}.get(case, 256)
    rays, ex, g = _mesh_rays(device, n, seed=40 + len(case))
    ex0, ex1 = ex, ex.flip(0)
    if case == "miss":
        o = rays.o.y.new_full((n,), 10.0)
        rays = rays._replace(
            o=vec.V3(rays.o.x, o, rays.o.z),
            d=vec.V3(torch.zeros_like(o), torch.ones_like(o),
                     torch.zeros_like(o)))
        # the first half dead (whole warps of them), the rest mixed
        dead = (torch.arange(n, device=device) < n // 2) | (rays.tmax < 0.5)
        rays = rays._replace(tmax=torch.where(dead, 2.5e-4, rays.tmax))
    elif case == "coherent":
        d = torch.stack([torch.rand(n, generator=g, device=device) * 0.6
                         - 0.3, -torch.ones(n, device=device),
                         torch.rand(n, generator=g, device=device) * 0.6
                         - 0.3], dim=1)
        o = torch.tensor([0.1, 2.9, 0.2], device=device).repeat(n, 1)
        rays = vec.RaysS(o=vec.v3(o), d=vec.v3(_unit(d)), tmin=rays.tmin,
                         tmax=torch.full((n,), -1.0, device=device))
        ex0 = ex1 = None
    elif case in ("excluded", "open", "tie"):
        rays = rays._replace(tmax=torch.full((n,), -1.0, device=device))
        ex0 = ex1 = None
        if case == "excluded":
            ex0 = ci.closest_hit_grouped_torch(acc, rays).prim
            ex1 = ci.closest_hit_grouped_torch(acc, rays, ex0).prim
    return acc, rays, ex0, ex1


@pytest.mark.parametrize("case", CLOSEST_CASES)
def test_grouped_closest_kernel_edge_cases(device, case):
    """Kernel 7 against its plain version on every lane, bit for bit."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc, rays, ex0, ex1 = _closest_case(device, case)
    got = cc.closest_hit_grouped_cuda(acc, rays, ex0, ex1)
    want = ci.closest_hit_grouped_torch(acc, rays, ex0, ex1)
    torch.cuda.synchronize()
    for f in ("prim", "t", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    hit = got.prim >= 0
    if case == "miss":
        assert not bool(hit.any()) and bool((got.t == -1.0).all())
    elif case == "excluded":
        assert int(hit.sum()) > 0
        assert not bool((hit & ((got.prim == ex0) | (got.prim == ex1)))
                        .any())
    elif case in ("tie", "coherent"):
        # the copy visited first wins, whichever copy that is
        T = acc.count.sum().item() // 2
        assert bool((got.prim >= T).any()) and bool(
            (hit & (got.prim < T)).any())


# ---- kernel 4 (the flat closest-hit walk) on edge cases ----

FLAT_CLOSEST_CASES = ("n1", "n127", "n129", "miss", "excluded", "open",
                      "tie", "coherent", "shrink", "c1023")


def _flat_accel(device, vidx, max_leaf, n_clusters, leaf=None):
    """The small mesh scene's triangles (rows vidx) clustered max_leaf to a
    leaf, cut to the first n_clusters clusters, the triangle block padded
    to `leaf` slots."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    verts = _grouped_scene(device).geom.verts.cpu().numpy()
    cl = ci.build_clusters(verts, vidx, max_leaf=max_leaf)
    tris = cl.tris[:n_clusters]
    if leaf is not None:
        pad = np.zeros((n_clusters, leaf - tris.shape[1], 10), np.float32)
        pad[:, :, 9] = -1.0
        tris = np.concatenate([tris, pad], axis=1)
    acc = ci.to_device(ci.ClusterData(aabb=cl.aabb[:n_clusters], tris=tris),
                       device)
    assert acc.aabb.shape[0] == n_clusters
    return acc


def _flat_closest_case(device, case):
    """(flat accel, rays, ex0, ex1) of a kernel-4 edge case.  The rays are
    those of _closest_case; the accel holds the small mesh scene's
    triangles in 250 clusters of 10 slots (neither a multiple of 32
    clusters nor of 4 slots, so clusters are staged word by word), for
    "tie" and "coherent" the triangles twice over in 450 clusters of 12,
    for "c1023" 1,023 clusters of 2 triangles padded to 256 slots (53,216
    bytes of shared memory, above the 48 KB default).  "shrink": grazing
    rays across the terrain, some of which find a hit among the first 32
    clusters (the first ballot) and a nearer one after them."""
    vidx = _grouped_scene(device).geom.tri_vidx.cpu().numpy()
    acc = _flat_accel(device, vidx, 10, 250)
    if case in ("tie", "coherent"):
        acc = _flat_accel(device, np.concatenate([vidx, vidx]), 12, 450)
    elif case == "c1023":
        acc = _flat_accel(device, vidx, 2, 1023, leaf=256)
    _, rays, ex0, ex1 = _closest_case(device, {"shrink": "open",
                                               "c1023": "n129"}.get(case,
                                                                    case))
    if case == "shrink":
        n = 4096
        g = torch.Generator(device=device).manual_seed(77)
        o = torch.stack([torch.full((n,), -4.0, device=device),
                         torch.rand(n, generator=g, device=device) * 0.8
                         + 0.3,
                         torch.rand(n, generator=g, device=device) * 6 - 3],
                        dim=1)
        d = torch.stack([torch.ones(n, device=device),
                         -torch.rand(n, generator=g, device=device) * 0.3,
                         torch.randn(n, generator=g, device=device) * 0.3],
                        dim=1)
        rays = vec.RaysS(o=vec.v3(o), d=vec.v3(_unit(d)),
                         tmin=torch.full((n,), 5e-4, device=device),
                         tmax=torch.full((n,), -1.0, device=device))
    return acc, rays, ex0, ex1


@pytest.mark.parametrize("case", FLAT_CLOSEST_CASES)
def test_flat_closest_kernel_edge_cases(device, case):
    """Kernel 4 against its plain version on every lane, bit for bit."""
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    acc, rays, ex0, ex1 = _flat_closest_case(device, case)
    launches = cc.closest_hit_flat_cuda.launches
    got = cc.closest_hit_flat_cuda(acc, rays, ex0, ex1)
    want = ci.closest_hit_flat_torch(acc, rays, ex0, ex1)
    torch.cuda.synchronize()
    assert cc.closest_hit_flat_cuda.launches == launches + 1
    for f in ("prim", "t", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    hit = got.prim >= 0
    C = acc.aabb.shape[0]
    assert C % 32
    assert acc.leaf % 4 == 0 if case in ("tie", "coherent", "c1023") \
        else acc.leaf % 4
    if case == "miss":
        assert not bool(hit.any()) and bool((got.t == -1.0).all())
    elif case == "excluded":
        assert int(hit.sum()) > 0
        assert not bool((hit & ((got.prim == ex0) | (got.prim == ex1)))
                        .any())
    elif case in ("tie", "coherent"):
        # the copy visited first wins, whichever copy that is (the copies
        # are the ids from T on)
        T = (int(acc.tri_id.max()) + 1) // 2
        assert bool((got.prim >= T).any()) and bool(
            (hit & (got.prim < T)).any())
    elif case == "shrink":
        first = ci.closest_hit_flat_torch(ci.ClusterAccel(
            *[a[:32] for a in acc]), rays)
        shrank = (first.prim >= 0) & (got.t < first.t)
        assert int(shrank.sum()) > 0
    elif case == "c1023":
        from core_tpu_torch.geometry.cuda_cluster import FLAT_MAX_CLUSTERS
        assert C == FLAT_MAX_CLUSTERS and acc.leaf == 256
        assert (C * 8 + 2 * acc.leaf * 10) * 4 > 48 * 1024
        assert int(hit.sum()) > 0


# ---- kernel 2 (the brute NEE bundle) with dead lanes ----

def _tri_table(device, T, g):
    """T triangles: the Cornell box's 36, then random ones inside it."""
    tri = _inputs(device, 1)[1]
    if T <= tri.shape[0]:
        return tri[:T].contiguous()
    m = T - tri.shape[0]
    v0 = torch.tensor([10.0, 10.0, 10.0], device=device) + torch.rand(
        (m, 3), generator=g, device=device) * 520.0
    e = torch.randn((m, 6), generator=g, device=device) * 30.0
    return torch.cat([tri, torch.cat([v0, e], dim=1)]).contiguous()


def test_any_hit_nee_kernel_dead_lanes(device):
    """Kernel 2 on lanes in four runs: whole blocks of all-dead lanes,
    all-dead lanes mixed one by one with live ones, lanes with some dead
    rays, and all-live lanes; both exclusions; 1,000 lanes (not a
    multiple of the block of 128); bits identical to the plain version;
    at T = 36, 257 and 4,096 triangles and each K (one item; a failing
    (T, K) is reported by name)."""
    failed = []
    for T in (36, 257, 4096):
        for K in ck.NEE_K:
            try:
                _nee_dead_lanes(device, K, T)
            except AssertionError as e:
                failed.append(f"T={T} K={K}: {e!r}")
    assert not failed, "\n".join(failed)


def _nee_dead_lanes(device, K, T):
    n = 1000
    _, _, rays, ex, g = _inputs(device, n, seed=100 + K + T)
    tri = _tri_table(device, T, g)
    ex = torch.randint(-2, T, (n,), generator=g, device=device,
                       dtype=torch.int32)
    dirs = [vec.v3(_unit(torch.randn((n, 3), generator=g, device=device)))
            for _ in range(K)]
    tmin = torch.full((n,), 5e-4, device=device)
    lane = torch.arange(n, device=device)
    dead_lane = (lane < 256) | ((lane < 500) & (lane % 3 == 0))
    caps = []
    for k in range(K):
        c = torch.where(torch.rand(n, generator=g, device=device) < 0.3,
                        torch.full((n,), -1.0, device=device),
                        torch.rand(n, generator=g, device=device) * 600)
        some_dead = (lane >= 500) & (lane < 750) & (
            torch.rand(n, generator=g, device=device) < 0.5)
        # dead: 0 < tcap <= tmin, some exactly tmin
        dead = torch.where(torch.rand(n, generator=g, device=device) < 0.1,
                           tmin, torch.rand(n, generator=g, device=device)
                           * 4.9e-4 + 1e-6)
        caps.append(torch.where(dead_lane | some_dead, dead, c))
    launches = ck.any_hit_nee_cuda.launches
    got = ck.any_hit_nee_cuda(tri, rays.o, tmin, dirs, caps, ex, ex.flip(0))
    want = isect.any_hit_nee_torch(tri, rays.o, tmin, dirs, caps, ex,
                                   ex.flip(0))
    torch.cuda.synchronize()
    assert ck.any_hit_nee_cuda.launches == launches + 1
    assert torch.equal(got, want)
    bits = got.view(K, n)
    assert not bool(bits[:, dead_lane].any())
    assert 0.02 < float(bits[:, lane >= 750].float().mean()) < 0.98


# ---- kernels 1 and 3 on the edges of their tests ----

HARD_CASES = ("dead", "edges", "t_limits", "det", "ties", "excluded",
              "ragged")


def _ulps(x, k, g):
    """x (float32) moved by a random whole number of ulps in [-k, k]."""
    step = torch.randint(-k, k + 1, x.shape, generator=g, device=x.device,
                         dtype=torch.int32)
    return (x.view(torch.int32) + step).view(torch.float32)


def _aimed(tri, rows, a, b, dist, g):
    """Rays from `dist` away toward the points v0 + a e1 + b e2 of the
    given rows, in float64, then float32 with the origin moved by up to 3
    ulps; tmin 5e-5, open caps."""
    n = rows.shape[0]
    dev = tri.device
    t = tri.double()[rows]
    p = t[:, 0:3] + a[:, None] * t[:, 3:6] + b[:, None] * t[:, 6:9]
    d = torch.randn((n, 3), generator=g, device=dev, dtype=torch.float64)
    d = d / d.norm(dim=1, keepdim=True)
    o = _ulps((p - d * dist[:, None]).float(), 3, g)
    return vec.RaysS(o=vec.v3(o), d=vec.v3(d.float()),
                     tmin=torch.full((n,), 5e-5, device=dev),
                     tmax=torch.full((n,), -1.0, device=dev))


def _hard_case(device, T, case):
    """[(tri, rays, ex0, ex1)] of one hard case at T triangles (the Cornell
    box's, then random ones; 3,001 rays, not a multiple of a block):
    "dead", whole blocks of dead rays (0 < tcap <= tmin, some exactly
    tmin), then dead rays mixed one by one with live ones, then live ones;
    "edges", rays aimed at edges (u = 0, v = 0, u + v = 1) and vertices
    within a few ulps; "t_limits", tmin (first half) or tcap (second half)
    within 2 ulps of the ray's closest t; "det", slivers near the
    coordinate origin with |det| from 0.45e-12 to 2e-12 for their rays;
    "ties", rows copied to higher indices (equal t: the lower index wins);
    "excluded", the same with both exclusions on the aimed row and its
    copy; "ragged", 1, 255 and 257 random rays."""
    g = torch.Generator(device=device).manual_seed(
        700 + T + 31 * HARD_CASES.index(case))
    tri = _tri_table(device, T, g)
    f64 = torch.float64

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=f64)

    if case == "ragged":
        out = []
        for n in (1, 255, 257):
            _, _, rays, ex, _ = _inputs(device, n, seed=T + n)
            ex = torch.randint(-2, T, (n,), generator=g, device=device,
                               dtype=torch.int32)
            out.append((tri, rays, ex, ex.flip(0)))
        return out
    n = 3001
    ex0 = ex1 = None
    if case == "dead":
        _, _, rays, _, _ = _inputs(device, n, seed=T)
        lane = torch.arange(n, device=device)
        tmin = torch.full((n,), 5e-4, device=device)
        dead = (lane < 512) | ((lane < 1024) & (lane % 2 == 0))
        cap = torch.where(rand(n) < 0.1, tmin, (rand(n) * 4.9e-4 + 1e-6)
                          .float())
        return [(tri, rays._replace(tmin=tmin, tmax=torch.where(
            dead, cap, rays.tmax)), None, None)]
    m = min(16, T // 2)
    if case == "det":
        # slivers: legs of 1.5e-6 at a right angle, 1e-3 from the origin
        tri = tri.clone()
        v0 = 1e-3 + rand(m, 3) * 1e-3
        a = rand(m, 3) - 0.5
        a = a / a.norm(dim=1, keepdim=True)
        b = torch.linalg.cross(a, rand(m, 3) - 0.5)
        b = b / b.norm(dim=1, keepdim=True)
        tri[T - m:] = torch.cat([v0, 1.5e-6 * a, 1.5e-6 * b], 1).float()
        rows = T - m + torch.randint(0, m, (n,), generator=g, device=device)
        # directions at cos 0.2-0.9 to the sliver's normal, so |det| =
        # 2.25e-12 cos
        t = tri.double()[rows]
        nrm = torch.linalg.cross(t[:, 3:6], t[:, 6:9])
        nrm = nrm / nrm.norm(dim=1, keepdim=True)
        side = torch.linalg.cross(nrm, t[:, 3:6])
        side = side / side.norm(dim=1, keepdim=True)
        c = 0.2 + rand(n) * 0.7
        d = c[:, None] * nrm + (1 - c * c).sqrt()[:, None] * side
        d = torch.where((rand(n) < 0.5)[:, None], d, -d)
        p = t[:, 0:3] + 0.25 * t[:, 3:6] + 0.25 * t[:, 6:9]
        o = (p - d * (1e-4 + rand(n) * 1e-3)[:, None]).float()
        return [(tri, vec.RaysS(o=vec.v3(o), d=vec.v3(d.float()),
                                tmin=torch.full((n,), 5e-5, device=device),
                                tmax=torch.full((n,), -1.0, device=device)),
                 None, None)]
    if case in ("ties", "excluded"):
        tri = tri.clone()
        tri[T // 2:T // 2 + m] = tri[:m]
        rows = torch.randint(0, m, (n,), generator=g, device=device)
    else:
        rows = torch.randint(0, T, (n,), generator=g, device=device)
    x = rand(n)
    kind = torch.randint(0, 6, (n,), generator=g, device=device)
    if case in ("edges", "ties", "excluded"):
        # (0, x), (x, 0), (x, 1 - x), and the vertices v0, v0 + e1, v0 + e2
        a = torch.stack([0 * x, x, x, 0 * x, 1 + 0 * x, 0 * x])
        b = torch.stack([x, 0 * x, 1 - x, 0 * x, 0 * x, 1 + 0 * x])
        a = a.gather(0, kind[None])[0]
        b = b.gather(0, kind[None])[0]
    else:
        a = x * 0.5
        b = rand(n) * 0.5
    rays = _aimed(tri, rows, a, b, 1.0 + rand(n) * 300.0, g)
    if case == "t_limits":
        t = isect.closest_hit_torch(tri, rays).t
        near = _ulps(t, 2, g)
        first = torch.arange(n, device=device) < n // 2
        hit = t > 0
        rays = rays._replace(
            tmin=torch.where(first & hit, near, rays.tmin),
            tmax=torch.where(~first & hit, near, rays.tmax))
    if case == "excluded":
        ex0 = rows.to(torch.int32)
        ex1 = torch.where(rand(n) < 0.5, ex0 + T // 2, -2).to(torch.int32)
    return [(tri, rays, ex0, ex1)]


HARD_T = (36, 257, 1634, 4096)


def _each_hard_case(device, check):
    """check(T, case, inputs) on every (T, case) pair, HARD_T x HARD_CASES
    (28 cases); fails after all of them ran, naming each failing case with
    its assertion."""
    failed = []
    for T in HARD_T:
        for case in HARD_CASES:
            try:
                for inputs in _hard_case(device, T, case):
                    check(case, *inputs)
            except AssertionError as e:
                failed.append(f"T={T} case={case}: {e!r}")
    assert not failed, "\n".join(failed)


def test_closest_hit_kernel_hard_cases(device):
    """Kernel 1 (division-free pre-test, then the exact test) against the
    plain version, every output bit for bit, on each of the 28 hard cases
    (one item; a failing case is reported by name)."""
    def check(case, tri, rays, ex0, ex1):
        launches = ck.closest_hit_cuda.launches
        got = ck.closest_hit_cuda(tri, rays, ex0, ex1)
        want = isect.closest_hit_torch(tri, rays, ex0, ex1)
        torch.cuda.synchronize()
        assert ck.closest_hit_cuda.launches == launches + 1
        for f in ("prim", "t", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        if case in ("edges", "t_limits", "det", "ties", "excluded"):
            assert float(got.valid.float().mean()) > 0.05

    _each_hard_case(device, check)


def test_any_hit_kernel_hard_cases(device):
    """Kernel 3 (compacted live rays, the triangle-parallel tail) against
    the plain version, bit for bit, dead rays never occluded, on each of
    the 28 hard cases (one item; a failing case is reported by name)."""
    def check(case, tri, rays, ex0, ex1):
        launches = ck.any_hit_cuda.launches
        got = ck.any_hit_cuda(tri, rays, ex0, ex1)
        want = isect.any_hit_torch(tri, rays, ex0, ex1)
        torch.cuda.synchronize()
        assert ck.any_hit_cuda.launches == launches + 1
        assert torch.equal(got, want)
        dead = (rays.tmax > 0) & (rays.tmax <= rays.tmin)
        assert not bool(got[dead].any())

    _each_hard_case(device, check)


@pytest.mark.parametrize("kind", ["dl", "pt"])
def test_light_zoo_kernels_equal_plain_versions(device, kind):
    """chip_smoke's 64^2 light zoo (the sphere, mesh, IES and portal lights
    under a darksky, a thin lens, a Gauss filter) at its small size, 1,668
    triangles: the renders through kernels 1-3 and through the plain
    versions are identical."""
    from chip_smoke import LZ_SMALL, light_zoo_opts, light_zoo_scene
    imgs = [render_image(light_zoo_scene(64, isec, device=device,
                                         **LZ_SMALL),
                         light_zoo_opts(kind))[0] for isec in ("cuda", "torch")]
    assert torch.isfinite(imgs[0]).all()
    assert torch.equal(*imgs)


@pytest.mark.parametrize("kind", ["pm", "sppm", "pt"])
def test_photon_renders_through_kernels_equal_plain_versions(device, kind):
    """chip_smoke's 64^2 glass-and-glossy box under photonmapping (final
    gathering with its cache), SPPM over 2 passes and path tracing with
    caustic_type "both": the renders through kernels 1 and 2 and through
    the plain versions are identical."""
    from chip_smoke import PH_BLOCKS, PH_SLICE_OPTS, photon_opts
    imgs = [render_image(cornell_box(resx=64, resy=64, light_samples=4,
                                     block_materials=PH_BLOCKS,
                                     intersector=isec, device=device),
                         photon_opts(kind, PH_SLICE_OPTS[kind], aa=2))[0]
            for isec in ("cuda", "torch")]
    assert torch.isfinite(imgs[0]).all()
    assert torch.equal(*imgs)


@pytest.mark.parametrize("kind", ["pm", "sppm"])
def test_photon_goldens_through_kernels(device, kind):
    """tests/test_golden_photon_family.py's photonmapping and SPPM goldens
    on the card (the 64^2 Cornell box, the goldens' options), at its
    bands."""
    from chip_smoke import (PH_GOLDEN, photon_golden_ok, photon_golden_stats,
                            photon_opts)
    scene = cornell_box(resx=64, resy=64, light_samples=16, device=device)
    img, _ = render_image(scene, photon_opts(kind, PH_GOLDEN[kind]))
    stats = photon_golden_stats(kind, img)
    assert photon_golden_ok(kind, *stats), stats


@pytest.mark.parametrize("kind", ["bd", "sss_dl", "sss_pt", "debug"])
def test_bidir_sss_debug_renders_through_kernels_equal_plain_versions(
        device, kind):
    """chip_smoke's 64^2 phase-21 renders: the Cornell box under the
    bidirectional integrator with the light image (kernels 1 and 3), the
    translucent box under directlight and path tracing with use_sss
    (kernels 1 and 2), and every debug type on golden_mesh_scene (kernel
    1): through the kernels and through the plain versions identical."""
    import dataclasses
    from chip_smoke import (DEBUG_TYPES, bidir_opts, sss_opts,
                            translucent_box)
    from core_tpu_torch.integrators.debug import DebugOptions
    from core_tpu_torch.scenes import golden_mesh_scene
    if kind == "bd":
        cases = [(lambda isec: cornell_box(resx=64, resy=64, light_samples=4,
                                           intersector=isec, device=device),
                  bidir_opts(2, 2))]
    elif kind == "debug":
        gm = golden_mesh_scene(64, 64, device=device)
        cases = [(lambda isec: dataclasses.replace(gm, intersector=isec),
                  RenderOptions(integrator="debug", integrator_opts=(
                      DebugOptions(debug_type=t)))) for t in DEBUG_TYPES]
    else:
        cases = [(lambda isec: translucent_box(64, 4, intersector=isec,
                                               device=device),
                  sss_opts(kind[-2:], True, aa=2, spp_chunk=2))]
    for make, opts in cases:
        imgs = [render_image(make(isec), opts)[0]
                for isec in ("cuda", "torch")]
        assert torch.isfinite(imgs[0]).all()
        assert torch.equal(*imgs)


def test_bidir_golden_through_kernels(device):
    """tests/test_golden_photon_family.py's bidirectional golden on the
    card (the 64^2 Cornell box, its options) at its bands: block Pearson
    against the golden, energy relative to it, and the mean against the
    float64 arbiter."""
    from chip_smoke import (ARBITER64_ENERGY, BD_GOLDEN_AA, bidir_opts,
                            photon_golden_stats)
    scene = cornell_box(resx=64, resy=64, light_samples=16, device=device)
    img, _ = render_image(scene, bidir_opts(BD_GOLDEN_AA, 2,
                                            do_light_image=False))
    rel, pearson, _ = photon_golden_stats("bd", img)
    assert pearson > 0.99, pearson
    assert 0.1 <= rel <= 0.6, rel
    mean = float(img[..., :3].mean())
    assert abs(mean - ARBITER64_ENERGY) / ARBITER64_ENERGY < 0.10, mean


def test_volume_golden_through_kernels(device):
    """tests/test_golden_volume.py's volume golden on the card (the 128^2
    spotlight shaft, its options) at its bands: the air's mean and MAE,
    the ground's mean and block Pearson."""
    from chip_smoke import (VOL_GOLDEN_RES, volume_config,
                            volume_golden_ok, volume_golden_stats)
    scene, opts = volume_config("vol128_golden", VOL_GOLDEN_RES,
                                device=device)
    stats = volume_golden_stats(render_image(scene, opts)[0])
    assert volume_golden_ok(stats), stats


def test_volume_optimize_matches_march_through_kernels(device):
    """Single scattering with optimize=True (the attenuation grids) against
    the march at 64^2, 4 spp: relative mean below 0.03, as
    tests/test_golden_volume.py holds core_tpu."""
    from chip_smoke import VOL_BANDS, optimize_rel
    assert optimize_rel(device) < VOL_BANDS["optimize_rel"]


@pytest.mark.parametrize("name", ["vol128_golden", "vol512_ss",
                                  "cornell256_fog_pt",
                                  "goldenmesh256_sky_dl",
                                  "cornell256_aa3_dl"])
def test_volume_and_pass_renders_through_kernels_equal_plain_versions(
        device, name):
    """chip_smoke's phase-22 configurations at 64^2 (the volume golden's
    scene in single scattering, the fogged Cornell box path-traced, the
    golden mesh under the sky integrator, three adaptive passes with
    show_sam_pix): through the kernels and through the plain versions
    identical."""
    from chip_smoke import volume_config
    imgs = [render_image(*volume_config(name, 64, isec, device=device))[0]
            for isec in ("cuda", "torch")]
    assert torch.isfinite(imgs[0]).all()
    assert torch.equal(*imgs)


def test_cli_scene_file_through_kernels_equals_plain(device, tmp_path):
    """chip_smoke's Cornell scene file at 64^2 (write_cornell_xml: phase
    3's configuration) through cli.main on the card: its PNG is the bytes
    write_png gives the same file rendered with the plain versions on the
    card; --profile's trace holds the kernels."""
    import dataclasses
    from chip_smoke import write_cornell_xml
    from core_tpu_torch import cli
    from core_tpu_torch.io.image import write_png
    from core_tpu_torch.io.xml_loader import parse_xml_scene
    xml = str(write_cornell_xml(tmp_path / "cornell.xml", 64))
    launches = ck.closest_hit_cuda.launches
    assert cli.main([xml, str(tmp_path / "cli"), "-f", "png", "--device",
                     "cuda", "-v", "0", "--profile",
                     str(tmp_path / "prof")]) == 0
    assert ck.closest_hit_cuda.launches > launches
    # the trace holds the card's activity: the kernels by name
    assert "closest_hit_kernel" in (tmp_path / "prof" /
                                    "trace.json").read_text()
    scene, opts = parse_xml_scene(xml, device=device)
    img = render_image(dataclasses.replace(scene, intersector="torch"),
                       opts)[0]
    assert torch.isfinite(img).all()
    write_png(str(tmp_path / "plain.png"), img.cpu().numpy())
    assert (tmp_path / "cli.png").read_bytes() == \
        (tmp_path / "plain.png").read_bytes()


def test_rowsharded_nccl_and_bvh_on_the_card(device):
    """render_image_rowsharded over a one-rank NCCL group on the card
    through kernels 1 and 2 is render_image's image (one tile splats the
    same samples in the same order); the 64^2 Cornell box with the BVH as
    its accel (the torch traversal, no kernel) renders within 0.5% of
    pixels of the brute kernels' image."""
    import socket
    from core_tpu_torch.geometry import bvh
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.parallel import distributed as pd
    from core_tpu_torch.parallel import sharding
    scene = cornell_box(resx=64, resy=64, light_samples=2, device=device)
    opts = RenderOptions(aa_samples=2, spp_chunk=1, integrator="pathtracing",
                         integrator_opts=PathOptions(path_samples=2,
                                                     bounces=2))
    ref = render_image(scene, opts)[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pd.init_distributed(f"127.0.0.1:{port}", 1, 0, device=str(device))
    try:
        assert pd.dist.get_backend() == "nccl"
        launches = ck.closest_hit_cuda.launches
        img = sharding.render_image_rowsharded(scene, opts,
                                               sharding.make_mesh(1))
        assert ck.closest_hit_cuda.launches > launches
    finally:
        pd.shutdown()
    assert torch.equal(img, ref)

    dl = RenderOptions(integrator_opts=DirectOptions(raydepth=1))
    sb = bvh.with_bvh_accel(scene)
    launches = ck.closest_hit_cuda.launches
    got = render_image(sb, dl)[0]
    assert ck.closest_hit_cuda.launches == launches
    d = (got - render_image(scene, dl)[0])[..., :3].abs()
    assert float((d.amax(dim=-1) > 1e-2).float().mean()) <= 0.005
