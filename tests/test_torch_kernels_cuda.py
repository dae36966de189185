"""The CUDA intersection kernels against their plain PyTorch versions on
the card (the small-size twin of chip_smoke.py's kernel phase).

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
