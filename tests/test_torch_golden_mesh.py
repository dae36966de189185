"""The port's golden mesh + IBL renders on the card against the reference
renderer's goldens, at tests/test_golden_mesh_ibl.py's scene, options and
bands.

golden_mesh_scene(128, 128, ibl_samples=8): a torus and a ground quad with
checker.tga through texture_mapper(texco=uv) nodes, lit only by a sky.tga
textureback with ibl=True; aa_samples=16 in chunks of 2, box filter 1.0;
each image and golden cut by a 2-pixel margin:
- ms_dl_pair (test_golden_mesh_ibl.py:48-90): directlight raydepth=3
  against ms_dl_128x128_16spp_ibl8.npz: the sky pixels' mean within 0.5%
  and their mean absolute error below 1%; the hit pixels' energy from 0 to
  +15% of the reference's (the reference's grazing self-shadow deficit);
  12 x 12 block Pearson r above 0.998;
- pt (:92-108): path tracing (path_samples=4, bounces=2, raydepth=3)
  against ms_pt_128x128_16spp_ps4_b2.npz: the hit pixels' energy from 0 to
  +18%, block Pearson r above 0.995.

Numpy and torch only.  The golden tests are marked `cuda`: their fixtures
ask for a CUDA device and skip without one, so they run on a GPU host with
    python -m pytest tests/test_torch_golden_mesh.py -m cuda --noconftest -s
(-s shows the value each test measured beside its band).  The last test is
a CPU one: the background's texture set reads the sky at its own slot 0.
"""
import os

import numpy as np
import pytest
import torch

from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.film import FilterType
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import RenderOptions, render_image
from core_tpu_torch.scenes import golden_mesh_scene
from core_tpu_torch.textures.base import eval_texture_def
from core_tpu_torch.vec import V3

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    return np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return "cuda"


def _render(device, integrator, iopts):
    scene = golden_mesh_scene(resx=128, resy=128, ibl_samples=8,
                              device=device)
    opts = RenderOptions(integrator=integrator, aa_samples=16, spp_chunk=2,
                         filter_size=1.0, filter_type=FilterType.BOX,
                         integrator_opts=iopts)
    img, _ = render_image(scene, opts)
    return img.cpu().numpy()


def _pearson(img, ref):
    bm = img[:120, :120, :3].reshape(12, 10, 12, 10, 3).mean((1, 3, 4))
    br = ref[:120, :120, :3].reshape(12, 10, 12, 10, 3).mean((1, 3, 4))
    return np.corrcoef(bm.ravel(), br.ravel())[0, 1]


def _energy(img, ref):
    hit = ref[..., 3] > 0.5
    return (img[hit][:, :3].mean() - ref[hit][:, :3].mean()) \
        / ref[hit][:, :3].mean()


@pytest.fixture(scope="module")
def ms_dl_pair(device):
    ref = _load("ms_dl_128x128_16spp_ibl8")
    img = _render(device, "directlight", DirectOptions(raydepth=3))
    return img[2:-2, 2:-2], ref[2:-2, 2:-2]


@pytest.mark.cuda
def test_ms_sky_region_matches(ms_dl_pair):
    img, ref = ms_dl_pair
    sky = ref[..., 3] < 0.5
    assert sky.sum() > 500
    m, r = img[sky][:, :3], ref[sky][:, :3]
    rel = abs(m.mean() - r.mean()) / r.mean()
    mae = np.abs(m - r).mean() / r.mean()
    print("sky mean rel", rel, "(< 0.005), mae rel", mae, "(< 0.01)")
    assert rel < 0.005, rel
    assert mae < 0.01, mae


@pytest.mark.cuda
def test_ms_directlight_geometry_energy(ms_dl_pair):
    rel = _energy(*ms_dl_pair)
    print("dl energy rel", rel, "(in [0, 0.15])")
    assert 0.0 <= rel <= 0.15, rel


@pytest.mark.cuda
def test_ms_directlight_structure(ms_dl_pair):
    rr = _pearson(*ms_dl_pair)
    print("dl block pearson", rr, "(> 0.998)")
    assert rr > 0.998, rr


@pytest.mark.cuda
def test_ms_pathtracing_matches(device):
    ref = _load("ms_pt_128x128_16spp_ps4_b2")
    img = _render(device, "pathtracing",
                  PathOptions(path_samples=4, bounces=2, raydepth=3))
    img, ref = img[2:-2, 2:-2], ref[2:-2, 2:-2]
    rel, rr = _energy(img, ref), _pearson(img, ref)
    print("pt energy rel", rel, "(in [0, 0.18]), block pearson", rr,
          "(> 0.995)")
    assert 0.0 <= rel <= 0.18, rel
    assert rr > 0.995, rr


def test_background_set_reads_the_sky_at_its_own_slot():
    """The textureback's own one-image set keeps the sky at slot 0, though
    compile_scene puts the same def at slot 1 of the scene's set (core_tpu
    re-stamps that slot on the shared def and reads a one-slot atlas at
    index 1, which only XLA's clamped gather turns into the sky)."""
    scene = golden_mesh_scene(resx=8, resy=8, ibl_samples=1, device="cpu")
    bg, tex = scene.background, scene.textures
    sky = bg.ctex.defs[0]
    assert sky is tex.defs[1]                    # one def, two sets
    assert bg.ctex.slots == (0,) and tex.slots == (0, 1)
    assert bg.ctex.atlas.shape == (1, 128, 256, 4)
    assert tex.atlas.shape == (2, 256, 256, 4)
    g = torch.Generator().manual_seed(3)
    d = V3(*(c.contiguous() for c in torch.nn.functional.normalize(
        torch.randn(512, 3, generator=g), dim=1).unbind(1)))
    got = eval_background_s(bg, d)
    # the same sky through the scene's set, at its slot there
    u = torch.remainder(torch.atan2(d.y, d.x) / (2.0 * np.pi), 1.0)
    v = 1.0 - torch.acos(d.z.clamp(-1.0, 1.0)) / np.pi
    want, _ = eval_texture_def(tex, 1, d, (u, v))
    for a, b in zip(got, want):
        assert torch.equal(a, b * bg.power)
    checker, _ = eval_texture_def(tex, 0, d, (u, v))
    assert not torch.equal(got.x, checker.x * bg.power)
