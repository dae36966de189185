"""The port's Cornell renders on the card against the reference renderer's
goldens, at tests/test_golden_ref.py's scenes, options and bands.

- dl_pair (test_golden_ref.py:35-80): directlight, 64x64, light_samples=8,
  aa_samples=8 in chunks of 2, box filter of size 1.0, against
  tests/golden/dl_64x64_8spp_8ls.npz on the interior (2-pixel margin cut):
  mean within 2%, relative MAE below 4%, the 90% quantile of 8x8 block
  errors below 0.12, alpha within 0.02.
- pt_pair (test_golden_ref.py:113-155): path tracing, 64x64, light_samples
  16, path_samples=8, bounces=3, raydepth=5, aa_samples=4 in chunks of 2,
  against tests/golden/pt_256x256_16spp_ps8_b3.npz pooled 4x to 64x64:
  block Pearson r above 0.99, and the mean energy from -1% to +12% of the
  reference's (the reference's documented indirect deficit).

Numpy and torch only.  Marked `cuda`: the fixtures ask for a CUDA device
and skip without one, so these run on a GPU host with
    python -m pytest tests/test_torch_golden.py -m cuda --noconftest
"""
import os

import numpy as np
import pytest
import torch

from core_tpu_torch.film import FilterType
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import RenderOptions, render_image
from core_tpu_torch.scenes import cornell_box

pytestmark = pytest.mark.cuda

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    return np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return "cuda"


@pytest.fixture(scope="module")
def dl_pair(device):
    ref = _load("dl_64x64_8spp_8ls")
    scene = cornell_box(resx=64, resy=64, light_samples=8, with_blocks=True,
                        device=device)
    opts = RenderOptions(aa_samples=8, spp_chunk=2, filter_size=1.0,
                         filter_type=FilterType.BOX)
    img, _ = render_image(scene, opts)
    # the reference leaves an unsampled ~2 px filter margin at the border
    return img.cpu().numpy()[2:-2, 2:-2], ref[2:-2, 2:-2]


def test_directlight_matches_reference_mean(dl_pair):
    img, ref = dl_pair
    m, r = img[..., :3], ref[..., :3]
    assert abs(m.mean() - r.mean()) / r.mean() < 0.02, (m.mean(), r.mean())


def test_directlight_matches_reference_pixels(dl_pair):
    img, ref = dl_pair
    m, r = img[..., :3], ref[..., :3]
    rel_mae = np.abs(m - r).mean() / r.mean()
    assert rel_mae < 0.04, rel_mae


def test_directlight_matches_reference_blocks(dl_pair):
    img, ref = dl_pair
    m = img[:56, :56, :3].reshape(8, 7, 8, 7, 3).mean(axis=(1, 3, 4))
    r = ref[:56, :56, :3].reshape(8, 7, 8, 7, 3).mean(axis=(1, 3, 4))
    rel = np.abs(m - r) / np.maximum(r, 0.05)
    assert np.quantile(rel, 0.9) < 0.12, np.quantile(rel, 0.9)


def test_directlight_alpha_matches(dl_pair):
    img, ref = dl_pair
    np.testing.assert_allclose(img[..., 3], ref[..., 3], atol=0.02)


@pytest.fixture(scope="module")
def pt_pair(device):
    ref = _load("pt_256x256_16spp_ps8_b3")[..., :3]
    ref = ref.reshape(64, 4, 64, 4, 3).mean((1, 3))
    scene = cornell_box(resx=64, resy=64, light_samples=16, device=device)
    opts = RenderOptions(
        integrator="pathtracing",
        integrator_opts=PathOptions(path_samples=8, bounces=3, raydepth=5),
        aa_samples=4, spp_chunk=2, filter_size=1.0,
        filter_type=FilterType.BOX)
    img, _ = render_image(scene, opts)
    return img.cpu().numpy()[2:-2, 2:-2, :3], ref[2:-2, 2:-2]


def test_pathtracer_matches_reference_structure(pt_pair):
    a, b = pt_pair
    ba = a[:56, :56].reshape(7, 8, 7, 8, 3).mean((1, 3)).ravel()
    bb = b[:56, :56].reshape(7, 8, 7, 8, 3).mean((1, 3)).ravel()
    r = np.corrcoef(ba, bb)[0, 1]
    assert r > 0.99, f"block Pearson {r}"


def test_pathtracer_energy_vs_reference(pt_pair):
    a, b = pt_pair
    rel = (a.mean() - b.mean()) / b.mean()
    assert -0.01 <= rel <= 0.12, f"pt energy rel diff {rel}"
