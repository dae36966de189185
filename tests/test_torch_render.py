"""The slice as a whole: core_tpu's render_chunk (op by op, brute-force
intersector, on the CPU) against core_tpu_torch's render_chunk on the CPU,
on the same Cornell scene carried across by convert.py.

Tolerance: >= 99% of pixel channels within rtol 1e-4 / atol 1e-5, and the
image mean within 1e-4 relative.  Not bit-exact because XLA and torch
differ by ulps in sqrt/sin/cos and XLA:CPU contracts multiply-adds into
FMAs inside core_tpu's own jitted helpers, and an ulp can move a sample ray across a triangle edge or a shadow
boundary; besides, core_tpu's CPU any-hit is the division-based brute
force while the port's is the kernel's division-free test.
"""
import numpy as np
import pytest
import torch

from core_tpu import film as jfilm
from core_tpu.integrators.path import PathOptions as JPathOptions
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.render import render_chunk as j_render_chunk
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import cornell_box
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import (RenderOptions, render_chunk, render_image,
                                   scene_material_types)

torch.set_num_threads(1)
RES = 16
PATH = dict(path_samples=2, bounces=2, raydepth=2)


@pytest.fixture(scope="module")
def scenes():
    js = cornell_box(resx=RES, resy=RES, light_samples=2, intersector="brute")
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


# (aa_samples, spp in the chunk): one centred sample per pixel, and a
# two-sample chunk that exercises the stratified dx / RI_LP dy offsets and
# the per-sample splat loop
@pytest.mark.parametrize("aa,spp", [(1, 1), (2, 2)])
def test_render_chunk_matches_core_tpu(scenes, aa, spp):
    js, ts = scenes
    jopts = JRenderOptions(aa_samples=aa, integrator="pathtracing",
                           integrator_opts=JPathOptions(**PATH))
    topts = RenderOptions(aa_samples=aa, integrator="pathtracing",
                          integrator_opts=PathOptions(**PATH))
    # core_tpu runs op by op: XLA compiles a jitted render on several
    # threads, for about three times the CPU seconds
    jf = j_render_chunk(js, j_types(js), jopts, jfilm.make_film(RES, RES), 0,
                        spp, 0, None)
    j_rgba, j_weight = np.asarray(jf.rgba), np.asarray(jf.weight)
    with torch.no_grad():
        tf = render_chunk(ts, scene_material_types(ts), topts,
                          tfilm.make_film(RES, RES, device="cpu"), 0, spp, 0)
    np.testing.assert_array_equal(tf.weight.numpy(), j_weight)
    want = j_rgba / np.maximum(j_weight[..., None], 1e-10)
    got = tfilm.normalized(tf).numpy()
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close[..., :3].mean() >= 0.99, close[..., :3].mean()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    jm, tm = want[..., :3].mean(), got[..., :3].mean()
    assert abs(tm - jm) <= 1e-4 * abs(jm), (tm, jm)
    assert 0.1 < jm < 10.0


def test_render_image_is_chunked_render_chunk(scenes):
    """render_image's chunk loop + flush equals one render_chunk call."""
    _, ts = scenes
    opts = RenderOptions(aa_samples=2, spp_chunk=1, integrator="pathtracing",
                         integrator_opts=PathOptions(**PATH))
    img, film = render_image(ts, opts)
    with torch.no_grad():
        one = render_chunk(ts, scene_material_types(ts), opts,
                           tfilm.make_film(RES, RES, device="cpu"), 0, 2, 0)
    np.testing.assert_allclose(film.rgba.numpy(), one.rgba.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(img, tfilm.flush(film))
    assert img.shape == (RES, RES, 4) and not img.requires_grad
