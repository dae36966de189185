"""The dirac lights and kernel 3 against core_tpu on the same numpy inputs.

- Kernel 3's plain version (isect.any_hit_torch) against core_tpu's
  any_hit_pallas_s with its Pallas kernel in interpret mode: the Cornell
  geometry and 2,048 rays made with numpy from a seed, with two exclusion
  ids, open, bounded and dead caps; identical occlusion bits.
- The point, spot and directional (infinite and cylinder) lights'
  illuminate_s against core_tpu's illuminate on the same shading points,
  within rtol 1e-5 / atol 1e-6 (ulps of sqrt and of XLA's reductions).
- The dirac variant of mesh_scene, built in each package by the same
  builder calls (mesh_scene's textures, materials, terrain, torus and
  camera; the background without IBL; scenes.DIRAC_LIGHTS for the sun) at
  n_grid=24, torus 24x12 (1,634 triangles, the brute path): leaf by leaf
  through convert.scene_to_numpy, then one 32x32 directlight render_chunk
  with raydepth=1 against core_tpu's, run eagerly as
  tests/test_torch_mesh_scene.py runs it.  The render is held at that
  test's tolerance: >= 99% of pixel channels within rtol 1e-4 / atol 1e-5,
  the image mean within 1e-5 relative.  It is not bit-exact: XLA and torch
  differ by ulps in sqrt and the textures' transcendentals, and core_tpu's
  CPU any-hit is the division-based brute force, the port's the kernel's
  division-free test.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from core_tpu import film as jfilm
from core_tpu import vec as jvec
from core_tpu.cameras import make_perspective as j_make_perspective
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.geometry import pallas_intersect as pk
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.lights import base as jlights
from core_tpu.lights.point import make_point_light as j_point
from core_tpu.lights.spot import make_spot_light as j_spot
from core_tpu.lights.sun import make_directional_light as j_directional
from core_tpu.params import ParamMap as JParamMap
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.render import render_chunk as j_render_chunk
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import _grid_mesh as j_grid_mesh
from core_tpu.scenes import _torus_mesh as j_torus_mesh
from core_tpu.scenes import cornell_box
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import vec as tvec
from core_tpu_torch.geometry import cuda_intersect as ck
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.lights import base as tlights
from core_tpu_torch.lights.point import make_point_light
from core_tpu_torch.lights.spot import make_spot_light
from core_tpu_torch.lights.sun import make_directional_light
from core_tpu_torch.render import RenderOptions, render_chunk, \
    scene_material_types
from core_tpu_torch.scenes import DIRAC_LIGHTS, add_dirac_lights, \
    mesh_builder

torch.set_num_threads(1)
N = 2048
RES = 32
SMALL = dict(n_grid=24, torus_u=24, torus_v=12)


def test_any_hit_matches_pallas():
    g = cornell_box(resx=8, resy=8, light_samples=1, intersector="brute").geom
    tri = isect.pack_tris(torch.from_numpy(np.array(g.verts)),
                          torch.from_numpy(np.array(g.tri_vidx)))
    rng = np.random.default_rng(21)
    o = rng.uniform([10, 10, 10], [546, 538, 549], (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.choice(np.array([-1.0, 2.5e-4, 60.0, 250.0], np.float32), N)
    tmin = np.full(N, 5e-4, np.float32)
    ex0 = rng.integers(-2, g.n_tris, N).astype(np.int32)
    ex1 = rng.integers(-2, g.n_tris, N).astype(np.int32)
    want = np.asarray(pk.any_hit_pallas_s(
        g, jvec.RaysS(o=jvec.v3(jnp.asarray(o)), d=jvec.v3(jnp.asarray(d)),
                      tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)),
        exclude_prim=jnp.asarray(ex0), exclude_prim2=jnp.asarray(ex1),
        interpret=True))
    rays = tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                      d=tvec.v3(torch.from_numpy(d)),
                      tmin=torch.from_numpy(tmin),
                      tmax=torch.from_numpy(tmax))
    got = isect.any_hit_torch(tri, rays, torch.from_numpy(ex0),
                              torch.from_numpy(ex1))
    assert got.dtype == torch.bool and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.8
    assert not want[tmax == np.float32(2.5e-4)].any()
    # on CPU tensors the kernel's wrapper is the plain version
    assert torch.equal(ck.any_hit_cuda(tri, rays, torch.from_numpy(ex0),
                                       torch.from_numpy(ex1)), got)


_LIGHTS = {
    "point": (lambda: j_point((2.0, 3.5, -2.0), (1.0, 0.9, 0.8), 12.0),
              lambda: make_point_light((2.0, 3.5, -2.0), (1.0, 0.9, 0.8),
                                       12.0, device="cpu")),
    "spot": (lambda: j_spot((-2.5, 4.0, -1.5), (0.0, 1.2, 0.0),
                            (1.0, 1.0, 0.9), 20.0, cone_angle=35.0,
                            falloff=0.15),
             lambda: make_spot_light((-2.5, 4.0, -1.5), (0.0, 1.2, 0.0),
                                     (1.0, 1.0, 0.9), 20.0, cone_angle=35.0,
                                     falloff=0.15, device="cpu")),
    "directional": (lambda: j_directional((0.45, 0.8, 0.3), (1, 1, 1), 1.2),
                    lambda: make_directional_light(
                        (0.45, 0.8, 0.3), (1, 1, 1), 1.2, device="cpu")),
    "cylinder": (lambda: j_directional((0.45, 0.8, 0.3), (1, 1, 1), 1.2,
                                       infinite=False, pos=(0.5, 4.0, 0.2),
                                       radius=2.5),
                 lambda: make_directional_light(
                     (0.45, 0.8, 0.3), (1, 1, 1), 1.2, infinite=False,
                     pos=(0.5, 4.0, 0.2), radius=2.5, device="cpu")),
}


@pytest.mark.parametrize("kind", list(_LIGHTS))
def test_illuminate_matches_core_tpu(kind):
    jl, tl = (make() for make in _LIGHTS[kind])
    p = np.random.default_rng(len(kind)).uniform(
        [-6.0, -0.5, -6.0], [6.0, 3.0, 6.0], (N, 3)).astype(np.float32)
    want = jlights.illuminate(jl, SimpleNamespace(p=jnp.asarray(p)))
    got = tlights.illuminate_s(tl, SimpleNamespace(
        p=tvec.v3(torch.from_numpy(p))))
    assert tlights.dirac(tl) and not tlights.can_intersect(tl)
    assert tlights.n_samples(tl) == 1
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for f in ("dist", "pdf"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **tol,
                                   err_msg=f)
    for f in ("wi", "col"):
        v = getattr(got, f)
        np.testing.assert_allclose(
            np.broadcast_to(np.stack([np.asarray(c) for c in v], -1),
                            (N, 3)), np.asarray(getattr(want, f)), **tol,
            err_msg=f)
    valid = np.asarray(want.valid)
    if kind in ("spot", "cylinder"):
        assert 0.05 < valid.mean() < 0.95     # both sides of the boundary
    else:
        assert valid.all()


def _j_dirac_scene():
    """core_tpu's dirac variant: mesh_scene's builder calls
    (core_tpu/scenes.py:260-301) with the background's ibl off and
    DIRAC_LIGHTS for the sun."""
    b = JSceneBuilder()
    b.create("texture", "rockmarble", JParamMap({
        "type": "marble", "color1": (0.22, 0.18, 0.14),
        "color2": (0.75, 0.7, 0.62), "size": 2.3, "depth": 3,
        "turbulence": 4.0, "sharpness": 2.0, "noise_type": "newperlin"}))
    b.create("texture", "cellvor", JParamMap({
        "type": "voronoi", "color1": (0.05, 0.12, 0.3),
        "color2": (0.9, 0.85, 0.6), "size": 1.4, "pattern": "f2f1",
        "intensity": 1.6}))
    b.create("texture", "skytex", JParamMap({
        "type": "clouds", "color1": (0.25, 0.45, 0.9),
        "color2": (1.0, 0.98, 0.92), "size": 0.8, "depth": 3,
        "noise_type": "stdperlin"}))
    b.create("material", "terrain", JParamMap({
        "type": "shinydiffusemat", "color": (0.7, 0.7, 0.7),
        "diffuse_reflect": 0.9, "diffuse_shader": "rockmarble"}))
    b.create("material", "torus", JParamMap({
        "type": "glossy", "diffuse_color": (0.4, 0.4, 0.45),
        "color": (0.7, 0.7, 0.75), "glossy_reflect": 0.35,
        "exponent": 80.0, "as_diffuse": False,
        "diffuse_shader": "cellvor"}))
    m = b.assembler.start_mesh()
    j_grid_mesh(b.assembler, m, SMALL["n_grid"], 6.0,
                b.material_index("terrain"))
    b.assembler.smooth_mesh(m, 80.0)
    m2 = b.assembler.start_mesh()
    j_torus_mesh(b.assembler, m2, SMALL["torus_u"], SMALL["torus_v"], 1.5,
                 0.55, (0.0, 1.6, 0.0), b.material_index("torus"))
    b.assembler.smooth_mesh(m2, 80.0)
    b.create("background", "world", JParamMap({
        "type": "textureback", "texture": "skytex", "ibl": False,
        "power": 1.0}))
    for name, params in DIRAC_LIGHTS:
        b.create("light", name, JParamMap(params))
    b.camera = j_make_perspective(pos=(5.2, 3.4, -5.6), look=(0.0, 1.2, 0.0),
                                  up=(5.2, 4.4, -5.6), resx=RES, resy=RES,
                                  focal=1.25)
    return b.compile_scene()


@pytest.fixture(scope="module")
def scenes():
    b = mesh_builder(RES, RES, **SMALL, device="cpu")
    return _j_dirac_scene(), add_dirac_lights(b).compile_scene()


def test_dirac_scene_equals_core_tpu_leaf_by_leaf(scenes):
    js, ts = scenes
    assert ts.accel is None and ts.geom.n_tris == 1634     # brute path
    jl, jst = convert.scene_to_numpy(js)
    tl, tst = convert.scene_to_numpy(ts)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)
    assert jst == tst
    assert [ls["type"] for ls in tst["lights"]] == \
        ["PointLight", "SpotLight", "DirectionalLight"]
    assert not tst["background"]["ibl"]
    back = convert.scene_from_numpy(jl, jst, device="cpu")
    assert [type(x) for x in back.lights] == [type(x) for x in ts.lights]


def test_directlight_render_chunk_matches_core_tpu(scenes):
    js, ts = scenes
    jopts = JRenderOptions(aa_samples=1, integrator="directlight",
                           integrator_opts=JDirectOptions(raydepth=1))
    jf = j_render_chunk(js, j_types(js), jopts, jfilm.make_film(RES, RES),
                        0, 1, 0, None)
    want = np.asarray(jf.rgba) / np.maximum(np.asarray(jf.weight)[..., None],
                                            1e-10)
    topts = RenderOptions(aa_samples=1, integrator="directlight",
                          integrator_opts=DirectOptions(raydepth=1))
    ck.reset_counts()
    with torch.no_grad():
        tf = render_chunk(ts, scene_material_types(ts), topts,
                          tfilm.make_film(RES, RES, device="cpu"), 0, 1, 0)
    # one shadow wavefront per dirac light at the camera hit and at the
    # glossy-chain hit, through kernel 3's plain version
    assert isect.any_hit_torch.calls == 6
    assert isect.any_hit_nee_torch.calls == 0
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    got = tfilm.normalized(tf).numpy()
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close[..., :3].mean() >= 0.99, close[..., :3].mean()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    jm, tm = want[..., :3].mean(), got[..., :3].mean()
    assert abs(tm - jm) <= 1e-5 * abs(jm), (tm, jm)
    # lit terrain and torus, the sky in the top rows
    assert jm > 0.05 and want[:4, :, 2].mean() > 0.05
