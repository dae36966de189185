"""The light zoo (scenes.LIGHT_ZOO: mesh_scene's geometry with an emitter
panel and a portal quad, lit by a sphere, a mesh, an IES and a portal
light under a darksky with its sun and background light, seen through a
hexagonal thin lens, splatted with a Gauss filter) against core_tpu.

Both packages' SceneBuilders take the same plain data through
chip_smoke.light_zoo_builder, at 16x16 with a 12 x 12 grid, a 12 x 8
torus and a one-quad panel (438 triangles: the brute path) and one sample
per light.

- The scene leaf by leaf through convert.scene_to_numpy (the bglight CDFs
  within rtol 1e-5 / atol 1e-6, atan2 and acos differ by an ulp between
  XLA and torch; the rest exactly) and its static settings equal.
- One 1-spp 16x16 render_chunk, direct-lit (raydepth 1) and path-traced
  (path_samples=1, bounces=1, raydepth=1), against core_tpu's run op by
  op, at
  test_torch_mesh_scene.py's tolerances: the film weights equal (the
  Gauss splat of the same offsets), >= 99% of channels within rtol 1e-4 /
  atol 1e-5, the mean within 1e-5 relative, alpha equal.  Not bit-exact:
  core_tpu's jitted radical inverse contracts the lens's base-5 digits
  into FMAs, and XLA and torch differ by ulps in sqrt, acos and exp.
The card's twin (the 64x64 light zoo through the kernels and through the
plain versions, identical) is in tests/test_torch_kernels_cuda.py, which
imports no jax.

core_tpu's side (scene build and both renders) runs once per run
(test_torch_diff.once_per_run).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import core_tpu.scenes as j_scenes
from core_tpu import film as jfilm
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.film import FilterType as JFilterType
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.integrators.path import PathOptions as JPathOptions
from core_tpu.params import ParamMap as JParamMap
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.render import render_chunk as j_render_chunk
from core_tpu.render import scene_material_types as j_types
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch.film import FilterType
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import (RenderOptions, render_chunk,
                                   scene_material_types)

from chip_smoke import light_zoo_builder, light_zoo_scene
from test_torch_diff import once_per_run

torch.set_num_threads(1)
RES = 16
SMALL = dict(grid=12, torus=(12, 8), samples=1, panel=1)
TOL = dict(rtol=1e-5, atol=1e-6)
# (integrator, its options' fields): shallow, one sample a light
CONFIGS = {"dl": ("directlight", dict(raydepth=1)),
           "pt": ("pathtracing", dict(path_samples=1, bounces=1,
                                      raydepth=1))}
FILM = dict(filter_type="GAUSS", filter_size=1.5)


def _jsonable(static) -> str:
    return json.dumps(static, sort_keys=True, default=str)


def _core_tpu_side() -> dict:
    """core_tpu's light zoo from the same data: its leaves and static
    settings and both 1-spp chunks' films, as numpy."""
    js = light_zoo_builder(JSceneBuilder(), JParamMap, j_scenes, RES,
                           **SMALL).compile_scene()
    leaves, static = convert.scene_to_numpy(js)
    out = {f"leaf:{k}": v for k, v in leaves.items()}
    out["static"] = np.array(_jsonable(static))
    for kind, (integ, fields) in CONFIGS.items():
        iopts = (JPathOptions if kind == "pt" else JDirectOptions)(**fields)
        film = j_render_chunk(js, j_types(js), JRenderOptions(
            integrator=integ, integrator_opts=iopts,
            filter_type=JFilterType[FILM["filter_type"]],
            filter_size=FILM["filter_size"]), jfilm.make_film(RES, RES), 0,
            1, 0, None)
        out[f"{kind}:rgba"] = np.asarray(film.rgba)
        out[f"{kind}:weight"] = np.asarray(film.weight)
    return out


def _opts(kind):
    integ, fields = CONFIGS[kind]
    return RenderOptions(integrator=integ, integrator_opts=(
        PathOptions if kind == "pt" else DirectOptions)(**fields),
        filter_type=FilterType[FILM["filter_type"]],
        filter_size=FILM["filter_size"])


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """(core_tpu's numpy results, once per run; the port's scene)."""
    ts = light_zoo_scene(RES, device="cpu", **SMALL)
    core, by = once_per_run(tmp_path_factory, "torch_light_zoo_core",
                            _core_tpu_side)
    print(f"light zoo: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return core, ts


def test_light_zoo_equals_core_tpu_leaf_by_leaf(zoo):
    core, ts = zoo
    tl, tst = convert.scene_to_numpy(ts)
    jl = {k[5:]: v for k, v in core.items() if k.startswith("leaf:")}
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        if ".u_" in k or ".v_" in k:
            np.testing.assert_allclose(tl[k], jl[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert _jsonable(tst) == str(core["static"])
    assert ts.geom.n_tris == 438 and ts.accel is None
    assert [type(x).__name__ for x in ts.lights] == [
        "SunLight", "SphereLight", "IesLight", "BgLight", "MeshLight",
        "BgPortalLight"]
    assert tst["background"]["type"] == "DarkSkyBackground"
    assert tst["camera"]["aperture"] > 0 and tst["camera"]["bokeh_type"] == 6


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_light_zoo_render_chunk_matches_core_tpu(zoo, kind):
    core, ts = zoo
    with torch.no_grad():
        tf = render_chunk(ts, scene_material_types(ts), _opts(kind),
                          tfilm.make_film(RES, RES, device="cpu"), 0, 1, 0)
    np.testing.assert_array_equal(tf.weight.numpy(), core[f"{kind}:weight"])
    want = core[f"{kind}:rgba"] / np.maximum(
        core[f"{kind}:weight"][..., None], 1e-10)
    got = tfilm.normalized(tf).numpy()
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close[..., :3].mean() >= 0.99, close[..., :3].mean()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    jm, tm = want[..., :3].mean(), got[..., :3].mean()
    assert abs(tm - jm) <= 1e-5 * abs(jm), (tm, jm)
    assert want[..., :3].std() > 0.01
