"""The mesh zoo (scenes.MESH_ZOO: mesh_scene with its materials swapped for
the procedural textures, a layer and a mix node, bump mapping and a coated
anisotropic glossy) against core_tpu.

Both packages' SceneBuilders take the same plain data through
chip_smoke.zoo_builder, at 16x16 with a 12 x 12 grid and a 12 x 8 torus
(434 triangles: the brute path), ibl_samples=1 and sun_samples=1.

- The scene leaf by leaf through convert.scene_to_numpy, its bglight CDFs
  at rtol 1e-5 / atol 1e-6 (atan2 and acos differ by an ulp between XLA
  and torch), the rest exactly, and the static settings (texture defs,
  node programs with the bump_shader) equal.
- surface_points_s with the bump against core_tpu's surface_points on the
  256 pixel-centre camera hits (the same hits on both sides): every field
  within rtol 1e-5 / atol 1e-6, and the bump moves the terrain's normals.
- direct.integrate on those camera rays at raydepth 3, so the coat's
  mirror reflection recurses, against core_tpu's integrate at
  test_torch_mesh_scene.py's tolerances: >= 99% of channels within
  rtol 1e-4 / atol 1e-5, the mean within 1e-5 relative, alpha equal.
- The port's directlight fwd+bwd at 16x16 over extract_params(geometry=
  False): finite, the coated torus row's mirror_color gradient nonzero,
  and its glossy_color gradient exactly zero (the glossy_shader node
  replaces the colour on every torus hit, in core_tpu as here).

core_tpu's side (scene build, surface points, integrate) runs eagerly, op
by op, once per run (test_torch_diff.once_per_run; see _core_tpu_side).
"""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import core_tpu.scenes as j_scenes
from core_tpu import scene as jscene
from core_tpu.cameras import make_perspective as j_make_perspective
from core_tpu.cameras import shoot_ray as j_shoot_ray
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.integrators import direct as j_direct
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.params import ParamMap as JParamMap
from core_tpu.render import scene_material_types as j_types
from core_tpu.sampling import qmc as jqmc
from core_tpu.textures.base import TexType as JTexType
from core_tpu.textures.base import TextureDef as JTextureDef
from core_tpu.types import Hits as JHits
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert, diff
from core_tpu_torch import scene as tscene
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.integrators import direct
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.render import RenderOptions, scene_material_types
from core_tpu_torch.types import Hits, Rays
from core_tpu_torch.vec import rays_to_soa

from chip_smoke import zoo_builder, zoo_scene
from test_torch_diff import once_per_run

torch.set_num_threads(1)
RES = 16
N = RES * RES
SMALL = dict(grid=12, torus=(12, 8), ibl_samples=1, sun_samples=1)
TOL = dict(rtol=1e-5, atol=1e-6)
RAYDEPTH = 3


def _jsonable(static) -> str:
    return json.dumps(static, sort_keys=True)


def _pixel_centres():
    """(px, py, pixel_sample, sampling_offs) of a RES^2 1-spp chunk's camera
    rays, as render_chunk makes them (the pixel centres, sample 0)."""
    y, x = (a.ravel().astype(np.uint64) for a in np.mgrid[0:RES, 0:RES])
    offs = jqmc.fnv32a(jnp.asarray(y.astype(np.uint32)) * jqmc.fnv32a(
        jnp.asarray(x.astype(np.uint32))))
    return (x.astype(np.float32) + 0.5, y.astype(np.float32) + 0.5,
            np.zeros(x.shape, np.int32), np.asarray(offs))


def _camera_hits(ts):
    """The port's pixel-centre camera rays and their closest hits (the
    plain version), as numpy; both packages shade these same hits."""
    px, py = (torch.from_numpy(a) for a in _pixel_centres()[:2])
    rays, _ = shoot_ray(ts.camera, px, py)
    hits = tscene.closest_hit_s(ts, rays_to_soa(rays))
    return {"o": rays.o.numpy(), "d": rays.d.numpy(),
            **{f"hit_{f}": getattr(hits, f).numpy()
               for f in ("t", "prim", "u", "v")}}


def _core_tpu_side(ts) -> dict:
    """core_tpu's zoo from the same data, its leaves and static settings,
    its surface points (with the bump) at the port's camera hits and its
    directlight integrate on the pixel-centre rays, as numpy.  All of it
    runs op by op, each primitive compiled alone (a third faster than
    under jax.disable_jit here; as test_torch_image_nodes.py builds its
    scene): XLA can then contract multiply-adds only inside jnp's own
    jitted helpers (jnp.cross), none of which feeds a noise cell's floor;
    the surface points are held at rtol 1e-5 and the integrate at a 99%
    bar."""
    js = zoo_builder(JSceneBuilder(), JParamMap, JTextureDef, JTexType,
                     j_scenes, j_make_perspective, RES,
                     **SMALL).compile_scene()
    leaves, static = convert.scene_to_numpy(js)
    out = {f"leaf:{k}": v for k, v in leaves.items()}
    out["static"] = np.array(_jsonable(static))
    ins = _camera_hits(ts)
    rays = JRays(jnp.asarray(ins["o"]), jnp.asarray(ins["d"]),
                 jnp.zeros(N, jnp.float32), jnp.full(N, -1.0, jnp.float32))
    hits = JHits(*[jnp.asarray(ins[f"hit_{f}"])
                   for f in ("t", "prim", "u", "v")])
    sp = jscene.surface_points(js, rays, hits)
    for f in ("p", "n", "ng", "nu", "nv", "uv", "mat"):
        out[f"sp:{f}"] = np.asarray(getattr(sp, f))
    px, py, ps, offs = (jnp.asarray(a) for a in _pixel_centres())
    cam, _ = j_shoot_ray(js.camera, px, py)
    out["integrate"] = np.asarray(j_direct.integrate(
        js, j_types(js), cam, ps, offs, JDirectOptions(raydepth=RAYDEPTH)))
    return out


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """(core_tpu's numpy results, once per run; the port's scene)."""
    ts = zoo_scene(RES, device="cpu", **SMALL)
    core, by = once_per_run(tmp_path_factory, "torch_zoo_core",
                            lambda: _core_tpu_side(ts))
    print(f"zoo: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return core, ts


def test_zoo_equals_core_tpu_leaf_by_leaf(zoo):
    core, ts = zoo
    tl, tst = convert.scene_to_numpy(ts)
    jl = {k[5:]: v for k, v in core.items() if k.startswith("leaf:")}
    assert jl.keys() == tl.keys()
    cdfs = {f"lights.1.{f}" for f in ("u_pdf", "u_cdf", "v_pdf", "v_cdf")}
    assert cdfs <= jl.keys()
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        if k in cdfs:
            np.testing.assert_allclose(tl[k], jl[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert _jsonable(tst) == str(core["static"])
    assert ts.geom.n_tris == 434 and ts.accel is None
    assert [p[:2] for p in tst["node_programs"]] == [
        (0, "diffuse_shader"), (0, "bump_shader"), (1, "diffuse_shader"),
        (1, "glossy_shader")]
    types = [t["ttype"] for t in tst["textures"]]
    assert sorted(set(types)) == [0, 2, 3, 4, 5, 6, 7]


def _surface_points(ts):
    ins = _camera_hits(ts)
    rays = rays_to_soa(Rays(torch.from_numpy(ins["o"]),
                            torch.from_numpy(ins["d"]), torch.zeros(N),
                            torch.full((N,), -1.0)))
    hits = Hits(*[torch.from_numpy(ins[f"hit_{f}"])
                  for f in ("t", "prim", "u", "v")])
    with torch.no_grad():
        return tscene.surface_points_s(ts, rays, hits), ins["hit_prim"] >= 0


def test_bumped_surface_points_match_core_tpu(zoo):
    core, ts = zoo
    sp, valid = _surface_points(ts)
    assert valid.mean() > 0.5
    for f in ("p", "n", "ng", "nu", "nv"):
        got = np.stack([c.numpy() for c in getattr(sp, f)], -1)
        np.testing.assert_allclose(got[valid], core[f"sp:{f}"][valid],
                                   err_msg=f, **TOL)
    uv = np.stack([sp.u.numpy(), sp.v.numpy()], -1)
    np.testing.assert_allclose(uv[valid], core["sp:uv"][valid], **TOL)
    np.testing.assert_array_equal(sp.mat.numpy(), core["sp:mat"])
    # both materials are hit; the bump rebuilds the terrain's frames only
    # (its cell noise is flat but at cell edges, where the normal tilts)
    mat = core["sp:mat"][valid]
    assert (mat == 0).sum() > 20 and (mat == 1).sum() > 20
    flat, _ = _surface_points(dataclasses.replace(ts, node_programs=tuple(
        p for p in ts.node_programs if p[1] != "bump_shader")))
    terrain = core["sp:mat"] == 0
    moved = np.abs(np.stack([c.numpy() for c in sp.n], -1)
                   - np.stack([c.numpy() for c in flat.n], -1)).max(-1)
    assert (moved[valid & terrain] > 0.1).any()
    np.testing.assert_array_equal(moved[~terrain], 0.0)


def test_directlight_integrate_matches_core_tpu(zoo):
    core, ts = zoo
    px, py, ps, offs = (torch.from_numpy(a.astype(np.int64)
                                         if a.dtype != np.float32 else a)
                        for a in _pixel_centres())
    rays, _ = shoot_ray(ts.camera, px, py)
    with torch.no_grad():
        got = direct.integrate(ts, scene_material_types(ts), rays, ps, offs,
                               DirectOptions(raydepth=RAYDEPTH))
    got, want = got.numpy(), core["integrate"]
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close[:, :3].mean() >= 0.99, close[:, :3].mean()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    jm, tm = want[:, :3].mean(), got[:, :3].mean()
    assert abs(tm - jm) <= 1e-5 * abs(jm), (tm, jm)
    assert want[:, :3].std() > 0.01


def test_zoo_dl_gradient_reaches_the_coat():
    """The port's directlight fwd+bwd through the bump, the nodes and the
    coat's reflection chain: finite gradients; the coated torus row's
    mirror_color gradient nonzero (the coat's reflection, Kr x
    mirror_color); its glossy_color gradient zero, since the glossy_shader
    node replaces that colour on every torus hit."""
    ts = zoo_scene(RES, device="cpu", **SMALL)
    opts = RenderOptions(aa_samples=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=RAYDEPTH))
    loss, grads = diff.value_and_grad_fn(ts, opts, 1, torch.zeros(
        RES, RES, 4))(diff.extract_params(ts, geometry=False))
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    torus = 1
    assert (grads["mat.mirror_color"][torus].abs() > 0).all()
    assert (grads["mat.glossy_color"][torus] == 0).all()
    assert (grads["mat.glossy_reflect"][torus].abs() > 0).all()
