"""The path tracer's background terms and the default integrator, against
core_tpu, without a core_tpu render.

core_tpu's path tracer adds the background where a camera ray misses
(core_tpu/integrators/path.py:372-374) and, on a later bounce, where a path
escapes after a caustic (specular or glossy) bounce (:243-246).  The scene
is mesh_scene at 16^2 with a small terrain and torus (128 + 64 triangles,
brute path), under its clouds background; its torus is glossy, so paths
that reach it at their second vertex take caustic bounces.

- Primary misses: the port's path tracer gives exactly the port's
  eval_background_s of the camera directions there, and that function
  matches core_tpu's _eval_background_s on the same numpy directions
  within rtol 1e-5 / atol 1e-6 (ulp-level differences of the clouds noise
  between XLA and torch, as in test_torch_mesh_scene).
- Caustic escapes: the indirect paths (_paths_batched, bounces=2) of both
  packages on the same camera hits, eagerly on 256 pixels x 4 paths.  The
  tolerance is test_torch_render's path-tracing one (>= 99% of channels
  within rtol 1e-4 / atol 1e-5: XLA:CPU contracts multiply-adds into FMAs,
  and glossy raises a cosine to the 80th power), applied both to all
  pixels and to the pixels that the escape term changes.
- RenderOptions() names the same integrator, with options of the same type
  name, in both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from core_tpu import scene as jscene_mod
from core_tpu import vec as jvec
from core_tpu.integrators import path as jpath
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import mesh_scene as j_mesh_scene
from core_tpu_torch import scene as tscene_mod
from core_tpu_torch import vec as tvec
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.materials.base import BSDF
from core_tpu_torch.render import RenderOptions, scene_material_types
from core_tpu_torch.sampling import qmc
from core_tpu_torch.scenes import mesh_scene

torch.set_num_threads(1)
RES = 16
SMALL = dict(resx=RES, resy=RES, n_grid=9, torus_u=8, torus_v=4,
             ibl_samples=1, sun_samples=1)


@pytest.fixture(scope="module")
def scenes():
    return j_mesh_scene(**SMALL), mesh_scene(**SMALL, device="cpu")


def _camera(ts):
    """Pixel-centre camera rays of the port's scene and their QMC keys,
    as render_chunk makes them for one sample per pixel."""
    ys, xs = torch.meshgrid(torch.arange(RES), torch.arange(RES),
                            indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    rays, _ = shoot_ray(ts.camera, x.float() + 0.5, y.float() + 0.5)
    sampling_offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    return rays, torch.zeros_like(x), sampling_offs


def test_primary_miss_is_the_background(scenes):
    js, ts = scenes
    rays, pixel_sample, sampling_offs = _camera(ts)
    opts = tpath.PathOptions(path_samples=1, bounces=1, raydepth=0)
    with torch.no_grad():
        rgba = tpath.integrate(ts, scene_material_types(ts), rays,
                               pixel_sample, sampling_offs, opts)
        hits = tscene_mod.closest_hit_s(ts, tvec.rays_to_soa(rays))
        bg = eval_background_s(ts.background, tvec.v3(rays.d))
    miss = ~hits.valid
    assert 0.2 < float(miss.float().mean()) < 0.9   # sky and geometry
    want = torch.stack([bg.x, bg.y, bg.z], dim=-1)[miss]
    assert torch.equal(rgba[miss, :3], want)
    assert float(want.min()) > 0.1
    assert torch.equal(rgba[:, 3], torch.ones(RES * RES))
    # the port's background is core_tpu's, on the same numpy directions
    d = rays.d.numpy()
    jbg = jpath._eval_background_s(js.background,
                                   jvec.v3(jnp.asarray(d)))
    np.testing.assert_allclose(
        np.stack([bg.x, bg.y, bg.z], axis=-1),
        np.stack([np.asarray(c) for c in (jbg.x, jbg.y, jbg.z)], axis=-1),
        rtol=1e-5, atol=1e-6)


def _paths(scene_mod, scene, types, rays_s, pixel_sample, sampling_offs,
           paths_fn, opts, n_paths, params_kw):
    hits = scene_mod.closest_hit_s(scene, rays_s)
    sp = scene_mod.surface_points_s(scene, rays_s, hits)
    p = scene_mod.material_params_s(scene, sp, **params_kw)
    nee0 = hits.valid & ((p.flags & BSDF.DIFFUSE) != 0)
    return paths_fn(scene, types, sp, p, -rays_s.d, nee0, n_paths,
                    pixel_sample, sampling_offs, opts)


def test_caustic_escape_sees_the_background(scenes):
    js, ts = scenes
    rays, pixel_sample, sampling_offs = _camera(ts)
    n_paths = 4
    got = {}
    with torch.no_grad():
        for name, sc in (("bg", ts), ("none", dataclasses.replace(
                ts, background=None))):
            col = _paths(tscene_mod, sc, scene_material_types(sc),
                         tvec.rays_to_soa(rays), pixel_sample, sampling_offs,
                         tpath._paths_batched,
                         tpath.PathOptions(path_samples=n_paths, bounces=2,
                                           raydepth=0), n_paths, {})
            got[name] = np.stack([col.x, col.y, col.z], axis=-1)
    jr = jvec.RaysS(o=jvec.v3(jnp.asarray(rays.o.numpy())),
                    d=jvec.v3(jnp.asarray(rays.d.numpy())),
                    tmin=jnp.asarray(rays.tmin.numpy()),
                    tmax=jnp.asarray(rays.tmax.numpy()))
    col = _paths(jscene_mod, js, j_types(js), jr,
                 jnp.asarray(pixel_sample.numpy(), jnp.uint32),
                 jnp.asarray(sampling_offs.numpy(), jnp.uint32),
                 jpath._paths_batched,
                 jpath.PathOptions(path_samples=n_paths, bounces=2,
                                   raydepth=0), n_paths,
                 dict(pick_seed=jnp.asarray(sampling_offs.numpy(),
                                            jnp.uint32)))
    want = np.stack([np.asarray(c) for c in (col.x, col.y, col.z)], axis=-1)
    assert np.isfinite(got["bg"]).all()

    def close(a):
        return np.abs(a - want) <= 1e-5 + 1e-4 * np.abs(want)
    escape = ~close(got["none"])           # pixels the escape term changes
    assert escape.sum() >= 12, escape.sum()
    assert close(got["bg"]).mean() >= 0.99, close(got["bg"]).mean()
    assert close(got["bg"])[escape].mean() >= 0.99


def test_default_integrator_is_core_tpus():
    j, t = JRenderOptions(), RenderOptions()
    assert t.integrator == j.integrator == "directlight"
    assert type(t.integrator_opts).__name__ \
        == type(j.integrator_opts).__name__ == "DirectOptions"
