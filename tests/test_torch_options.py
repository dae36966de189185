"""The integrator options of the port (transparent shadows, ambient
occlusion, the transparent background, wavefront folding) against core_tpu
on the same numpy inputs.

core_tpu runs eagerly (jax.disable_jit), so XLA contracts no multiply-adds
into FMAs and ties fall the same way in both packages; 256 lanes and one
light sample keep its per-primitive compiles few.

- The pane scene of tests/test_shadow_sentinel.py (a white floor, a green
  pane with transparency 0.8 over its -x half, a point light), built by
  core_tpu and carried across by convert.py: transparent_shadow on rays
  through the pane, from above it onto the floor, open (tcap <= 0) and
  dead (0 < tcap <= tmin), at shadow_depth 1 and 4, attenuation within
  rtol 1e-5 / atol 1e-6; estimate_all_direct_s(transp_shad=True) at 256
  floor points for the point light (the dirac branch) and for an area
  light above the pane (the MIS branch, both sides), within rtol 1e-4 /
  atol 1e-6.  The port gives lanes that are not active dead caps where
  core_tpu walks them open: the outputs hold all the same.
- _ambient_occlusion on the 256 camera hits of a 16^2 Cornell box
  (ao_samples=2, ao_dist 100 and 1e4), rtol 1e-5 / atol 1e-6.
- direct.integrate with use_ao, transp_shad and transp_background on the
  pane scene seen from high enough that its border pixels miss: rgba
  within rtol 1e-4 / atol 1e-5, alpha exactly 0 on the misses.
- _paths_batched with folding (fold_interval=1, fold_start=1) at 128 lanes
  x 4 paths and 3 bounces, sorted and plain: it folds twice, at 512 and at
  256 lanes.  Per-lane radiance within rtol 1e-4 / atol 1e-5, the pick
  masks of both folds bit-equal, the traced / useful counts equal.
- The port's folded gradients against its own central finite differences
  on an 8^2 Cornell box (test_torch_diff's path-tracer tolerance).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import scene as jscene_mod
from core_tpu import vec as jvec
from core_tpu.cameras import make_perspective as j_make_perspective
from core_tpu.cameras import shoot_ray as j_shoot_ray
from core_tpu.geometry.mesh import MeshAssembler as JMeshAssembler
from core_tpu.integrators import common as jcommon
from core_tpu.integrators import direct as jdirect
from core_tpu.integrators import path as jpath
from core_tpu.lights.area import make_area_light as j_make_area_light
from core_tpu.lights.point import make_point_light as j_make_point_light
from core_tpu.materials.base import MaterialDef as JMaterialDef
from core_tpu.materials.base import build_material_table as j_build_table
from core_tpu.mathutils import SHADOW_BIAS
from core_tpu.render import scene_material_types as j_types
from core_tpu.scene import Scene as JScene
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.types import Rays as JRays
from core_tpu.types import SurfacePoints as JSurfacePoints
from core_tpu_torch import convert, diff
from core_tpu_torch import scene as tscene_mod
from core_tpu_torch import vec as tvec
from core_tpu_torch.integrators import common as tcommon
from core_tpu_torch.integrators import direct as tdirect
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.materials.base import BSDF
from core_tpu_torch.render import RenderOptions, scene_material_types
from core_tpu_torch.sampling import qmc
from core_tpu_torch.scenes import cornell_box
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.vec import SPS, RaysS

torch.set_num_threads(1)
N = 256


def _add_quad(a, m, p0, p1, p2, p3, mat):
    ids = [a.add_vertex(m, *p) for p in (p0, p1, p2, p3)]
    a.add_triangle(m, ids[0], ids[1], ids[2], mat)
    a.add_triangle(m, ids[0], ids[2], ids[3], mat)


def _pane_scene(light="point", res=8, cam_y=15.0):
    """tests/test_shadow_sentinel.py's transparent-shadow scene, built by
    core_tpu; light "area" puts a 16 x 16 area light facing down over the
    pane in place of the point light."""
    a = JMeshAssembler()
    m = a.start_mesh()
    _add_quad(a, m, (-20, 0, -20), (-20, 0, 20), (20, 0, 20), (20, 0, -20),
              0)                                        # floor, white
    _add_quad(a, m, (-12, 5, -12), (-12, 5, 12), (-2, 5, 12), (-2, 5, -12),
              1)                                        # pane over -x
    mats = [JMaterialDef(name="white", diffuse_color=(0.8, 0.8, 0.8)),
            JMaterialDef(name="pane", diffuse_color=(0.1, 0.9, 0.1),
                         transparency=0.8, transmit_filter=1.0,
                         diffuse_strength=0.2)]
    if light == "point":
        lt = j_make_point_light(pos=(-7, 30, 0), color=(1, 1, 1),
                                power=4000.0)
    else:
        lt = j_make_area_light((-15, 30, -8), (1, 30, -8), (-15, 30, 8),
                               color=(1, 1, 1), power=40.0, samples=1)
    cam = j_make_perspective(pos=(0, cam_y, 0), look=(0, 0, 0),
                             up=(0, cam_y, 1), resx=res, resy=res, focal=1.0)
    js = JScene(geom=a.build(), materials=j_build_table(mats), lights=(lt,),
                camera=cam, background=None, accel=None, has_specular=True,
                has_transparency=True, mat_types=(0,), intersector="brute")
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


@pytest.fixture(scope="module")
def pane():
    return _pane_scene()


def _t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


def _j3(a):
    return jvec.v3(jnp.asarray(a, jnp.float32))


def _t3(a):
    return tvec.v3(_t(np.asarray(a, np.float32)))


def _np3(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


def _shadow_rays(rng):
    """256 shadow segments on the pane scene: from the floor under and
    beside the pane toward the point light (bounded), from above the pane
    down onto the floor (open, or capped between the pane and the floor),
    upward and open, and dead.  Returns (o, d, tcap, exclude) numpy."""
    q = N // 4
    x = rng.uniform(-14.0, 10.0, q)
    z = rng.uniform(-10.0, 10.0, q)
    o1 = np.stack([x, np.zeros(q), z], axis=-1)
    to = np.array([-7.0, 30.0, 0.0]) - o1
    dist = np.linalg.norm(to, axis=-1)
    d1 = to / dist[:, None]
    ex1 = np.where(x <= z, 0, 1)                 # the floor's two triangles
    o2 = np.stack([rng.uniform(-11.0, -3.0, q), np.full(q, 10.0),
                   rng.uniform(-10.0, 10.0, q)], axis=-1)
    d2 = np.stack([rng.uniform(-0.2, 0.2, q), -np.ones(q),
                   rng.uniform(-0.2, 0.2, q)], axis=-1)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    cap2 = np.where(np.arange(q) % 2 == 0, -1.0, 7.0)
    o3 = o1[::-1].copy()
    d3 = np.tile([0.0, 1.0, 0.0], (q, 1))
    cap3 = np.full(q, -1.0)
    o4 = o1.copy()
    d4 = d1.copy()
    cap4 = np.full(q, 0.5 * SHADOW_BIAS)
    o = np.concatenate([o1, o2, o3, o4]).astype(np.float32)
    d = np.concatenate([d1, d2, d3, d4]).astype(np.float32)
    tcap = np.concatenate([dist - SHADOW_BIAS, cap2, cap3, cap4]) \
        .astype(np.float32)
    ex = np.concatenate([ex1, np.full(q, -2), ex1[::-1], ex1]) \
        .astype(np.int32)
    return o, d, tcap, ex


@pytest.mark.parametrize("depth", [1, 4])
def test_transparent_shadow_matches_core_tpu(pane, depth):
    js, ts = pane
    o, d, tcap, ex = _shadow_rays(np.random.default_rng(5))
    with jax.disable_jit():
        want = np.asarray(jcommon.transparent_shadow(
            js, j_types(js), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tcap), jnp.asarray(ex), depth))
    with torch.no_grad():
        got = _np3(tcommon.transparent_shadow(
            ts, scene_material_types(ts), _t3(o), _t3(d), _t(tcap),
            _t(ex), depth))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    q = N // 4
    through = want[:q, 1]                    # floor -> light
    assert (through == 1.0).any() and ((0.0 < through) & (through < 1.0)) \
        .any()
    down = want[q:2 * q]                     # above the pane -> the floor
    if depth == 1:
        assert (down[:, 1] < 1.0).all() and (down[:, 1] > 0.0).all()
    else:
        assert (down[0::2] == 0.0).all()     # open: the floor blocks
        assert (down[1::2, 1] > 0.0).all()   # capped above the floor
    assert (want[3 * q:] == 1.0).all()       # dead caps


def _floor_sp(rng):
    """256 numpy shading points on the floor (y = 0, normal +y), half of
    them under the pane."""
    x = rng.uniform(-14.0, 10.0, N).astype(np.float32)
    z = rng.uniform(-10.0, 10.0, N).astype(np.float32)
    p = np.stack([x, np.zeros(N, np.float32), z], axis=-1)
    prim = np.where(x <= z, 0, 1).astype(np.int32)
    return p, prim


def _sp_pair(p, prim, n, nu, nv, mat, uv=None):
    uv = np.zeros((p.shape[0], 2), np.float32) if uv is None else uv
    jsp = JSurfacePoints(
        p=jnp.asarray(p), n=jnp.asarray(n), ng=jnp.asarray(n),
        nu=jnp.asarray(nu), nv=jnp.asarray(nv), uv=jnp.asarray(uv),
        mat=jnp.asarray(mat), light=jnp.full(p.shape[0], -1, jnp.int32),
        prim=jnp.asarray(prim), obj=jnp.zeros(p.shape[0], jnp.int32))
    tsp = SPS(p=_t3(p), n=_t3(n), ng=_t3(n), nu=_t3(nu), nv=_t3(nv),
              u=_t(uv[:, 0]), v=_t(uv[:, 1]), mat=_t(mat),
              light=torch.full((p.shape[0],), -1, dtype=torch.int32),
              prim=_t(prim), obj=torch.zeros(p.shape[0], dtype=torch.int32))
    return jsp, tsp


@pytest.mark.parametrize("light", ["point", "area"])
def test_estimate_all_direct_transparent_matches_core_tpu(light):
    js, ts = _pane_scene(light)
    rng = np.random.default_rng(11)
    p, prim = _floor_sp(rng)
    ones = np.ones(N, np.float32)
    zero = np.zeros(N, np.float32)
    n = np.stack([zero, ones, zero], axis=-1)
    nu = np.stack([ones, zero, zero], axis=-1)
    nv = np.stack([zero, zero, ones], axis=-1)
    wo = np.tile(np.float32([0.3, 0.9, -0.3]) / np.sqrt(0.99), (N, 1))
    wo = wo.astype(np.float32)
    pixel_sample = np.arange(N, dtype=np.uint32)
    offs = rng.integers(0, 2**32, N, dtype=np.uint32)
    active = rng.uniform(size=N) < 0.9
    jsp, tsp = _sp_pair(p, prim, n, nu, nv, np.zeros(N, np.int32))
    out = {}
    for ts_ in (False, True):
        with jax.disable_jit():
            jps = jvec.sp_to_soa(jsp)
            jp = jscene_mod.material_params_s(js, jps)
            want = jcommon.estimate_all_direct_s(
                js, j_types(js), jp, jps, _j3(wo), jnp.asarray(pixel_sample),
                jnp.asarray(offs), jnp.asarray(active), transp_shad=ts_,
                shadow_depth=4)
        with torch.no_grad():
            tp = tscene_mod.material_params_s(ts, tsp)
            got = tcommon.estimate_all_direct_s(
                ts, scene_material_types(ts), tp, tsp, _t3(wo),
                _t(pixel_sample.astype(np.int64)), _t(offs.astype(np.int64)),
                _t(active), transp_shad=ts_, shadow_depth=4)
        np.testing.assert_allclose(_np3(got), _np3(want), rtol=1e-4,
                                   atol=1e-6)
        out[ts_] = _np3(got)
    under = (p[:, 0] > -11.0) & (p[:, 0] < -3.0) & (np.abs(p[:, 2]) < 11.0) \
        & active
    # the pane lets green through only with transparent shadows
    assert out[True][under, 1].sum() > 3.0 * out[False][under, 1].sum()
    assert out[True][under, 1].mean() > 3.0 * out[True][under, 0].mean()


@pytest.fixture(scope="module")
def cornell16():
    js = j_cornell_box(resx=16, resy=16, light_samples=1,
                       intersector="brute")
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


def _camera_hits(js, rng, n=N):
    """numpy (o, d) of n rays from core_tpu's camera through random pixel
    positions."""
    cam = js.camera
    px = rng.uniform(0, cam.resx, n).astype(np.float32)
    py = rng.uniform(0, cam.resy, n).astype(np.float32)
    rays, _ = j_shoot_ray(cam, jnp.asarray(px), jnp.asarray(py))
    o = np.broadcast_to(np.asarray(rays.o), (n, 3)).astype(np.float32)
    return o, np.asarray(rays.d, np.float32)


def _sp_from_hits(scene_mod, scene, rays_s):
    hits = scene_mod.closest_hit_s(scene, rays_s)
    return hits, scene_mod.surface_points_s(scene, rays_s, hits)


@pytest.mark.parametrize("ao_dist", [100.0, 1e4])
def test_ambient_occlusion_matches_core_tpu(cornell16, ao_dist):
    js, ts = cornell16
    rng = np.random.default_rng(7)
    o, d = _camera_hits(js, rng)
    pixel_sample = rng.integers(0, 4, N, dtype=np.uint32)
    offs = rng.integers(0, 2**32, N, dtype=np.uint32)
    kw = dict(ao_samples=2, ao_dist=ao_dist, ao_color=(0.9, 0.8, 0.7))
    with jax.disable_jit():
        jr = jvec.RaysS(o=_j3(o), d=_j3(d), tmin=jnp.full(N, 5e-4),
                        tmax=jnp.full(N, -1.0))
        hits, sps = _sp_from_hits(jscene_mod, js, jr)
        sp = jvec.sp_to_aos(sps)
        p = jscene_mod.material_params(js, sp)
        want = np.asarray(jdirect._ambient_occlusion(
            js, j_types(js), p, sp, -jnp.asarray(d), jnp.asarray(pixel_sample),
            jnp.asarray(offs), hits.valid, jdirect.DirectOptions(**kw)))
    with torch.no_grad():
        tr = RaysS(o=_t3(o), d=_t3(d), tmin=torch.full((N,), 5e-4),
                   tmax=torch.full((N,), -1.0))
        thits, tsp = _sp_from_hits(tscene_mod, ts, tr)
        tp = tscene_mod.material_params_s(ts, tsp)
        got = _np3(tdirect._ambient_occlusion(
            ts, scene_material_types(ts), tp, tsp, -_t3(d),
            _t(pixel_sample.astype(np.int64)), _t(offs.astype(np.int64)),
            thits.valid, tdirect.DirectOptions(**kw)))
    assert np.array_equal(thits.valid.numpy(), np.asarray(hits.valid))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    lum = want.mean(axis=-1)
    assert (lum > 0).mean() > 0.2
    if ao_dist == 1e4:                          # a closed box but its front
        assert (lum > 0).mean() < 0.5


def test_direct_integrate_options_match_core_tpu():
    """use_ao, transp_shad and transp_background together on the pane
    scene at 16^2, seen from high enough that the border pixels miss."""
    js, ts = _pane_scene(res=16, cam_y=50.0)
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    offs = qmc.fnv32a((_t(y) * qmc.fnv32a(_t(x))) & qmc.MASK32)
    rays, _ = shoot_ray(ts.camera, _t(x).float() + 0.5, _t(y).float() + 0.5)
    pixel_sample = torch.zeros(N, dtype=torch.int64)
    kw = dict(raydepth=1, transp_shad=True, shadow_depth=2, use_ao=True,
              ao_samples=2, ao_dist=10.0, transp_background=True)
    with torch.no_grad():
        got = tdirect.integrate(ts, scene_material_types(ts), rays,
                                pixel_sample, offs,
                                tdirect.DirectOptions(**kw)).numpy()
    with jax.disable_jit():
        want = np.asarray(jdirect.integrate(
            js, j_types(js),
            JRays(o=jnp.asarray(np.broadcast_to(rays.o.numpy(), (N, 3))),
                  d=jnp.asarray(rays.d.numpy()),
                  tmin=jnp.asarray(rays.tmin.numpy()),
                  tmax=jnp.asarray(rays.tmax.numpy())),
            jnp.zeros(N, jnp.uint32), jnp.asarray(offs.numpy(), jnp.uint32),
            jdirect.DirectOptions(**kw)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        miss = ~tscene_mod.closest_hit_s(ts, tvec.rays_to_soa(rays)).valid
    assert 0.05 < float(miss.float().mean()) < 0.6
    assert (got[miss.numpy(), 3] == 0.0).all()
    assert (got[~miss.numpy(), 3] == 1.0).all()


def _folds_of(fn, *args, **kw):
    """(fn(*args, **kw), the pick masks of its wavefront folds): the
    `folds` list of fn's own frame, read when it returns (sys.monitoring
    watches fn's code object alone, so nothing else runs slower)."""
    mon = sys.monitoring
    tool = next(i for i in range(6) if mon.get_tool(i) is None)
    seen = []

    def on_return(code, offset, retval):
        seen.append(list(sys._getframe(1).f_locals["folds"]))

    mon.use_tool_id(tool, "fold picks")
    mon.register_callback(tool, mon.events.PY_RETURN, on_return)
    mon.set_local_events(tool, fn.__code__, mon.events.PY_RETURN)
    try:
        out = fn(*args, **kw)
    finally:
        mon.set_local_events(tool, fn.__code__, 0)
        mon.register_callback(tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(tool)
    return out, [np.asarray(f[0]) for f in seen[-1]]


@pytest.mark.parametrize("fold_sort", [True, False], ids=["sorted", "plain"])
def test_folded_paths_match_core_tpu(cornell16, fold_sort):
    js, ts = cornell16
    rng = np.random.default_rng(3)
    n = 128
    o, d = _camera_hits(js, rng, n)
    pixel_sample = rng.integers(0, 4, n, dtype=np.uint32)
    offs = rng.integers(0, 2**32, n, dtype=np.uint32)
    kw = dict(path_samples=4, bounces=3, raydepth=0, fold_interval=1,
              fold_start=1, fold_sort=fold_sort)
    with jax.disable_jit():
        jr = jvec.RaysS(o=_j3(o), d=_j3(d), tmin=jnp.full(n, 5e-4),
                        tmax=jnp.full(n, -1.0))
        hits, sps = _sp_from_hits(jscene_mod, js, jr)
        p = jscene_mod.material_params_s(js, sps)
        jstats = {"traced": 0, "useful": 0.0}
        want, jpicks = _folds_of(
            jpath._paths_batched, js, j_types(js), sps, p, -jr.d,
            hits.valid & ((p.flags & BSDF.DIFFUSE) != 0), 4,
            jnp.asarray(pixel_sample), jnp.asarray(offs),
            jpath.PathOptions(**kw), stats=jstats)
    with torch.no_grad():
        tr = RaysS(o=_t3(o), d=_t3(d), tmin=torch.full((n,), 5e-4),
                   tmax=torch.full((n,), -1.0))
        thits, tsp = _sp_from_hits(tscene_mod, ts, tr)
        tp = tscene_mod.material_params_s(ts, tsp)
        tstats = {"traced": 0, "useful": 0.0}
        got, tpicks = _folds_of(
            tpath._paths_batched, ts, scene_material_types(ts), tsp, tp,
            -tr.d, thits.valid & ((tp.flags & BSDF.DIFFUSE) != 0), 4,
            _t(pixel_sample.astype(np.int64)), _t(offs.astype(np.int64)),
            tpath.PathOptions(**kw), stats=tstats)
    assert [a.shape[0] for a in tpicks] == [256, 128]
    for a, b in zip(tpicks, jpicks):
        assert np.array_equal(a, b)
    assert tstats["traced"] == jstats["traced"]
    assert float(tstats["useful"]) == float(jstats["useful"])
    np.testing.assert_allclose(_np3(got), _np3(want), rtol=1e-4, atol=1e-5)
    assert _np3(want).max() > 0.0


def test_folded_gradients_match_central_fd():
    opts = RenderOptions(integrator="pathtracing",
                         integrator_opts=tpath.PathOptions(
                             path_samples=4, bounces=3, raydepth=0,
                             fold_interval=1))
    scene = cornell_box(resx=8, resy=8, light_samples=1, light_power=30.0,
                        device="cpu")
    with torch.no_grad():
        target = diff.render_flat(scene, opts, 1) * 0.7 + 0.02
    loss_fn = diff.make_loss_fn(scene, opts, 1, target)
    params = diff.extract_params(scene)
    _, grads = diff.value_and_grad(loss_fn)(params)
    for key, idx, eps in (("mat.diffuse_color", (0, 0), 0.05),
                          ("light0.color", (1,), 0.2)):
        def shift(sign):
            p = dict(params)
            p[key] = p[key].clone()
            p[key][idx] += sign * eps
            with torch.no_grad():
                return float(loss_fn(p))
        g_fd = (shift(+1) - shift(-1)) / (2 * eps)
        g_ad = float(grads[key][idx])
        assert np.isfinite(g_ad) and abs(g_ad) > 1e-10
        assert g_ad == pytest.approx(g_fd, rel=3e-2, abs=1e-7), (key, g_ad,
                                                                  g_fd)
