"""The port's backward pass (core_tpu_torch/diff.py) against core_tpu's, and
against its own central finite differences.

- Parity: core_tpu's jax.value_and_grad of the bench loss (mean squared
  RGB against a zero target, render_chunk + film.normalized, bench.py:
  170-177) against the port's value_and_grad, on the same 8x8 path-traced
  Cornell box carried across by convert.py (path_samples=2, bounces=2,
  light_samples=2, 1 spp), with respect to every leaf of
  extract_params(geometry=True): the geometry=False leaves and the light
  geometry and geom.obj_offset at 0 (ROADMAP Queue 3: geometry gradients
  at a nonzero offset shade against a stale accel).  core_tpu's gradient is
  compiled once, in a module fixture.  The loss agrees within rtol 1e-4;
  each leaf elementwise within 1e-3 * max|g_core_tpu| of that leaf (a leaf
  whose core_tpu gradient is 0 must be exactly 0).  No leaf needs more.
- extract/apply round trip: apply_params(scene, extract_params(scene))
  renders bit-identically to the scene.
- The port's AD against its own central FD, at the settings and tolerances
  of tests/test_diff.py (directlight raydepth=0 albedo and light colour,
  path-traced albedo and light colour) and tests/test_diff_geometry.py
  (light0.corner, light0.to_x, geom.obj_offset over a floor window), plus
  the point light's pos on the dirac variant at tests/test_torch_dirac.py's
  size, over a window with no shadow edge.
- Gradients flow through every ported family: a small mesh_scene
  (textures, glossy, IBL, sun) and its dirac variant (point, spot,
  directional) give finite gradients of every leaf, live where the leaf
  reaches the image.
- stats: the path tracer's traced lane-rays equal core_tpu's and its useful
  ones agree within 0.5%, on one 8x8 camera wavefront.
- The glossy chain's branch probability is held constant in the backward
  pass (core_tpu/integrators/raytrace.py:136): on 256 rays aimed at the
  glossy torus of a small mesh_scene, the gradient of the one-bounce chain
  throughput with respect to each lane's glossy colour equals, bit for bit,
  the gradient of the same throughput written with a constant branch
  probability; the two-bounce chain's gradient with respect to the
  material table's glossy_color matches core_tpu's jax.grad of its chain
  on the same numpy rays, run eagerly, within 1e-4 * max|g| (glossy raises
  a cosine to the 80th power, so ulps of XLA's FMAs grow there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import diff as jdiff
from core_tpu import scene as jscene_mod
from core_tpu.integrators import path as jpath
from core_tpu.integrators import raytrace as jraytrace
from core_tpu.integrators.path import PathOptions as JPathOptions
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert, diff
from core_tpu_torch import scene as tscene_mod
from core_tpu_torch import vec as tvec
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.integrators import raytrace as traytrace
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.render import RenderOptions, scene_material_types
from core_tpu_torch.sampling import qmc
from core_tpu_torch.scenes import (add_dirac_lights, cornell_box,
                                   mesh_builder, mesh_scene)
from core_tpu_torch.vec import V3, RaysS, luminance3

torch.set_num_threads(1)
RES = 8
PATH = dict(path_samples=2, bounces=2, raydepth=2)
LEAVES = (tuple("mat." + c for c in diff.MATERIAL_PARAM_COLS)
          + ("light0.color", "light0.corner", "light0.to_x", "light0.to_y",
             "geom.obj_offset"))


@pytest.fixture(scope="module")
def cornell():
    js = j_cornell_box(resx=RES, resy=RES, light_samples=2,
                       intersector="brute")
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


@pytest.fixture(scope="module")
def grads(cornell):
    """(loss, grads) of core_tpu and of the port on the bench loss."""
    js, ts = cornell
    jopts = JRenderOptions(integrator="pathtracing",
                           integrator_opts=JPathOptions(**PATH))
    jvg = jax.jit(jdiff.value_and_grad_fn(js, jopts, 1,
                                          jnp.zeros((RES, RES, 4))))
    jl, jg = jvg(jdiff.extract_params(js, geometry=True))
    topts = RenderOptions(integrator="pathtracing",
                          integrator_opts=PathOptions(**PATH))
    tl, tg = diff.value_and_grad_fn(ts, topts, 1, torch.zeros(RES, RES, 4))(
        diff.extract_params(ts, geometry=True))
    return ((float(jl), {k: np.asarray(v) for k, v in jg.items()}),
            (float(tl), {k: v.numpy() for k, v in tg.items()}))


def test_loss_matches_core_tpu(grads):
    (jl, jg), (tl, tg) = grads
    assert tl == pytest.approx(jl, rel=1e-4)
    assert sorted(tg) == sorted(jg) == sorted(LEAVES)


@pytest.mark.parametrize("leaf", LEAVES)
def test_grad_matches_core_tpu(grads, leaf):
    (_, jg), (_, tg) = grads
    want, got = jg[leaf], tg[leaf]
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale, (leaf, got, want)


def test_live_leaves_have_gradients(grads):
    """The bench's own leaves carry gradient: albedo, emission, light
    colour, and each geometry leaf."""
    _, (_, tg) = grads
    for leaf in ("mat.diffuse_color", "mat.emit_strength", "light0.color",
                 "light0.corner", "light0.to_x", "light0.to_y",
                 "geom.obj_offset"):
        assert np.abs(tg[leaf]).max() > 0.0, leaf


@pytest.mark.parametrize("geometry", [False, True])
def test_extract_apply_round_trip(cornell, geometry):
    _, ts = cornell
    opts = RenderOptions(integrator="pathtracing",
                         integrator_opts=PathOptions(**PATH))
    with torch.no_grad():
        want = diff.render_flat(ts, opts, 1)
        got = diff.render_flat(
            diff.apply_params(ts, diff.extract_params(ts, geometry)), opts, 1)
    assert torch.equal(got, want)


def test_base_scene_caches_hold_no_graph(cornell):
    """A gradient step builds its triangle rows on the new Scene; the base
    scene's cached tables never take a graph."""
    _, ts = cornell
    params = {k: v.clone().requires_grad_()
              for k, v in diff.extract_params(ts).items()}
    moved = diff.apply_params(ts, params)
    assert moved.tri_rows.requires_grad and not moved.tri.requires_grad
    assert not ts.tri_rows.requires_grad and not ts.tri.requires_grad
    assert moved.tri_rows is not ts.tri_rows


# --- AD against central finite differences (torch only) ---

def _fd_check(loss_fn, params, key, idx, eps, rtol, atol):
    """Central finite difference on one coordinate of params[key] (as
    tests/test_diff.py's _fd_check)."""
    _, grads = diff.value_and_grad(loss_fn)(params)
    g_ad = float(grads[key][idx])

    def shift(sign):
        p = dict(params)
        p[key] = p[key].clone()
        p[key][idx] += sign * eps
        with torch.no_grad():
            return float(loss_fn(p))

    g_fd = (shift(+1) - shift(-1)) / (2 * eps)
    assert np.isfinite(g_ad) and np.isfinite(g_fd)
    assert g_ad == pytest.approx(g_fd, rel=rtol, abs=atol), \
        f"{key}[{idx}]: AD {g_ad} vs FD {g_fd}"
    return g_ad


def _loss(opts, spp, region=None, **box):
    scene = cornell_box(resx=32, resy=32, light_samples=2, light_power=30.0,
                        device="cpu", **box)
    with torch.no_grad():
        target = diff.render_flat(scene, opts, spp) * 0.7 + 0.02
    return (diff.make_loss_fn(scene, opts, spp, target, region=region),
            diff.extract_params(scene))


DIRECT = RenderOptions(integrator="directlight",
                       integrator_opts=DirectOptions(raydepth=0))


@pytest.mark.parametrize("key,idx,eps,rtol,atol", [
    ("mat.diffuse_color", (0, 0), 0.05, 2e-2, 1e-7),
    ("mat.diffuse_color", (1, 0), 0.05, 2e-2, 1e-7),
    ("light0.color", (0,), 0.2, 2e-2, 1e-8),
    ("mat.emit_strength", (3,), 2.0, 2e-2, 1e-8),
])
def test_fd_directlight(key, idx, eps, rtol, atol):
    loss_fn, params = _loss(DIRECT, 2)
    assert abs(_fd_check(loss_fn, params, key, idx, eps, rtol, atol)) > 1e-10


@pytest.mark.parametrize("key,idx,eps,atol", [
    ("mat.diffuse_color", (0, 0), 0.05, 1e-7),
    ("light0.color", (1,), 0.2, 1e-8),
])
def test_fd_pathtracer(key, idx, eps, atol):
    opts = RenderOptions(integrator="pathtracing",
                         integrator_opts=PathOptions(path_samples=2,
                                                     bounces=2, raydepth=0))
    loss_fn, params = _loss(opts, 1)
    _fd_check(loss_fn, params, key, idx, eps, 3e-2, atol)


@pytest.mark.parametrize("key,idx,eps,rtol,region", [
    ("light0.corner", (0,), 1.0, 1e-2, None),
    ("light0.corner", (2,), 1.0, 1e-2, None),
    ("light0.to_x", (2,), 1.0, 2e-2, None),
    ("geom.obj_offset", (0, 1), 0.5, 1e-2, (22, 30, 10, 22)),
])
def test_fd_geometry(key, idx, eps, rtol, region):
    """tests/test_diff_geometry.py's empty box: no shadow or silhouette
    edge moves under the shift, so the interior term is the whole
    derivative."""
    loss_fn, params = _loss(DIRECT, 2, region, with_blocks=False,
                            show_light_geo=False)
    g = _fd_check(loss_fn, params, key, idx, eps, rtol, 1e-10)
    assert abs(g) > 1e-12


def test_fd_point_light_position():
    """The dirac variant (test_torch_dirac's 32x32, 1,634 triangles):
    d(loss)/d(point light pos) over a terrain window clear of shadow
    edges, directlight raydepth=0."""
    b = mesh_builder(32, 32, n_grid=24, torus_u=24, torus_v=12, device="cpu")
    scene = add_dirac_lights(b).compile_scene()
    with torch.no_grad():
        target = diff.render_flat(scene, DIRECT, 1) * 0.7 + 0.02
    loss_fn = diff.make_loss_fn(scene, DIRECT, 1, target,
                                region=(24, 32, 0, 12))
    params = diff.extract_params(scene)
    for idx in ((0,), (1,)):
        g = _fd_check(loss_fn, params, "light0.pos", idx, 0.05, 1e-2, 1e-10)
        assert abs(g) > 1e-12


@pytest.mark.parametrize("variant", ["mesh", "dirac"])
def test_grads_finite_through_every_family(variant):
    """A small mesh_scene (marble and voronoi textures, glossy, clouds IBL,
    sun) and its dirac variant (point, spot, directional), directlight
    raydepth=1, every leaf of extract_params(geometry=True): the loss and
    gradients finite, and the glossy and light colours' gradients live."""
    small = dict(n_grid=9, torus_u=8, torus_v=4)
    if variant == "mesh":
        scene = mesh_scene(16, 16, **small, ibl_samples=2, sun_samples=2,
                           device="cpu")
        live = ("mat.glossy_color", "mat.glossy_reflect", "geom.obj_offset")
    else:
        scene = add_dirac_lights(mesh_builder(16, 16, **small,
                                              device="cpu")).compile_scene()
        live = ("mat.glossy_color", "light0.color", "light0.pos",
                "light1.color", "light1.pos", "light2.color")
    opts = RenderOptions(integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))

    def loss_fn(params):
        img = diff.render_flat(diff.apply_params(scene, params), opts, 1)
        return torch.mean(img[..., :3])

    loss, grads = diff.value_and_grad(loss_fn)(
        diff.extract_params(scene, geometry=True))
    assert torch.isfinite(loss)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
    for k in live:
        assert float(grads[k].abs().max()) > 0.0, k


# --- the path tracer's lane counters ---

def test_stats_match_core_tpu(cornell):
    js, ts = cornell
    ys, xs = torch.meshgrid(torch.arange(RES), torch.arange(RES),
                            indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    rays, _ = shoot_ray(ts.camera, x.float() + 0.5, y.float() + 0.5)
    offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    stats = {}
    with torch.no_grad():
        tpath.integrate(ts, scene_material_types(ts), rays,
                        torch.zeros_like(x), offs, PathOptions(**PATH),
                        stats=stats)

    @jax.jit
    def j_stats(o, d, tmin, tmax, offs):
        st = {}
        jpath.integrate(js, j_types(js), JRays(o=o, d=d, tmin=tmin,
                                               tmax=tmax),
                        jnp.zeros_like(offs), offs, JPathOptions(**PATH),
                        stats=st)
        return st

    want = j_stats(*(jnp.asarray(a.numpy()) for a in rays),
                   jnp.asarray(offs.numpy(), jnp.uint32))
    # primary 64, NEE 4 lanes per point at the camera hit and per bounce,
    # and 2 bounces of 128 paths
    assert stats["traced"] == float(want["traced"]) == 64 * 5 + 2 * 128 * 5
    useful = float(stats["useful"])
    assert useful == pytest.approx(float(want["useful"]), rel=5e-3)
    assert 0.3 * stats["traced"] < useful < stats["traced"]


# --- the glossy chain's branch probability ---

GLOSSY = 4

N_CHAIN = 256


@pytest.fixture(scope="module")
def chain():
    """core_tpu's Cornell box with glossy blocks (material 4), carried
    across by convert.py, and 256 camera rays aimed at random points of
    the blocks."""
    js = j_cornell_box(resx=RES, resy=RES, light_samples=1,
                       block_materials=("glossy", "glossy"),
                       intersector="brute")
    ts = convert.scene_from_numpy(*convert.scene_to_numpy(js), device="cpu")
    rng = np.random.default_rng(0)
    g = ts.geom
    tri = rng.choice(np.nonzero(g.tri_mat.numpy() == GLOSSY)[0], N_CHAIN)
    bary = rng.dirichlet([1.0, 1.0, 1.0], N_CHAIN).astype(np.float32)
    target = (bary[:, :, None]
              * g.verts.numpy()[g.tri_vidx.numpy()[tri]]).sum(1)
    o = np.broadcast_to(ts.camera.pos.numpy(), (N_CHAIN, 3)).copy()
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    offs = rng.integers(0, 2**32, N_CHAIN, dtype=np.uint32)
    return js, ts, o.astype(np.float32), d.astype(np.float32), offs


def _t_chain(ts, o, d, offs, raydepth, table=None, lane_glossy=None):
    """The port's chain radiance from the camera hits of (o, d), each chain
    hit shaded with radiance 1; returns (loss, sp, p) at the camera hits."""
    if table is not None:
        ts = dataclasses.replace(ts, materials=ts.materials._replace(
            glossy_color=table))
    n = o.shape[0]
    rs = RaysS(o=tvec.v3(torch.from_numpy(o)), d=tvec.v3(torch.from_numpy(d)),
               tmin=torch.full((n,), 5e-4), tmax=torch.full((n,), -1.0))
    hits = tscene_mod.closest_hit_s(ts, rs)
    sp = tscene_mod.surface_points_s(ts, rs, hits)
    p = tscene_mod.material_params_s(ts, sp)
    if lane_glossy is not None:
        p = p._replace(glossy_color=V3(*lane_glossy))
    ones = V3(*(torch.ones(n),) * 3)

    def shade_fn(nrays, nhits, include_lights):
        nsp = tscene_mod.surface_points_s(ts, nrays, nhits)
        return ones, nsp, tscene_mod.material_params_s(ts, nsp)

    col = traytrace.recursive_raytrace(
        ts, scene_material_types(ts), rs, hits, sp, p, shade_fn,
        torch.zeros(n, dtype=torch.int64),
        torch.from_numpy(offs.astype(np.int64)), raydepth)
    return (col.x + col.y + col.z).sum(), rs, hits, sp, p


def test_chain_branch_probability_is_constant(chain):
    """One bounce: the chain's throughput is g_col3 / max(branch_p, 1e-6)
    on the lanes that take the glossy branch and hit; the gradient with
    respect to each lane's glossy colour must be that of g_col3 over a
    constant."""
    _, ts, o, d, offs = chain
    types = scene_material_types(ts)
    with torch.no_grad():
        _, _, _, sp0, p0 = _t_chain(ts, o, d, offs, 1)
    lane = [c.clone().requires_grad_() for c in p0.glossy_color]
    loss, rs, hits, sp, p = _t_chain(ts, o, d, offs, 1, lane_glossy=lane)
    got = torch.autograd.grad(loss, lane)

    # the same throughput, written out with the branch probability held
    # constant (computed under no_grad)
    u32 = offs.astype(np.int64)
    g1 = qmc.scr_halton(13, torch.from_numpy(u32))
    g2 = qmc.scr_halton(14, torch.from_numpy(u32))
    gres = detach_sample(dispatch.sample_bsdf_s(
        types, p, sp, -rs.d, g1, g2,
        BSDF.GLOSSY | BSDF.REFLECT | BSDF.TRANSMIT))
    g_col3 = gres.col * gres.w
    with torch.no_grad():
        g_ok = (gres.pdf > 1e-6) & ((gres.flags & BSDF.GLOSSY) != 0)
        lum_g = torch.where(g_ok, luminance3(g_col3), 0.0)
        take = hits.valid & (lum_g > 1e-7) & (lum_g > 0.0)
        den = (lum_g * (1.0 / lum_g.clamp_min(1e-20))).clamp_min(
            0.0).clamp_min(1e-6)
        nrays = RaysS(o=sp.p, d=gres.wi, tmin=torch.full_like(lum_g, 5e-4),
                      tmax=torch.full_like(lum_g, -1.0))
        ok = take & tscene_mod.closest_hit_s(ts, nrays,
                                             exclude_prim=sp.prim).valid
    assert 100 < int(ok.sum()) < N_CHAIN
    tp = V3(g_col3.x / den, g_col3.y / den, g_col3.z / den)
    ref = sum(torch.where(ok, c, 0.0).sum() for c in (tp.x, tp.y, tp.z))
    want = torch.autograd.grad(ref, lane)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert max(float(a.abs().max()) for a in got) > 0.1


def test_chain_grad_matches_core_tpu(chain):
    js, ts, o, d, offs = chain
    table = ts.materials.glossy_color.clone().requires_grad_()
    loss, *_ = _t_chain(ts, o, d, offs, 2, table=table)
    got = torch.autograd.grad(loss, table)[0].numpy()
    types = j_types(js)
    n = o.shape[0]

    def j_loss(glossy_color):
        sc = dataclasses.replace(js, materials=js.materials._replace(
            glossy_color=glossy_color))
        rays = JRays(o=jnp.asarray(o), d=jnp.asarray(d),
                     tmin=jnp.full(n, 5e-4), tmax=jnp.full(n, -1.0))
        hits = jscene_mod.closest_hit(sc, rays)
        sp = jscene_mod.surface_points(sc, rays, hits)
        p = jscene_mod.material_params(sc, sp)

        def shade_fn(nrays, nhits, include_lights, act):
            nsp = jscene_mod.surface_points(sc, nrays, nhits)
            return (jnp.ones((n, 3)), nsp,
                    jscene_mod.material_params(sc, nsp))

        col = jraytrace.recursive_raytrace(
            sc, types, rays, hits, sp, p, shade_fn, jnp.zeros(n, jnp.uint32),
            jnp.asarray(offs), 2)
        return jnp.sum(col)

    want = np.asarray(jax.grad(j_loss)(js.materials.glossy_color))
    assert np.abs(want).max() > 1.0
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-4 * np.abs(want).max() + 1e-30)
