"""The photon integrators of the port (photon emission, the sorted-cell
photon map, photonmapping with final gathering, SPPM, the path tracer's
photon caustics) against core_tpu on the same numpy inputs.

core_tpu's side runs once per test run (test_torch_diff.once_per_run):
its photon shoots eagerly (jax.disable_jit: no FMA contraction, so the
roulette's rr < keep_p falls the same way in both packages); its
integrators op by op, with its two gathers (photon/map.py gather_photons,
integrators/sppm.py _gather_flat) compiled by jax.jit, as run op by op
their 27 x 32-step loops take ~10 s a call.  Every wavefront is LANES
wide and every map of the glass-and-glossy box RADIUS wide, so the
primitives and the gathers compile once for all of them.

- emit_photon for all ten light types (the small light zoo of
  test_torch_light_zoo.py with an area, a point, a spot and a directional
  light added, built by each package's SceneBuilder) on the same s1-s4:
  "finite" (area, point, spot, sphere, mesh, IES, portal) and "world"
  (sun, directional, background, from the world bound): rtol 1e-5, atol
  1e-6 (the spot light's colour: atol 1e-5 x its largest value, see
  there).
- shoot_photons on the 16^2 glass-and-glossy box, 2,048 photons, 3
  bounces, in each mode (with_surface on the diffuse one).  A photon whose
  deposit masks differ is a flip.  The glass block's bottom face is
  coplanar with the floor, so a photon that reaches it from inside ties
  between the two faces, and the ulps by which the packages' rays differ
  pick the face.  Every flip must be that tie (at its first differing
  bounce both packages hit the same point of the plane y = 0), and at
  most FLIP_SHARE of the photons flip.  The other photons' deposits
  agree: masks equal, positions, powers and directions (and normals)
  within 1e-5 of each field's largest magnitude, albedos within 1e-4.
- build_photon_grid, gather_photons, estimate_irradiance, the radiance
  cache and lookup_radiance, and sppm._gather_flat on seeded deposits in
  the box's bound with one cell of 200 photons (the k/m compensation
  runs): order and cell_start identical, counts identical (the
  compensations are multiples of 1/32, exact in float32), flux and
  radiance within rtol 1e-5 / atol 1e-6 x their largest magnitude (the
  port sums a query's 864 candidates at once, core_tpu one at a time).
- photonmapping's integrate (final gathering with its cache, the caustic
  map, raydepth 1) on 2,048 camera rays of the box, both packages on maps
  built from core_tpu's deposits (convert.photon_map_from_numpy): at most
  LANE_FLIPS of the lanes differ (ulp ties of the glass block's chains);
  the others within rtol 1e-4 / atol 1e-5, their mean within 1e-5
  relative.
- The path tracer's photon caustics on tests/test_photon.py:206-232's
  scene and options (glass and white blocks, c_photons=20000,
  caustic_depth=4, radius 30), on a caustic map shot by the port: the
  caustic radiance at 2,048 camera hits against core_tpu's on the same
  map (rtol 1e-5), the path tracer's rgba with the map minus without it
  equal to that radiance at the diffuse hits and 0 elsewhere, and
  core_tpu's own assertion on the port's render_image (the map adds
  energy on the floor).
- SPPM on a 64 x 32 image, 2 passes with pm_ire, both packages fed
  core_tpu's eager seed-7 photons at every pass: the HitPoints after each
  pass and the image, as photonmapping's lanes.
- Entry points: render_image dispatches photonmapping, SPPM and the
  path tracer's photon caustics; render_chunk refuses SPPM; an SPPM
  checkpoint_path is written and a finished render resumes from it to the
  same image; a photon_shard and an unknown caustic_type raise by name; a
  scene built with no device given asks for CUDA.
The card's twins (the 64^2 renders through kernels 1 and 2 against the
plain versions, the two photon goldens) are in
tests/test_torch_kernels_cuda.py, which imports no jax.
"""
import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import core_tpu.scenes as j_scenes
from core_tpu import scene as jscene_mod
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.integrators import photonmap as jpm
from core_tpu.integrators import sppm as jsppm
from core_tpu.integrators.photonmap import PhotonOptions as JPhotonOptions
from core_tpu.params import ParamMap as JParamMap
from core_tpu.photon import emit as jemit
from core_tpu.photon import map as jmap
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import scene as tscene_mod
from core_tpu_torch import scenes as t_scenes
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.integrators import photonmap as tpm
from core_tpu_torch.integrators import sppm as tsppm
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.integrators.photonmap import PhotonOptions
from core_tpu_torch.materials.base import BSDF
from core_tpu_torch.params import ParamMap
from core_tpu_torch.photon import emit as temit
from core_tpu_torch.photon import map as tmap
from core_tpu_torch.render import (RenderOptions, render_chunk,
                                   render_image, scene_material_types)
from core_tpu_torch.sampling import qmc
from core_tpu_torch.types import Rays
from core_tpu_torch.vec import V3, rays_to_soa, v3

from chip_smoke import light_zoo_builder
from test_torch_diff import once_per_run

torch.set_num_threads(1)
RES = 16
TOL = dict(rtol=1e-5, atol=1e-6)
# every wavefront of core_tpu's side is LANES wide (photons, emission
# samples, gather queries, 8-spp 16^2 chunks, 64 x 32 images), so its op
# by op primitives compile once for all of them
LANES = N_EMIT = N_PHOTONS = 2048
WIDE = dict(resx=64, resy=32)
PM_SPP = LANES // (RES * RES)
BOUNCES = 3
FLIP_SHARE = 0.02
SMALL_ZOO = dict(grid=12, torus=(12, 8), samples=1, panel=1)
# the four light types the light zoo lacks
EXTRA_LIGHTS = (
    ("area", {"type": "arealight", "corner": (-1.0, 5.0, -1.0),
              "point1": (1.0, 5.0, -1.0), "point2": (-1.0, 5.0, 1.0),
              "color": (1.0, 1.0, 0.9), "power": 2.0, "samples": 1}),
    ("point", {"type": "pointlight", "from": (0.5, 4.0, 0.5),
               "color": (1.0, 0.9, 0.8), "power": 5.0}),
    ("spot", {"type": "spotlight", "from": (2.0, 5.0, 1.0),
              "to": (0.0, 0.0, 0.0), "color": (0.9, 0.9, 1.0), "power": 8.0,
              "cone_angle": 30.0, "blend": 0.2}),
    ("directional", {"type": "directional", "direction": (0.2, 1.0, 0.3),
                     "color": (1.0, 1.0, 1.0), "power": 1.5}),
)
WORLD = ("SunLight", "DirectionalLight", "BgLight")
BOX = dict(resx=RES, resy=RES, light_samples=1,
           block_materials=("glass", "glossy"))
# one radius for every map of the box: the maps share their grid's shape,
# so core_tpu's compiled gathers are compiled once for all of them
RADIUS = 30.0
PM = dict(photons=N_PHOTONS, c_photons=N_PHOTONS, bounces=BOUNCES,
          diffuse_radius=RADIUS, caustic_radius=RADIUS, final_gather=True,
          fg_samples=2, raydepth=1)
# tests/test_photon.py:206-232
PT_BOX = dict(resx=RES, resy=RES, light_samples=2,
              block_materials=("glass", "white"))
PT = dict(path_samples=2, bounces=1, raydepth=2, caustic_type="photon",
          c_photons=20000, caustic_radius=30.0, caustic_depth=4)
SPPM = dict(passes=2, photons=N_PHOTONS, bounces=BOUNCES,
            search_radius=RADIUS, raydepth=2, pm_ire=True)
SHOOTS = {"diffuse": (1, True), "caustic": (2, False),
          "sppm": (7, False)}      # SPPM's first pass shoots at seed 7
# a lane (camera sample or pixel) may differ where an ulp tie flips its
# path: at most this share of the lanes
LANE_FLIPS = 0.005


def _zoo(builder, param_map):
    b = light_zoo_builder(builder, param_map, j_scenes
                          if builder.__class__ is JSceneBuilder
                          else t_scenes, RES, **SMALL_ZOO)
    for name, params in EXTRA_LIGHTS:
        b.create("light", name, param_map(dict(params)))
    return b.compile_scene()


def _world(js):
    bmin, bmax = jpm.scene_bound(js)
    return (bmin, bmax, np.asarray(0.5 * (bmin + bmax), np.float32),
            float(0.5 * np.linalg.norm(bmax - bmin)))


def _emit_samples():
    return np.random.default_rng(14).uniform(
        size=(4, N_EMIT)).astype(np.float32)


def _np3(a) -> np.ndarray:
    if isinstance(a, V3):
        return np.stack([np.asarray(c) for c in a], axis=-1)
    return np.asarray(a)


@contextlib.contextmanager
def _compiled_gathers():
    """core_tpu's two gathers compiled by jax.jit while the rest runs op
    by op; the same functions, restored after."""
    g, f = jmap.gather_photons, jsppm._gather_flat
    jmap.gather_photons = jax.jit(g, static_argnames=("radius",
                                                      "max_per_cell"))
    jsppm._gather_flat = jax.jit(f, static_argnames=("r_max",))
    try:
        yield
    finally:
        jmap.gather_photons, jsppm._gather_flat = g, f


@contextlib.contextmanager
def _photons_from(module, deposits, to_array):
    """module.shoot_photons returning `deposits` (numpy pos, power, dirn,
    valid) in place of every SPPM pass's shoot, so both packages' passes
    gather the same photons."""
    orig = module.shoot_photons

    def shoot(scene, types_present, n, bounces, seed, mode, *a, **kw):
        assert mode == "sppm" and n == N_PHOTONS and bounces == BOUNCES
        return tuple(to_array(x) for x in deposits)

    module.shoot_photons = shoot
    try:
        yield
    finally:
        module.shoot_photons = orig


def _synthetic_deposits(bmin, bmax):
    """(bounces + 1) x 2,048 seeded deposits inside the box's bound, 200 of
    them in one cell of the RADIUS grid (the k/m compensation runs); 256
    queries, a quarter of them around that cell and some outside the
    bound; normals, albedos, per-query radii.  The shapes are the photon
    maps' and the camera wavefront's, so core_tpu's compiled gathers serve
    both."""
    rng = np.random.default_rng(41)
    p = (BOUNCES + 1) * N_PHOTONS
    lo, hi = np.asarray(bmin, np.float64), np.asarray(bmax, np.float64)
    pos = rng.uniform(lo, hi, (p, 3))
    cell = lo + RADIUS * (np.floor((hi - lo) / RADIUS / 2) + 0.5)
    pos[:200] = rng.uniform(cell - 0.45 * RADIUS, cell + 0.45 * RADIUS,
                            (200, 3))
    dirn = rng.normal(size=(p, 3))
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    q = rng.uniform(lo - 20.0, hi + 20.0, (LANES, 3))
    q[:64] = rng.uniform(cell - 0.5 * RADIUS, cell + 0.5 * RADIUS, (64, 3))
    qn = rng.normal(size=(LANES, 3))
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    f32 = np.float32
    return dict(pos=pos.astype(f32), power=rng.uniform(0.1, 1.0, (p, 3))
                .astype(f32), dirn=dirn.astype(f32),
                valid=rng.uniform(size=p) < 0.8, q=q.astype(f32),
                qn=qn.astype(f32), normal=(-dirn).astype(f32),
                albedo=rng.uniform(0.2, 0.9, (p, 3)).astype(f32),
                r=rng.uniform(5.0, RADIUS, LANES).astype(f32))


def _camera_wavefront(ts):
    """LANES camera rays of a port scene at 16^2: PM_SPP samples a pixel,
    spread across it in x; with render_chunk's QMC offsets (pixel_sample
    = the sample, sampling_offs = fnv(y * fnv(x))), as numpy."""
    s, y, x = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(PM_SPP), torch.arange(RES), torch.arange(RES),
        indexing="ij"))
    rays, _ = shoot_ray(ts.camera, x.float() + (s.float() + 0.5) / PM_SPP,
                        y.float() + 0.5)
    offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    return rays.o.numpy(), rays.d.numpy(), s.numpy(), offs.numpy()


def _j_rays(o, d):
    return JRays(o=jnp.asarray(o), d=jnp.asarray(d), tmin=jnp.zeros(LANES),
                 tmax=jnp.full(LANES, -1.0))


def _t_rays(o, d):
    return Rays(o=torch.from_numpy(o), d=torch.from_numpy(d),
                tmin=torch.zeros(LANES), tmax=torch.full((LANES,), -1.0))


def _core_tpu_side() -> dict:
    """Everything core_tpu computes for this file, as numpy."""
    out = {}
    # emission: every light of the zoo on the same samples
    zoo = _zoo(JSceneBuilder(), JParamMap)
    _, _, center, radius = _world(zoo)
    s = [jnp.asarray(x) for x in _emit_samples()]
    for i, light in enumerate(zoo.lights):
        for k, a in zip("odcp", jemit.emit_photon(
                light, *s, jnp.asarray(center), radius)):
            out[f"emit:{i}:{k}"] = np.broadcast_to(
                np.asarray(a), (N_EMIT, 3) if k != "p" else (N_EMIT,))

    # the three shoots, eagerly
    js = j_cornell_box(**BOX, intersector="brute")
    bmin, bmax, center, radius = _world(js)
    with jax.disable_jit():
        for mode, (seed, surf) in SHOOTS.items():
            for k, a in enumerate(jmap.shoot_photons(
                    js, j_types(js), N_PHOTONS, BOUNCES, seed, mode,
                    jnp.asarray(center), radius, with_surface=surf)):
                out[f"shoot:{mode}:{k}"] = np.asarray(a)

    with _compiled_gathers():
        # the grid and the gathers on seeded deposits
        d = _synthetic_deposits(bmin, bmax)
        g = jmap.build_photon_grid(d["pos"], d["power"], d["dirn"],
                                   d["valid"], RADIUS, bmin, bmax)
        out["grid:order"] = np.asarray(g.order)
        out["grid:cell_start"] = np.asarray(g.cell_start)
        flux, count = jmap.gather_photons(g, d["q"], d["qn"], RADIUS)
        out["grid:flux"], out["grid:count"] = np.asarray(flux), \
            np.asarray(count)
        out["grid:irr"] = np.asarray(jmap.estimate_irradiance(
            g, d["q"], d["qn"], RADIUS))
        cache = jmap.build_radiance_cache(g, d["normal"], d["albedo"],
                                          RADIUS)
        out["grid:cell_rad"] = np.asarray(cache.cell_rad)
        out["grid:lookup"] = np.asarray(jmap.lookup_radiance(cache, d["q"]))
        flux, count = jsppm._gather_flat(g, d["q"], d["qn"], d["r"], RADIUS)
        out["grid:flat_flux"], out["grid:flat_count"] = np.asarray(flux), \
            np.asarray(count)

        # photonmapping on maps from the diffuse and caustic shoots
        popts = JPhotonOptions(**PM)
        dep = [out[f"shoot:diffuse:{k}"] for k in range(6)]
        grid = jmap.build_photon_grid(*dep[:4], popts.diffuse_radius, bmin,
                                      bmax)
        aux = {"diffuse": grid, "fg_cache": jmap.build_radiance_cache(
            grid, dep[4], dep[5], popts.diffuse_radius),
            "caustic": jmap.build_photon_grid(
                *[out[f"shoot:caustic:{k}"] for k in range(4)],
                popts.caustic_radius, bmin, bmax)}
        o, dvec, ps, offs = _camera_wavefront(convert.scene_from_numpy(
            *convert.scene_to_numpy(js), device="cpu"))
        out["pm:rgba"] = np.asarray(jpm.integrate(
            js, j_types(js), _j_rays(o, dvec), jnp.asarray(ps, jnp.int32),
            jnp.asarray(offs, jnp.uint32), popts, aux=aux))

        # the caustic radiance at the camera hits of tests/test_photon.py's
        # box, on the port's caustic map
        pt = PathOptions(**PT)
        tb = t_scenes.cornell_box(**PT_BOX, device="cpu")
        tbmin, tbmax = tpm.scene_bound(tb)
        c, r = tpm.world_sphere(tb, tbmin, tbmax)
        dep = [a.numpy() for a in tmap.shoot_photons(
            tb, scene_material_types(tb), pt.c_photons, pt.caustic_depth, 2,
            "caustic", c, r)]
        for k, a in enumerate(dep):
            out[f"pt_map:{k}"] = a
        jb = j_cornell_box(**PT_BOX, intersector="brute")
        o, dvec, _, _ = _camera_wavefront(tb)
        rays = _j_rays(o, dvec)
        hits = jscene_mod.closest_hit(jb, rays)
        sp = jscene_mod.surface_points(jb, rays, hits)
        p = jscene_mod.material_params(jb, sp)
        out["pt:cc"] = np.asarray(jpm._caustic_radiance(
            jmap.build_photon_grid(*dep, pt.caustic_radius, tbmin, tbmax),
            p, sp, -rays.d, j_types(jb), pt.caustic_radius))
        out["pt:valid"] = np.asarray(hits.valid)

        # SPPM, every pass on the eager seed-7 photons
        table = [out[f"shoot:sppm:{k}"] for k in range(4)]
        so = jsppm.SPPMOptions(**SPPM)
        js = j_cornell_box(**{**BOX, **WIDE}, intersector="brute")
        state = jsppm.HitPoints(
            r2=jnp.full(LANES, so.search_radius ** 2),
            acc_n=jnp.zeros(LANES), tau=jnp.zeros((LANES, 3)),
            direct=jnp.zeros((LANES, 3)))
        with _photons_from(jmap, table, jnp.asarray):
            for k in range(so.passes):
                state = jsppm.one_pass_block(
                    js, j_types(js), state, jnp.asarray(k, jnp.int32), 0,
                    WIDE["resy"], WIDE["resx"], so, js.camera,
                    jnp.asarray(center), radius,
                    bmin, bmax, so.search_radius)
                for f in jsppm.HitPoints._fields:
                    out[f"sppm:{k}:{f}"] = np.asarray(getattr(state, f))
        out["sppm:img"] = np.asarray(jsppm.finalize_sppm(
            state, so.passes, so.photons))
    return out


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    c, by = once_per_run(tmp_path_factory, "torch_photon_core",
                         _core_tpu_side)
    print(f"photon: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return c


@pytest.fixture(scope="module")
def box():
    js = j_cornell_box(**BOX, intersector="brute")
    return _world(js), convert.scene_from_numpy(
        *convert.scene_to_numpy(js), device="cpu")


def _close_but_flips(got, want, what):
    """got against want, [lanes, ...]: at most LANE_FLIPS of the lanes
    differ (ulp-tie flips, printed); on the others every value is within
    rtol 1e-4 / atol 1e-5 and their mean within 1e-5 relative."""
    got = got.reshape(want.shape[0], -1)
    want = want.reshape(want.shape[0], -1)
    assert np.isfinite(got).all(), what
    ok = (np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)).all(axis=1)
    flips = np.nonzero(~ok)[0]
    print(f"{what}: {len(flips)} flipped lanes {flips.tolist()}",
          file=sys.stderr)
    assert len(flips) <= LANE_FLIPS * len(ok), (what, flips)
    jm, tm = want[ok].mean(), got[ok].mean()
    assert abs(tm - jm) <= 1e-5 * abs(jm), (what, tm, jm)


@pytest.mark.parametrize("kind", ["finite", "world"])
def test_emit_photon_matches_core_tpu(core, kind):
    zoo = _zoo(SceneBuilder("cpu"), ParamMap)
    names = [type(x).__name__ for x in zoo.lights]
    assert sorted(names) == sorted([
        "SunLight", "SphereLight", "IesLight", "BgLight", "MeshLight",
        "BgPortalLight", "AreaLight", "PointLight", "SpotLight",
        "DirectionalLight"])
    js_bound = convert.scene_to_numpy(zoo)[0]["geom.verts"]
    bmin, bmax = js_bound.min(0), js_bound.max(0)
    center = torch.tensor(0.5 * (bmin + bmax), dtype=torch.float32)
    radius = float(0.5 * np.linalg.norm(bmax - bmin))
    s = [torch.from_numpy(x) for x in _emit_samples()]
    checked = 0
    for i, light in enumerate(zoo.lights):
        if (names[i] in WORLD) != (kind == "world"):
            continue
        got = temit.emit_photon(light, *s, center, radius)
        for k, a in zip("odcp", got):
            want = core[f"emit:{i}:{k}"]
            tol = TOL
            if (names[i], k) == ("SpotLight", "c"):
                # the falloff divides cos differences by cos_start -
                # cos_end (0.03 here): ulps of the cone's cos and sin grow
                # 30x in the colour near the outer edge
                tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
            np.testing.assert_allclose(
                np.broadcast_to(_np3(a), want.shape), want,
                err_msg=f"{names[i]} {k}", **tol)
        checked += 1
    assert checked == (3 if kind == "world" else 7)


def _first_divergence(j, t, n):
    """Per flipped photon, (its id, its first bounce whose deposit mask
    differs, whether both packages hit the same point of the floor's plane
    y = 0 there: the tie of the floor and the glass block's bottom)."""
    jm, tm = j[3].reshape(-1, n), t[3].reshape(-1, n)
    jp, tp = j[0].reshape(-1, n, 3), t[0].reshape(-1, n, 3)
    out = []
    for i in np.nonzero((jm != tm).any(axis=0))[0]:
        b = int(np.nonzero(jm[:, i] != tm[:, i])[0][0])
        out.append((int(i), b, bool(
            np.abs(jp[b, i] - tp[b, i]).max() < 1e-3
            and abs(jp[b, i, 1]) < 1e-3)))
    return out


@pytest.mark.parametrize("mode", sorted(SHOOTS))
def test_shoot_photons_matches_core_tpu(core, box, mode):
    (_, _, center, radius), ts = box
    seed, surf = SHOOTS[mode]
    got = [a.numpy() for a in tmap.shoot_photons(
        ts, scene_material_types(ts), N_PHOTONS, BOUNCES, seed, mode,
        torch.from_numpy(center), radius, with_surface=surf)]
    want = [core[f"shoot:{mode}:{k}"] for k in range(len(got))]
    assert len(got) == (6 if surf else 4)
    n = N_PHOTONS
    flips = _first_divergence(want, got, n)
    print(f"shoot {mode}: {len(flips)} flipped photons of {n} "
          f"(id, bounce, the tie): {flips}", file=sys.stderr)
    assert all(same for _, _, same in flips), flips
    assert len(flips) <= FLIP_SHARE * n, flips
    keep = np.ones(n, bool)
    keep[[i for i, _, _ in flips]] = False
    keep = np.tile(keep, BOUNCES + 1)
    np.testing.assert_array_equal(got[3][keep], want[3][keep])
    m = keep & want[3]
    assert m.sum() > (100 if mode == "caustic" else 500)
    # the albedo is glossy's eval at its peak, a cosine raised to the
    # exponent: its ulps grow to 2e-5 there
    for k, name, rtol in ((0, "pos", 1e-5), (1, "power", 1e-5),
                          (2, "dirn", 1e-5), (4, "normal", 1e-5),
                          (5, "albedo", 1e-4))[:len(got) - 1]:
        np.testing.assert_allclose(
            got[k][m], want[k][m], rtol=rtol,
            atol=rtol * float(np.abs(want[k][m]).max()), err_msg=name)


def test_photon_grid_and_gathers_match_core_tpu(core, box):
    (bmin, bmax, _, _), _ = box
    d = _synthetic_deposits(bmin, bmax)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    g = convert.photon_map_from_numpy(d["pos"], d["power"], d["dirn"],
                                      d["valid"], RADIUS, bmin, bmax,
                                      device="cpu")
    np.testing.assert_array_equal(g.order.numpy(), core["grid:order"])
    np.testing.assert_array_equal(g.cell_start.numpy(),
                                  core["grid:cell_start"])
    assert int(np.diff(core["grid:cell_start"]).max()) > tmap.MAX_PER_CELL
    q, qn = v3(t["q"]), v3(t["qn"])

    def close(got, key):
        want = core[key]
        np.testing.assert_allclose(_np3(got), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=key)

    flux, count = tmap.gather_photons(g, q, qn, RADIUS)
    close(flux, "grid:flux")
    np.testing.assert_array_equal(count.numpy(), core["grid:count"])
    assert core["grid:count"].max() > tmap.MAX_PER_CELL
    close(tmap.estimate_irradiance(g, q, qn, RADIUS), "grid:irr")
    cache = tmap.build_radiance_cache(g, t["normal"], t["albedo"], RADIUS)
    close(cache.cell_rad, "grid:cell_rad")
    close(tmap.lookup_radiance(cache, q), "grid:lookup")
    flux, count = tsppm._gather_flat(g, q, qn, t["r"], RADIUS)
    close(flux, "grid:flat_flux")
    np.testing.assert_array_equal(count.numpy(), core["grid:flat_count"])


def test_photonmap_render_matches_core_tpu(core, box):
    (bmin, bmax, _, _), ts = box
    popts = PhotonOptions(**PM)
    dep = [core[f"shoot:diffuse:{k}"] for k in range(6)]
    grid = convert.photon_map_from_numpy(*dep[:4], popts.diffuse_radius,
                                         bmin, bmax, device="cpu")
    aux = {"diffuse": grid, "fg_cache": tmap.build_radiance_cache(
        grid, torch.tensor(dep[4]), torch.tensor(dep[5]),
        popts.diffuse_radius), "caustic": convert.photon_map_from_numpy(
        *[core[f"shoot:caustic:{k}"] for k in range(4)],
        popts.caustic_radius, bmin, bmax, device="cpu")}
    o, d, ps, offs = _camera_wavefront(ts)
    with torch.no_grad():
        rgba = tpm.integrate(ts, scene_material_types(ts), _t_rays(o, d),
                             torch.from_numpy(ps), torch.from_numpy(offs),
                             popts, aux=aux)
    _close_but_flips(rgba.numpy(), core["pm:rgba"], "photonmapping")
    assert core["pm:rgba"][..., :3].std() > 0.01


def test_path_photon_caustics_match_core_tpu(core):
    tb = t_scenes.cornell_box(**PT_BOX, device="cpu")
    pt = PathOptions(**PT)
    bmin, bmax = tpm.scene_bound(tb)
    c, r = tpm.world_sphere(tb, bmin, bmax)
    dep = [a.numpy() for a in tmap.shoot_photons(
        tb, scene_material_types(tb), pt.c_photons, pt.caustic_depth, 2,
        "caustic", c, r)]
    for k, a in enumerate(dep):
        np.testing.assert_array_equal(a, core[f"pt_map:{k}"])
    aux = {"caustic": convert.photon_map_from_numpy(
        *dep, pt.caustic_radius, bmin, bmax, device="cpu")}
    # the caustic radiance at the camera hits against core_tpu's
    o, d, ps, offs = _camera_wavefront(tb)
    rays = _t_rays(o, d)
    rs = rays_to_soa(rays)
    hits = tscene_mod.closest_hit_s(tb, rs)
    sp = tscene_mod.surface_points_s(tb, rs, hits)
    p = tscene_mod.material_params_s(tb, sp)
    types = scene_material_types(tb)
    cc = tpm._caustic_radiance(aux["caustic"], p, sp, -rs.d, types,
                               pt.caustic_radius)
    valid = hits.valid.numpy()
    np.testing.assert_array_equal(valid, core["pt:valid"])
    want = core["pt:cc"][valid]
    assert want.max() > 1e-3
    np.testing.assert_allclose(_np3(cc)[valid], want, rtol=1e-5,
                               atol=1e-6 * float(want.max()))
    # the path tracer adds it at the diffuse camera hits, and only there
    ps, offs = torch.from_numpy(ps), torch.from_numpy(offs)
    with torch.no_grad():
        with_map = tpath.integrate(tb, types, rays, ps, offs, pt, aux=aux)
        without = tpath.integrate(tb, types, rays, ps, offs, pt)
    diffuse = hits.valid & ((p.flags & BSDF.DIFFUSE) != 0)
    want = torch.where(diffuse[:, None], torch.stack(list(cc), -1), 0.0)
    torch.testing.assert_close(with_map[:, :3] - without[:, :3], want,
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(with_map[:, 3], without[:, 3])

    # core_tpu's own assertion on the port: the caustic map adds energy on
    # the floor around the glass block (tests/test_photon.py:228-232)
    def render(ctype):
        opts = RenderOptions(integrator="pathtracing", integrator_opts=(
            PathOptions(**{**PT, "caustic_type": ctype})), aa_samples=2,
            spp_chunk=2)
        return render_image(tb, opts)[0].numpy()[..., :3]

    floor = (slice(12, 16), slice(2, 9))
    gain = render("photon")[floor].mean() - render("none")[floor].mean()
    assert gain > 1e-3, gain


def test_sppm_matches_core_tpu(core, box):
    (bmin, bmax, center, radius), ts = box
    so = tsppm.SPPMOptions(**SPPM)
    table = [core[f"shoot:sppm:{k}"] for k in range(4)]
    ts = convert.scene_from_numpy(*convert.scene_to_numpy(j_cornell_box(
        **{**BOX, **WIDE}, intersector="brute")), device="cpu")
    zero = torch.zeros(LANES)
    state = tsppm.HitPoints(r2=torch.full_like(zero, so.search_radius ** 2),
                            acc_n=zero, tau=V3(zero, zero, zero),
                            direct=V3(zero, zero, zero))
    with _photons_from(tmap, table, torch.tensor), torch.no_grad():
        for k in range(so.passes):
            state = tsppm.one_pass_block(
                ts, scene_material_types(ts), state, k, 0, WIDE["resy"],
                WIDE["resx"], so,
                ts.camera, torch.from_numpy(center), radius, bmin, bmax,
                so.search_radius)
            for f in tsppm.HitPoints._fields:
                _close_but_flips(_np3(getattr(state, f)),
                                 core[f"sppm:{k}:{f}"], f"pass {k} {f}")
    img = tsppm.finalize_sppm(state, so.passes, so.photons).numpy()
    _close_but_flips(img, core["sppm:img"], "image")
    assert core["sppm:img"][..., :3].std() > 0.01
    assert float(core["sppm:0:acc_n"].max()) > 0


def test_photon_entry_points(box, tmp_path):
    _, ts = box
    pm = RenderOptions(integrator="photonmapping", integrator_opts=(
        PhotonOptions(**{**PM, "photons": 512, "c_photons": 512})))
    sppm = RenderOptions(integrator="SPPM", integrator_opts=(
        tsppm.SPPMOptions(**{**SPPM, "passes": 1, "photons": 512})))
    pt = RenderOptions(integrator="pathtracing", integrator_opts=(
        PathOptions(**{**PT, "c_photons": 512, "caustic_type": "both"})))
    for opts in (pm, sppm, pt):
        img, film = render_image(ts, opts)
        assert img.shape == (RES, RES, 4) and bool(torch.isfinite(img).all())
        assert float(img[..., :3].mean()) > 0.05
    with pytest.raises(ValueError, match="SPPM"):
        render_chunk(ts, scene_material_types(ts), sppm,
                     tfilm.make_film(RES, RES, device="cpu"), 0, 1, 0)
    # SPPM checkpoints: written after the pass, and a finished render's
    # checkpoint resumes to the same image
    ck = str(tmp_path / "sppm.npz")
    img_ck, _ = render_image(ts, sppm, checkpoint_path=ck)
    assert os.path.isfile(ck)
    img_again, _ = render_image(ts, sppm, checkpoint_path=ck)
    assert torch.equal(img_ck, img_again)
    # device-sharded photons: one shard of one (photon_shard=(0, 1), its
    # gather a stack of one) is the single-device pass, bit for bit
    from core_tpu_torch.integrators.photonmap import scene_bound, world_sphere
    so = sppm.integrator_opts
    bmin, bmax = scene_bound(ts)
    center, world_r = world_sphere(ts, bmin, bmax)
    zero = torch.zeros(RES * RES)
    r0 = float(so.search_radius)
    state = tsppm.HitPoints(r2=torch.full_like(zero, r0 * r0), acc_n=zero,
                            tau=tsppm.zeros3(zero), direct=tsppm.zeros3(zero))
    args = (ts, scene_material_types(ts), state, 0, 0, RES, RES, so,
            ts.camera, center, world_r, bmin, bmax, r0)
    one = tsppm.one_pass_block(*args)
    shard = tsppm.one_pass_block(*args, photon_shard=(0, 1),
                                 photon_axis=lambda t: t[None])
    for a, b in zip([one.r2, one.acc_n, *one.tau, *one.direct],
                    [shard.r2, shard.acc_n, *shard.tau, *shard.direct]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="caustic_type"):
        render_image(ts, RenderOptions(
            integrator="pathtracing",
            integrator_opts=PathOptions(caustic_type="photons")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_scenes.cornell_box(resx=RES, resy=RES)
