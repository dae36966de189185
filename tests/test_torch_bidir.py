"""The bidirectional and debug integrators of the port (lights' emit_pdf,
the film's light image, integrators/bidir.py, integrators/debug.py)
against core_tpu on the same numpy inputs.

core_tpu's side runs once per test run (test_torch_diff.once_per_run) and
eagerly (jax.disable_jit: no FMA contraction, so the maximum heuristic's
comparisons fall the same way in both packages).  Its scr_halton is
replaced by the port's (held bit-equal to core_tpu's eager one by
tests/test_torch_qmc.py): op by op, core_tpu's Faure compare-select chains
at bases up to 229 are ~20 s of a bidirectional wavefront.  Every
wavefront is LANES = 256 wide and the subpaths are 2 vertices deep, so the
primitives compile once for all of it.

- _path_weight (pathWeight's maximum heuristic) for k = 2..5, every s in
  1..k, the light image on and off (s = k, the t=1 technique, on only),
  on seeded lognormal pdf lists with specular and singular lanes: the 0/1
  weights equal on every lane where
  the largest technique pdf beside p[s] is not within 1e-4 relative of
  p[s] (a near-tie may go either way by an ulp), and at most NEAR_TIES of
  the lanes near-ties.
- emit_pdf of all ten light types (test_torch_photon.py's small light
  zoo with an area, a point, a spot and a directional light) at emission
  points and directions from core_tpu's emit_photon, with and without the
  world radius: area, direction pdf and cosine within rtol 1e-5 / atol
  1e-6, the static flags equal.
- add_density_samples + flush on 512 seeded splats (in and out of the
  image, masked) over a 16 x 12 film: density within rtol 1e-5 / atol 1e-6
  (the port sums each pixel's splats in one segment, core_tpu one at a
  time), n_density equal, the flushed image within rtol 1e-5.
- bidir.integrate on the 256 pixel-centre camera rays of a 16^2 Cornell
  box (light_samples=1, eye and light depth 2), the light image on and
  off: rgba within rtol 1e-4 / atol 1e-5 on every lane; the t=1 splats'
  masks equal, their pixel coordinates within 1e-4 and colours within
  rtol 1e-4 / atol 1e-6 where the mask is set, n_paths equal.
- debug.integrate of every debug_type (and N with show_pn) on the 256
  camera rays of golden_mesh_scene(16, 16) (a smooth torus with uvs),
  each package building its own scene: rgba within rtol 1e-4 / atol
  1e-5.
- Entry points: render_image dispatches "bidirectional" (with and without
  the light image) and "debug"; core_tpu's own assertions of
  tests/test_bidir_debug.py hold on the port's renders (the bidirectional
  mean within 40% of the path tracer's at 32^2, the debug normals of a
  16^2 box in [0, 1]); the bidirectional integrator under a checkpoint
  and under aa_passes = 2 renders, a scene with a volume region crosses
  convert.py and the volume factories record their elements, a progress
  bar ticks once per chunk, and an unknown volume region type raises by
  name; a scene built with no device given asks for CUDA.
The card's twins (64^2 bidirectional and debug renders through the
kernels against the plain versions, the bidirectional golden) are in
tests/test_torch_kernels_cuda.py.
"""
import contextlib
import dataclasses
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import film as jfilm
from core_tpu import scene as jscene_mod
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.integrators import bidir as jbidir
from core_tpu.integrators import debug as jdebug
from core_tpu.lights import base as jlight_base
from core_tpu.params import ParamMap as JParamMap
from core_tpu.photon import emit as jemit
from core_tpu.render import scene_material_types as j_types
from core_tpu.sampling import qmc as jqmc
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.scenes import golden_mesh_scene as j_golden_mesh_scene
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import scenes as t_scenes
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.integrators import bidir as tbidir
from core_tpu_torch.integrators import debug as tdebug
from core_tpu_torch.integrators.bidir import BidirOptions
from core_tpu_torch.integrators.debug import DebugOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.lights import base as tlight_base
from core_tpu_torch.params import ParamMap
from core_tpu_torch.render import (RenderOptions, render_image,
                                   scene_material_types)
from core_tpu_torch.sampling import qmc
from core_tpu_torch.types import Rays
from core_tpu_torch.utils.monitor import CallbackProgressBar
from core_tpu_torch.vec import V3, v3

from test_torch_diff import once_per_run
from test_torch_photon import _zoo

torch.set_num_threads(1)
RES = 16
LANES = RES * RES
TOL = dict(rtol=1e-5, atol=1e-6)
DEPTHS = dict(eye_depth=2, light_depth=2)
PIXEL_SAMPLE = 3
NEAR_TIES = 0.01
DEBUG = [(t, False) for t in tdebug.DEBUG_TYPES] + [("N", True)]
N_SPLATS = 512
FILM_HW = (12, 16)


@contextlib.contextmanager
def _port_halton():
    """core_tpu's scr_halton answered by the port's (bit-equal to core_tpu's
    eager one), so an eager core_tpu wavefront skips its compare-select
    chains."""
    def halton(dim, n):
        return jnp.asarray(qmc.scr_halton(dim, torch.from_numpy(
            np.asarray(n).astype(np.int64))).numpy())

    with mock.patch.object(jqmc, "scr_halton", halton):
        yield


def _np3(a) -> np.ndarray:
    if isinstance(a, V3):
        return np.stack([np.broadcast_to(np.asarray(c), np.shape(a[0]))
                         for c in a], axis=-1)
    return np.asarray(a)


def _pdf_lists(k, s, seed):
    """Seeded pdf lists of a length-k path as the integrator fills them:
    lognormal pdfs and G, a specular flag on 15% of the lanes of every
    vertex but s-1, s and k, singular lights on 10% of the lanes."""
    rng = np.random.default_rng(seed)

    def logn():
        return np.exp(rng.normal(0.0, 1.5, LANES)).astype(np.float32)

    pdf_f = [logn() for _ in range(k + 1)]
    pdf_b = [None] + [logn() for _ in range(k)]
    G = [None] + [logn() for _ in range(k)]
    spec = [None if i in (s - 1, s, k) else rng.uniform(size=LANES) < 0.15
            for i in range(k + 1)]
    return dict(pdf_f=pdf_f, pdf_b=pdf_b, G=G, spec=spec, pdf_A_0=logn(),
                singular_l=rng.uniform(size=LANES) < 0.1, pdf_illum=logn(),
                pdf_emit=logn())


def _weight_cases():
    """(k, s, light image): s = k is the t=1 technique, which runs only
    with the light image on."""
    return [(k, s, li) for k in range(2, 6) for s in range(1, k + 1)
            for li in (True, False) if li or s < k]


def _camera_rays(ts):
    y, x = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(RES), torch.arange(RES), indexing="ij"))
    rays, _ = shoot_ray(ts.camera, x.float() + 0.5, y.float() + 0.5)
    offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    return (rays.o.numpy(), rays.d.numpy(),
            np.full(LANES, PIXEL_SAMPLE, np.int64), offs.numpy())


def _j_rays(o, d):
    return JRays(o=jnp.asarray(o), d=jnp.asarray(d), tmin=jnp.zeros(LANES),
                 tmax=jnp.full(LANES, -1.0))


def _t_rays(o, d):
    return Rays(o=torch.from_numpy(o), d=torch.from_numpy(d),
                tmin=torch.zeros(LANES), tmax=torch.full((LANES,), -1.0))


def _splat_inputs():
    rng = np.random.default_rng(15)
    h, w = FILM_HW
    return dict(x=rng.uniform(-2.0, w + 2.0, N_SPLATS).astype(np.float32),
                y=rng.uniform(-2.0, h + 2.0, N_SPLATS).astype(np.float32),
                col=rng.uniform(0.0, 2.0, (N_SPLATS, 3)).astype(np.float32),
                mask=rng.uniform(size=N_SPLATS) < 0.8)


def _emit_samples():
    return np.random.default_rng(16).uniform(size=(4, LANES)) \
        .astype(np.float32)


def _core_tpu_side() -> dict:
    """Everything core_tpu computes for this file, as numpy."""
    out = {}
    with jax.disable_jit(), _port_halton():
        for k, s, li in _weight_cases():
            a = _pdf_lists(k, s, 100 * k + s)
            to_j = lambda v: None if v is None else jnp.asarray(v)  # noqa
            out[f"w:{k}:{s}:{li}"] = np.asarray(jbidir._path_weight(
                [to_j(v) for v in a["pdf_f"]], [to_j(v) for v in a["pdf_b"]],
                [to_j(v) for v in a["G"]], [to_j(v) for v in a["spec"]],
                to_j(a["pdf_A_0"]), s, k, li, to_j(a["singular_l"]),
                to_j(a["pdf_illum"]), to_j(a["pdf_emit"])))

        # emit_pdf at emission points of every light of the small zoo
        zoo = _zoo(JSceneBuilder(), JParamMap)
        v = np.asarray(zoo.geom.verts)
        center = 0.5 * (v.min(0) + v.max(0))
        radius = float(0.5 * np.linalg.norm(v.max(0) - v.min(0)))
        s = [jnp.asarray(x) for x in _emit_samples()]
        for i, light in enumerate(zoo.lights):
            lo, ld, _, _ = jemit.emit_photon(light, *s, jnp.asarray(center),
                                             radius)
            lo = jnp.broadcast_to(lo, (LANES, 3))
            ld = jnp.broadcast_to(ld, (LANES, 3))
            out[f"emit:{i}:o"], out[f"emit:{i}:d"] = np.asarray(lo), \
                np.asarray(ld)
            for r in (None, radius):
                for n, x in zip(("area", "dir", "cos", "sing", "ddir"),
                                jlight_base.emit_pdf(light, lo, ld,
                                                     scene_radius=r)):
                    out[f"emit:{i}:{r is None}:{n}"] = np.broadcast_to(
                        np.asarray(x), (LANES,) if n not in ("sing", "ddir")
                        else ())

        # the light image's splat and flush
        sp = _splat_inputs()
        f = jfilm.make_film(*FILM_HW)
        f = jfilm.add_density_samples(f, jnp.asarray(sp["x"]),
                                      jnp.asarray(sp["y"]),
                                      jnp.asarray(sp["col"]), 7.0,
                                      sample_mask=jnp.asarray(sp["mask"]))
        f = f._replace(rgba=jnp.ones_like(f.rgba), weight=jnp.full(
            FILM_HW, 2.0))
        out["film:density"] = np.asarray(f.density)
        out["film:flush"] = np.asarray(jfilm.flush(f))

        # bidirectional integrate on the 16^2 Cornell box
        js = j_cornell_box(resx=RES, resy=RES, light_samples=1,
                           intersector="brute")
        ts = convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                      device="cpu")
        o, d, ps, offs = _camera_rays(ts)
        for li in (True, False):
            rgba, splat = jbidir.integrate(
                js, j_types(js), _j_rays(o, d), jnp.asarray(ps, jnp.int32),
                jnp.asarray(offs, jnp.uint32),
                jbidir.BidirOptions(do_light_image=li, **DEPTHS))
            out[f"bd:{li}:rgba"] = np.asarray(rgba)
            if li:
                for n, x in zip(("x", "y", "col", "mask", "n"), splat):
                    out[f"bd:splat:{n}"] = np.asarray(x)

        # every debug type on golden_mesh_scene, one closest hit for all
        jg = j_golden_mesh_scene(RES, RES)
        o, d, ps, offs = _camera_rays(t_scenes.golden_mesh_scene(
            RES, RES, device="cpu"))
        rays = _j_rays(o, d)
        hits = jscene_mod.closest_hit(jg, rays)
        with mock.patch.object(jscene_mod, "closest_hit",
                               lambda *a, **kw: hits):
            for t, pn in DEBUG:
                out[f"debug:{t}:{pn}"] = np.asarray(jdebug.integrate(
                    jg, j_types(jg), rays, jnp.asarray(ps, jnp.int32),
                    jnp.asarray(offs, jnp.uint32),
                    jdebug.DebugOptions(debug_type=t, show_pn=pn)))
    return out


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    c, by = once_per_run(tmp_path_factory, "torch_bidir_core",
                         _core_tpu_side)
    print(f"bidir: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return c


@pytest.fixture(scope="module")
def cornell():
    return convert.scene_from_numpy(*convert.scene_to_numpy(j_cornell_box(
        resx=RES, resy=RES, light_samples=1, intersector="brute")),
        device="cpu")


def test_path_weight_matches_core_tpu(core):
    recorded = []
    orig = tbidir._max_heuristic

    def record(p, s):
        recorded.append((p, s))
        return orig(p, s)

    ties = compared = 0
    with mock.patch.object(tbidir, "_max_heuristic", record):
        for k, s, li in _weight_cases():
            a = _pdf_lists(k, s, 100 * k + s)
            to_t = lambda v: None if v is None else torch.from_numpy(v)  # noqa
            got = tbidir._path_weight(
                [to_t(v) for v in a["pdf_f"]], [to_t(v) for v in a["pdf_b"]],
                [to_t(v) for v in a["G"]], [to_t(v) for v in a["spec"]],
                to_t(a["pdf_A_0"]), s, k, li, to_t(a["singular_l"]),
                to_t(a["pdf_illum"]), to_t(a["pdf_emit"])).numpy()
            p, _ = recorded[-1]
            others = [x.numpy() for i, x in enumerate(p)
                      if x is not None and i != s]
            ref = p[s].numpy()
            best = np.max(others, axis=0) if others else np.zeros(LANES)
            near = np.abs(best - ref) <= 1e-4 * np.maximum(np.abs(ref), 1e-30)
            want = core[f"w:{k}:{s}:{li}"]
            assert set(np.unique(got)) <= {0.0, 1.0}
            np.testing.assert_array_equal(got[~near], want[~near],
                                          err_msg=f"k={k} s={s} li={li}")
            ties += int(near.sum())
            compared += LANES
            assert 0 < got.sum() < LANES, (k, s, li)
    assert ties <= NEAR_TIES * compared, (ties, compared)


def test_emit_pdf_matches_core_tpu(core):
    zoo = _zoo(SceneBuilder("cpu"), ParamMap)
    names = sorted(type(x).__name__ for x in zoo.lights)
    assert len(names) == 10 == len(set(names))
    v = zoo.geom.verts.numpy()
    radius = float(0.5 * np.linalg.norm(v.max(0) - v.min(0)))
    for i, light in enumerate(zoo.lights):
        o = v3(torch.tensor(core[f"emit:{i}:o"]))
        d = v3(torch.tensor(core[f"emit:{i}:d"]))
        for r in (None, radius):
            got = tlight_base.emit_pdf(light, o, d, scene_radius=r)
            for n, x in zip(("area", "dir", "cos", "sing", "ddir"), got):
                want = core[f"emit:{i}:{r is None}:{n}"]
                what = f"{type(light).__name__} {n} radius {r}"
                if n in ("sing", "ddir"):
                    assert x == bool(want), what
                else:
                    np.testing.assert_allclose(
                        np.broadcast_to(x.numpy(), want.shape), want,
                        err_msg=what, **TOL)
    # the mesh light's and the portal's emission cosines are not all 1
    mesh = [i for i, x in enumerate(zoo.lights)
            if type(x).__name__ in ("MeshLight", "BgPortalLight")]
    assert all(core[f"emit:{i}:True:cos"].min() < 0.99 for i in mesh)


def test_density_splat_matches_core_tpu(core):
    sp = _splat_inputs()
    f = tfilm.make_film(*FILM_HW, device="cpu")
    f = tfilm.add_density_samples(
        f, torch.from_numpy(sp["x"]), torch.from_numpy(sp["y"]),
        v3(torch.from_numpy(sp["col"])), 7.0,
        sample_mask=torch.from_numpy(sp["mask"]))
    assert float(f.n_density) == 7.0
    np.testing.assert_allclose(f.density.numpy(), core["film:density"], **TOL)
    assert (core["film:density"] > 0).sum() > 100
    f = f._replace(rgba=torch.ones_like(f.rgba),
                   weight=torch.full(FILM_HW, 2.0))
    np.testing.assert_allclose(tfilm.flush(f).numpy(), core["film:flush"],
                               rtol=1e-5)


@pytest.mark.parametrize("light_image", [True, False])
def test_bidir_integrate_matches_core_tpu(core, cornell, light_image):
    o, d, ps, offs = _camera_rays(cornell)
    with torch.no_grad():
        rgba, splat = tbidir.integrate(
            cornell, scene_material_types(cornell), _t_rays(o, d),
            torch.from_numpy(ps), torch.from_numpy(offs),
            BidirOptions(do_light_image=light_image, **DEPTHS))
    want = core[f"bd:{light_image}:rgba"]
    np.testing.assert_allclose(rgba.numpy(), want, rtol=1e-4, atol=1e-5)
    assert want[:, :3].std() > 0.05
    if not light_image:
        assert splat is None
        return
    x, y, col, mask, n_paths = splat
    m = core["bd:splat:mask"]
    np.testing.assert_array_equal(mask.numpy(), m)
    assert n_paths == float(core["bd:splat:n"]) == LANES
    assert m.sum() > LANES // 4
    for got, key in ((x, "x"), (y, "y")):
        np.testing.assert_allclose(got.numpy()[m], core[f"bd:splat:{key}"][m],
                                   rtol=0, atol=1e-4)
    want = core["bd:splat:col"]
    np.testing.assert_allclose(_np3(col), want, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()))


def test_debug_matches_core_tpu(core):
    ts = t_scenes.golden_mesh_scene(RES, RES, device="cpu")
    o, d, ps, offs = _camera_rays(ts)
    for t, pn in DEBUG:
        got = tdebug.integrate(ts, scene_material_types(ts), _t_rays(o, d),
                               torch.from_numpy(ps), torch.from_numpy(offs),
                               DebugOptions(debug_type=t, show_pn=pn))
        want = core[f"debug:{t}:{pn}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{t} show_pn={pn}")
        assert 0 < want[:, 3].sum() < LANES and want[:, :3].std() > 0.01
    with pytest.raises(ValueError, match="debug_type"):
        tdebug.integrate(ts, (), _t_rays(o, d), None, None,
                         DebugOptions(debug_type="Nx"))


def test_bidir_debug_entry_points(cornell, tmp_path):
    # tests/test_bidir_debug.py's assertions on the port's renders
    sc = t_scenes.cornell_box(resx=32, resy=32, light_samples=2,
                              with_blocks=False, device="cpu")
    img_bd, film = render_image(sc, RenderOptions(
        integrator="bidirectional",
        integrator_opts=BidirOptions(eye_depth=3, light_depth=3),
        aa_samples=4, spp_chunk=2))
    img_pt, _ = render_image(sc, RenderOptions(
        integrator="pathtracing",
        integrator_opts=PathOptions(path_samples=4, bounces=3, raydepth=0),
        aa_samples=4, spp_chunk=2))
    m_bd = float(img_bd[..., :3].mean())
    m_pt = float(img_pt[..., :3].mean())
    assert np.isfinite(m_bd) and m_bd > 0
    assert abs(m_bd - m_pt) / m_pt < 0.4, (m_bd, m_pt)
    # the light image: every light path of both chunks counted, splats in
    assert float(film.n_density) == 4 * 32 * 32
    assert float(film.density.sum()) > 0
    img_off, film_off = render_image(sc, RenderOptions(
        integrator="bidirectional",
        integrator_opts=BidirOptions(do_light_image=False), aa_samples=2))
    assert float(film_off.n_density) == 0 and bool(
        torch.isfinite(img_off).all())

    sc = t_scenes.cornell_box(resx=16, resy=16, light_samples=1,
                              with_blocks=False, device="cpu")
    img, _ = render_image(sc, RenderOptions(
        integrator="debug", integrator_opts=DebugOptions(debug_type="N")))
    assert bool(torch.isfinite(img).all())
    assert img[..., :3].min() >= 0.0 and img[..., :3].max() <= 1.0

    bd = RenderOptions(integrator="bidirectional",
                       integrator_opts=BidirOptions())
    with pytest.raises(TypeError, match="BidirOptions"):
        render_image(cornell, RenderOptions(integrator="bidirectional"))
    ck = str(tmp_path / "bd.npz")
    img_ck, _ = render_image(cornell, bd, checkpoint_path=ck)
    assert os.path.isfile(ck) and bool(torch.isfinite(img_ck).all())
    ticks = []
    img2, _ = render_image(cornell, RenderOptions(
        aa_passes=2, integrator="debug", integrator_opts=DebugOptions()),
        progress=CallbackProgressBar(
            lambda done, total, tag: ticks.append((done, total))))
    assert bool(torch.isfinite(img2).all())
    # a progress bar ticks once per chunk (two passes of one), then done()
    assert ticks == [(1, 2), (2, 2), (2, 2)]
    js = j_cornell_box(resx=RES, resy=RES, light_samples=1,
                       intersector="brute")
    from core_tpu.volumes import make_uniform_volume
    fog = make_uniform_volume(sigma_a=0.01, bmax=(556, 548.8, 559.2))
    tv = convert.scene_from_numpy(*convert.scene_to_numpy(
        dataclasses.replace(js, volumes=(fog,))), device="cpu").volumes
    assert len(tv) == 1 and type(tv[0]).__name__ == "UniformVolume"
    np.testing.assert_array_equal(tv[0].bmax.numpy(), np.asarray(fog.bmax))
    b = SceneBuilder("cpu")
    for kind in ("bidirectional", "DebugIntegrator"):
        p = ParamMap({"type": kind, "light_depth": 3})
        assert b.create("integrator", "integr", p) is p
        assert b.integrator_params is p
    p = ParamMap({"type": "SkyIntegrator"})
    assert b.create("integrator", "vol", p) is p
    assert b.volume_integrator_params is p
    b.create("volumeregion", "vol", ParamMap({"type": "UniformVolume"}))
    assert len(b.volumes) == 1
    with pytest.raises(NotImplementedError, match="FogVolume"):
        b.create("volumeregion", "vol", ParamMap({"type": "FogVolume"}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_scenes.cornell_box(resx=RES, resy=RES)
