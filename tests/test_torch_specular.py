"""The specular chains and the glass family of the port against core_tpu's,
on the same numpy inputs.  core_tpu runs eagerly (jax.disable_jit), with
its CPU brute-force intersector: jitted XLA contracts multiply-adds into
FMAs, eager JAX does not, and an ulp in a branch pick's luminance or in
scr_halton can flip a lane's whole path.

- Materials, module by module, on 4,096 random lanes (random geometric
  and shading normals, so entering, exiting and total-internal-reflection
  lanes all occur; the counts are asserted): glass sample_bsdf_s,
  get_specular_s and transparency_s on smooth rows (one with fake shadows)
  and on rough GGX rows (tests/test_materials.py's ROUGH_DEF and a tinted
  copy), shinydiffuse's mirror get_specular_s and transparency_s (Fresnel
  and plain mirrors, transparent rows), and spectrum's wavelength,
  cauchy_coefficients + cauchy_ior and wl2rgb.  Floats within rtol 1e-5 /
  atol 1e-6 and flags and masks bit-equal on every lane, with two
  exceptions that _check states: lanes at a hemisphere tie, and up to 20
  rough-glass lanes held at rtol 1e-4 / atol 1e-5.
- The chain, forward and backward in one core_tpu run: jax.vjp of
  core_tpu's recursive_raytrace (raydepth=3; each chain hit shaded with
  its diffuse colour plus its emission where the branch was specular, so
  the chain's picks, throughput and emission gate are what is compared;
  the integrators' own shading is compared below) on the 256 camera
  lanes of a 16x16 ("glossy", "glass") Cornell box (light_samples=1),
  with a seeded cotangent, against the port's torch.autograd.grad, with
  respect to the material table's filter_color, mirror_color and
  glossy_color; once as built and once with the glass row's dispersion
  at 0.1.  Per-lane radiance within rtol 1e-4 / atol 1e-5 on all but
  MAX_FLIPS lanes (a lane that took another branch at a tie would miss
  it; none does on these inputs); gradients within 1e-4 x max|g| of each
  column, elementwise.
- dispatch's get_specular_s and transparency_ss on lanes of all those rows
  at once, with the same tolerances.
- The slice as a whole: path.integrate (path_samples=1, bounces=2,
  raydepth=3) and direct.integrate (raydepth=3) of both packages on the
  same 256-lane camera wavefront of that scene, per-lane rgba, with the
  same tolerance and the same count; the same for the blend box
  (block_materials=("blend_diff", "blend_cross")), whose cross-family
  block picks glossy or glass per lane from the integrators' pick seeds,
  direct-lit and path-traced (raydepth=1), and for the path tracer with
  its chain paths off (chain_path_samples=-1, bounces=1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import scene as jscene
from core_tpu import vec as jvec
from core_tpu.integrators import direct as jdirect
from core_tpu.integrators import path as jpath
from core_tpu.integrators import raytrace as jraytrace
from core_tpu.materials import dispatch as jdispatch
from core_tpu.materials import glass as jglass
from core_tpu.materials import shinydiffuse as jshiny
from core_tpu.materials.base import MaterialDef as JMaterialDef
from core_tpu.materials.base import build_material_table as j_table
from core_tpu.materials.base import gather_params as j_gather
from core_tpu.materials.base import gather_params_s as j_gather_s
from core_tpu.render import scene_material_types as j_types
from core_tpu.sampling import spectrum as jspectrum
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.types import Rays as JRays
from core_tpu.types import SurfacePoints as JSP
from core_tpu_torch import convert
from core_tpu_torch import scene as tscene
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.integrators import direct as tdirect
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.integrators import raytrace as traytrace
from core_tpu_torch.materials import dispatch as tdispatch
from core_tpu_torch.materials import glass as tglass
from core_tpu_torch.materials import shinydiffuse as tshiny
from core_tpu_torch.materials.base import BSDF, MatType
from core_tpu_torch.materials.base import MaterialDef as TMaterialDef
from core_tpu_torch.materials.base import build_material_table as t_table
from core_tpu_torch.materials.base import gather_params_s as t_gather_s
from core_tpu_torch.render import scene_material_types as t_types
from core_tpu_torch.sampling import qmc, spectrum as tspectrum
from core_tpu_torch.vec import SPS, V3, RaysS, dot3, v3, where3

torch.set_num_threads(1)
N = 4096
RES = 16
MAX_FLIPS = 2      # lanes of a chain or an image that may flip at a tie
MAX_TIES = 2       # material lanes that may differ at a hemisphere tie
COLS = ("filter_color", "mirror_color", "glossy_color")

# material rows: smooth glass (plain, tinted with fake shadows), rough glass
# (test_materials.py's ROUGH_DEF, and a tinted one), and shiny-diffuse
# mirrors and transparent layers
MATS = [
    dict(mtype=MatType.GLASS, ior=1.5),
    dict(mtype=MatType.GLASS, ior=1.33, filter_color=(0.9, 0.7, 0.5),
         mirror_color=(0.8, 0.9, 1.0), fake_shadows=True),
    dict(mtype=MatType.ROUGH_GLASS, ior=1.5, alpha_rough=0.25),
    dict(mtype=MatType.ROUGH_GLASS, ior=1.7, alpha_rough=0.6,
         filter_color=(0.6, 0.8, 0.9), mirror_color=(0.9, 0.8, 0.7)),
    dict(mirror_strength=1.0, diffuse_strength=0.0,
         mirror_color=(0.9, 0.9, 0.9)),
    dict(mirror_strength=0.6, fresnel=True, ior=1.4, transparency=0.3,
         diffuse_color=(0.7, 0.3, 0.2), transmit_filter=0.6),
    dict(transparency=0.5, diffuse_color=(0.2, 0.6, 0.4),
         transmit_filter=0.4),
]
ROWS = {"smooth": [0, 1], "rough": [2, 3], "shiny": [4, 5, 6]}


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _lanes(rows, seed=0):
    """4,096 random shading records over the given material rows; both
    packages' parameter rows and surface points, and wo, s1, s2."""
    rng = np.random.default_rng(seed)
    ng = _unit(rng.normal(size=(N, 3)))
    n = _unit(ng + 0.3 * rng.normal(size=(N, 3)))
    nu = _unit(np.cross(n, _unit(rng.normal(size=(N, 3)))))
    nv = np.cross(n, nu)
    wo = _unit(rng.normal(size=(N, 3)))
    mat = rng.choice(rows, N).astype(np.int32)
    s1, s2 = rng.random(N), rng.random(N)
    f32 = [a.astype(np.float32) for a in (ng, n, nu, nv, wo, s1, s2)]
    ng, n, nu, nv, wo, s1, s2 = f32
    zero = np.zeros((N, 3), np.float32)
    ints = np.zeros(N, np.int32)
    jsp = JSP(p=jnp.asarray(zero), n=jnp.asarray(n), ng=jnp.asarray(ng),
              nu=jnp.asarray(nu), nv=jnp.asarray(nv),
              uv=jnp.zeros((N, 2)), mat=jnp.asarray(mat),
              light=jnp.asarray(ints - 1), prim=jnp.asarray(ints),
              obj=jnp.asarray(ints))
    t = torch.from_numpy
    tsp = SPS(p=v3(t(zero)), n=v3(t(n)), ng=v3(t(ng)), nu=v3(t(nu)),
              nv=v3(t(nv)), u=torch.zeros(N), v=torch.zeros(N),
              mat=t(mat), light=t(ints - 1), prim=t(ints), obj=t(ints))
    jp = j_gather(j_table([JMaterialDef(**m) for m in MATS]),
                  jnp.asarray(mat))
    tp = t_gather_s(t_table([TMaterialDef(**m) for m in MATS], "cpu"),
                    t(mat))
    return (jp, jsp, jnp.asarray(wo), jnp.asarray(s1), jnp.asarray(s2),
            tp, tsp, v3(t(wo)), t(s1), t(s2))


def _lane_mismatch(got, want, rtol, atol):
    """[N] bool: lanes where a port result (V3, tensor or NamedTuple of
    them) and core_tpu's ([N, 3] or [N] arrays) differ: a float beyond
    rtol / atol, or any other value not bit-equal."""
    if hasattr(got, "_fields") and not isinstance(got, V3):
        out = np.zeros(N, bool)
        for f in got._fields:
            out |= _lane_mismatch(getattr(got, f), getattr(want, f), rtol,
                                  atol)
        return out
    if isinstance(got, V3):
        got = torch.stack(tuple(got), dim=-1)
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    else:
        bad = got != want
    return bad.reshape(N, -1).any(-1)


def _check(pairs, ties=None, max_loose=0):
    """Every (port, core_tpu) pair agrees on every lane within rtol 1e-5 /
    atol 1e-6, masks and flags bit-equal, but for max_loose lanes, which
    must still agree within rtol 1e-4 / atol 1e-5 (the GGX refraction
    Jacobian, 1 / (ior_o wo.h + ior_i wi.h)^2, magnifies an ulp of sin,
    cos or rsqrt near grazing half vectors), and for lanes at a tie
    (`ties`: a mask of lanes whose hemisphere test, cos(n, wo) > 0, is
    within 1e-7 of its threshold, so an ulp of the normalized normal picks
    the side), at most MAX_TIES of which may differ at all."""
    strict = np.zeros(N, bool)
    loose = np.zeros(N, bool)
    for got, want in pairs:
        strict |= _lane_mismatch(got, want, 1e-5, 1e-6)
        loose |= _lane_mismatch(got, want, 1e-4, 1e-5)
    ties = np.zeros(N, bool) if ties is None else ties
    assert not (loose & ~ties).any(), np.nonzero(loose & ~ties)[0]
    assert (strict & ties).sum() <= MAX_TIES, np.nonzero(strict & ties)[0]
    assert (strict & ~ties).sum() <= max_loose, np.nonzero(strict)[0]


def _geometry_counts(jsp, wo, ior=1.5):
    """(entering, exiting, total internal reflection) lane counts."""
    ng, n, wo = (np.asarray(a) for a in (jsp.ng, jsp.n, wo))
    entering = (ng * wo).sum(-1) > 0
    c = np.abs((n * wo).sum(-1))
    tir = ~entering & (ior * ior * (1.0 - c * c) >= 1.0)
    return entering.sum(), (~entering).sum(), tir.sum()


@pytest.mark.parametrize("kind", ["smooth", "rough"])
def test_glass_matches_core_tpu(kind):
    """sample_bsdf_s (every flag set the integrators ask for),
    get_specular_s and transparency_s of the glass family."""
    jp, jsp, jwo, js1, js2, tp, tsp, two, ts1, ts2 = _lanes(ROWS[kind])
    ent, ext, tir = _geometry_counts(jsp, jwo)
    assert ent > 1000 and ext > 1000 and tir > 200, (ent, ext, tir)
    pairs = []
    with jax.disable_jit():
        for flags in (BSDF.ALL, BSDF.GLOSSY | BSDF.REFLECT | BSDF.TRANSMIT):
            got = tglass.sample_bsdf_s(tp, tsp, two, ts1, ts2, flags)
            pairs.append((got, jglass.sample_bsdf(jp, jsp, jwo, js1, js2,
                                                  flags)))
            assert (got.pdf > 0).float().mean() > 0.5
            assert len(set(got.flags.tolist())) >= 2
        spec = tglass.get_specular_s(tp, tsp, two)
        pairs += [(spec, jglass.get_specular(jp, jsp, jwo)),
                  (tglass.transparency_s(tp, tsp, two),
                   jglass.transparency(jp, jsp, jwo))]
    cos = dot3(tglass._glass_normal(tsp, two), two).abs().numpy()
    # on these inputs: 17 tie lanes, 1 of which differs; the rough rows
    # have 9 lanes between the two tolerances, the smooth ones none
    _check(pairs, ties=cos < 1e-7, max_loose=0 if kind == "smooth" else 20)
    if kind == "smooth":
        # TIR lanes reflect white; every smooth lane has a reflect branch
        assert bool(spec.refl_valid.all())
        assert 200 < int((~spec.refr_valid).sum()) < N // 2
    else:
        assert not bool(spec.refl_valid.any() | spec.refr_valid.any())


def test_mirror_matches_core_tpu():
    """shinydiffuse's mirror and straight-through branches, and its
    shadow transparency."""
    jp, jsp, jwo, _, _, tp, tsp, two, _, _ = _lanes(ROWS["shiny"], seed=1)
    with jax.disable_jit():
        got = tshiny.get_specular_s(tp, tsp, two)
        _check([(got, jshiny.get_specular(jp, jsp, jwo)),
                (tshiny.transparency_s(tp, tsp, two),
                 jshiny.transparency(jp, jsp, jwo))])
    assert 1000 < int(got.refl_valid.sum()) < N
    assert 1000 < int(got.refr_valid.sum()) < N


def test_dispatch_matches_core_tpu():
    """dispatch's get_specular_s and transparency_ss on lanes of every row
    (glass, rough glass and shiny-diffuse): each family's result on its own
    lanes, by core_tpu's per-family masks."""
    _, jsp, jwo, _, _, tp, tsp, two, _, _ = _lanes(range(len(MATS)), seed=4)
    mats = np.asarray(jsp.mat)
    jp = j_gather_s(j_table([JMaterialDef(**m) for m in MATS]), jsp.mat)
    types = tuple(sorted({int(m.get("mtype", MatType.SHINY_DIFFUSE))
                          for m in MATS}))
    jsps, jwos = jvec.sp_to_soa(jsp), jvec.v3(jwo)
    with jax.disable_jit():
        spec = tdispatch.get_specular_s(types, tp, tsp, two)
        want = jdispatch.get_specular_s(types, jp, jsps, jwos)
        tr = tdispatch.transparency_ss(types, tp, tsp, two)
        jtr = jdispatch.transparency_ss(types, jp, jsps, jwos)
    _check([(spec, want._replace(**{
        f: jvec.aos(getattr(want, f)) for f in ("refl_dir", "refl_col",
                                                "refr_dir", "refr_col")})),
            (tr, jvec.aos(jtr))],
           ties=dot3(tglass._glass_normal(tsp, two), two).abs().numpy()
           < 1e-7)
    # every family contributes: glass reflects white on TIR, the rough
    # rows have no specular branch, shiny rows transmit through transparency
    rough = np.isin(mats, ROWS["rough"])
    assert not bool(spec.refl_valid[torch.from_numpy(rough)].any())
    assert bool(spec.refl_valid[torch.from_numpy(np.isin(
        mats, ROWS["smooth"]))].all())
    transparent = [i for i, m in enumerate(MATS) if m.get("transparency")]
    assert float(tr.x[torch.from_numpy(np.isin(mats, transparent))]
                 .abs().min()) > 0.0


def test_spectrum_matches_core_tpu():
    rng = np.random.default_rng(2)
    w = rng.random(N).astype(np.float32)
    ior = (1.3 + 0.5 * rng.random(N)).astype(np.float32)
    power = (0.2 * rng.random(N)).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    with jax.disable_jit():
        ta, tb = tspectrum.cauchy_coefficients(torch.from_numpy(ior),
                                               torch.from_numpy(power))
        ja, jb = jspectrum.cauchy_coefficients(jnp.asarray(ior),
                                               jnp.asarray(power))
        _check([(tspectrum.wavelength(tw), jspectrum.wavelength(jw)),
                (tspectrum.cauchy_ior(tw, ta, tb),
                 jspectrum.cauchy_ior(jw, ja, jb)),
                (tspectrum.wl2rgb(tw), jspectrum.wl2rgb(jw))])


# --------------------------------------------------------------------------
# the chain and the integrators on the ("glossy", "glass") Cornell box
# --------------------------------------------------------------------------

def _scenes(dispersion, blocks=("glossy", "glass")):
    js = j_cornell_box(resx=RES, resy=RES, light_samples=1,
                       block_materials=blocks, intersector="brute")
    if dispersion:
        d = np.where(np.asarray(js.materials.mtype) == int(MatType.GLASS),
                     np.float32(dispersion), np.float32(0.0))
        js = dataclasses.replace(js, materials=js.materials._replace(
            dispersion=jnp.asarray(d)))
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


@pytest.fixture(scope="module")
def camera():
    """The 256 pixel-centre camera rays of the 16x16 box and their QMC
    keys, as render_chunk makes them for one sample per pixel."""
    js, ts = _scenes(0.0)
    ys, xs = torch.meshgrid(torch.arange(RES), torch.arange(RES),
                            indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    rays, _ = shoot_ray(ts.camera, x.float() + 0.5, y.float() + 0.5)
    so = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    ps = torch.zeros_like(x)
    jrays = JRays(*(jnp.asarray(a.numpy()) for a in rays))
    return (js, ts, rays, ps, so, jrays, jnp.asarray(ps.numpy(), jnp.uint32),
            jnp.asarray(so.numpy(), jnp.uint32))


def _flips(got, want):
    """Lanes out of tolerance (rtol 1e-4 / atol 1e-5 on any channel)."""
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    return int((~close.reshape(close.shape[0], -1).all(-1)).sum())


@pytest.mark.parametrize("dispersion", [0.0, 0.1])
def test_chain_and_its_gradients_match_core_tpu(camera, dispersion):
    _, _, rays, ps, so, jrays, jps, jso = camera
    js, ts = _scenes(dispersion)
    n = rays.o.shape[0]
    ct = np.random.default_rng(3).random((n, 3)).astype(np.float32)
    jtypes = j_types(js)

    def j_chain(*cols):
        sc = dataclasses.replace(js, materials=js.materials._replace(
            **dict(zip(COLS, cols))))
        hits = jscene.closest_hit(sc, jrays)
        sp = jscene.surface_points(sc, jrays, hits)
        p = jscene.material_params(
            sc, sp, pick_seed=np.uint32(9781) * jps + jso)

        def shade_fn(nrays, nhits, include_lights, active):
            nsp = jscene.surface_points(sc, nrays, nhits)
            np_ = jscene.material_params(sc, nsp)
            col = jnp.where(include_lights[..., None],
                            jdispatch.emit(jtypes, np_), 0.0)
            return col + np_.diffuse_color, nsp, np_
        return jraytrace.recursive_raytrace(sc, jtypes, jrays, hits, sp, p,
                                            shade_fn, jps, jso, 3)

    with jax.disable_jit():
        want, vjp = jax.vjp(j_chain, *(getattr(js.materials, c)
                                       for c in COLS))
        want_g = vjp(jnp.asarray(ct))
    want = np.asarray(want)

    leaves = [getattr(ts.materials, c).clone().requires_grad_()
              for c in COLS]
    sc = dataclasses.replace(ts, materials=ts.materials._replace(
        **dict(zip(COLS, leaves))))
    ttypes = t_types(sc)
    rs = RaysS(o=v3(rays.o), d=v3(rays.d), tmin=rays.tmin, tmax=rays.tmax)
    hits = tscene.closest_hit_s(sc, rs)
    sp = tscene.surface_points_s(sc, rs, hits)
    p = tscene.material_params_s(sc, sp,
                                 pick_seed=(9781 * ps + so) & qmc.MASK32)

    def shade_fn(nrays, nhits, include_lights, active):
        nsp = tscene.surface_points_s(sc, nrays, nhits)
        np_ = tscene.material_params_s(sc, nsp)
        col = where3(include_lights, tdispatch.emit_ss(ttypes, np_), 0.0)
        return col + np_.diffuse_color, nsp, np_
    got = traytrace.recursive_raytrace(sc, ttypes, rs, hits, sp, p,
                                       shade_fn, ps, so, 3)
    loss = sum((c * torch.from_numpy(ct[:, i])).sum()
               for i, c in enumerate(got))
    got_g = torch.autograd.grad(loss, leaves)
    got = torch.stack(tuple(got), dim=-1).detach().numpy()

    assert np.isfinite(got).all() and got.max() > 0.1
    assert _flips(got, want) <= MAX_FLIPS
    glass_row = int(np.nonzero(np.asarray(js.materials.mtype)
                               == int(MatType.GLASS))[0][0])
    for name, g, w in zip(COLS, got_g, want_g):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all(), name
        scale = np.abs(w).max()
        assert scale > 0.0, name
        np.testing.assert_array_less(np.abs(g - w), 1e-4 * scale + 1e-30,
                                     err_msg=name)
    for name in ("filter_color", "mirror_color"):
        assert np.abs(got_g[COLS.index(name)][glass_row].numpy()).max() > 0


# (block materials, integrator, PathOptions beyond path_samples=1,
# bounces=2, raydepth=3): the blend box holds the blend picks' seed streams
# (camera hits, each path bounce, the chains' hits) lane for lane; the
# last case turns the chain paths off
INTEGRATE = {
    "path": (("glossy", "glass"), "path", {}),
    "direct": (("glossy", "glass"), "direct", {}),
    "blend-direct": (("blend_diff", "blend_cross"), "direct", {}),
    "blend-path": (("blend_diff", "blend_cross"), "path", dict(raydepth=1)),
    "path-chain_off": (("glossy", "glass"), "path",
                       dict(chain_path_samples=-1, bounces=1)),
}


@pytest.mark.parametrize("case", list(INTEGRATE))
def test_integrate_matches_core_tpu(camera, case):
    blocks, integrator, extra = INTEGRATE[case]
    js, ts, rays, ps, so, jrays, jps, jso = camera
    if blocks != ("glossy", "glass"):
        js, ts = _scenes(0.0, blocks)
    if integrator == "path":
        kw = dict(dict(path_samples=1, bounces=2, raydepth=3), **extra)
        with torch.no_grad():
            got = tpath.integrate(ts, t_types(ts), rays, ps, so,
                                  tpath.PathOptions(**kw))
        with jax.disable_jit():
            want = jpath.integrate(js, j_types(js), jrays, jps, jso,
                                   jpath.PathOptions(**kw))
    else:
        with torch.no_grad():
            got = tdirect.integrate(ts, t_types(ts), rays, ps, so,
                                    tdirect.DirectOptions(raydepth=3))
        with jax.disable_jit():
            want = jdirect.integrate(js, j_types(js), jrays, jps, jso,
                                     jdirect.DirectOptions(raydepth=3))
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    assert _flips(got, want) <= MAX_FLIPS
    # the blocks are in view and the chains reach them
    hit_mat = ts.geom.tri_mat[tscene.closest_hit_s(
        ts, RaysS(o=v3(rays.o), d=v3(rays.d), tmin=rays.tmin,
                  tmax=rays.tmax)).prim.clamp_min(0).long()]
    assert int((hit_mat >= 4).sum()) > 20
