"""The textured mesh scene and the directlight slice against core_tpu.

core_tpu's mesh_scene and the port's are built at a small size (n_grid=24,
torus 24x12: 1,634 triangles; 32x32; ibl_samples=2, sun_samples=1) and
compared leaf by leaf through convert.scene_to_numpy: geometry with the
smoothed normals and UVs, materials, texture defs, background, the IBL
CDFs and the sun.  The marble, voronoi and clouds textures, the glossy
material and the background and sun light samples are compared on the same
numpy inputs, and the whole slice as one 32x32 render_chunk: directlight
with raydepth=1, on the port with the grouped accel forced (group=8, so
kernels 7 and 8's plain versions serve every query), against core_tpu's
eager render_chunk (brute-force intersector).  core_tpu's render is not
jitted: that costs minutes here, the eager one about 20 s.

Tolerances: textures and lights within rtol 1e-5 / atol 1e-6 (ulp-level
differences of sin, pow, atan2 and acos between XLA and torch); glossy
within rtol 1e-4 / atol 1e-6, since its Blinn term raises a cosine to the
80th power, which turns an ulp of the half vector's rsqrt into ~80.
The render: >= 99% of pixel channels within rtol 1e-4 / atol 1e-5 and the
image mean within 1e-5 relative.  It is not bit-exact for the same reasons,
and because XLA:CPU contracts multiply-adds into FMAs: an ulp can move a
sample across a shadow or texture-cell boundary.  At this size one pixel
of 1,024 (3 channels) differs, by 1.7e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from core_tpu import film as jfilm
from core_tpu import vec as jvec
from core_tpu.geometry import cluster_intersect as jck
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.lights import base as jlights
from core_tpu.materials import glossy as jglossy
from core_tpu.materials.base import gather_params as j_gather_params
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.render import render_chunk as j_render_chunk
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import mesh_scene as j_mesh_scene
from core_tpu.textures.base import eval_texture_def as j_eval_texture_def
from core_tpu.types import SurfacePoints as JSurfacePoints
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import render
from core_tpu_torch.cameras import make_perspective
from core_tpu_torch import vec as tvec
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.lights import base as tlights
from core_tpu_torch.materials import glossy as tglossy
from core_tpu_torch.materials.base import BSDF, gather_params_s
from core_tpu_torch.render import RenderOptions, render_chunk, \
    scene_material_types
from core_tpu_torch.scenes import mesh_scene
from core_tpu_torch.textures.base import eval_texture_def

torch.set_num_threads(1)
RES = 32
SMALL = dict(resx=RES, resy=RES, n_grid=24, torus_u=24, torus_v=12,
             ibl_samples=2, sun_samples=1)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    js = j_mesh_scene(**SMALL)
    ts = mesh_scene(**SMALL, device="cpu")
    # the grouped accel forced onto the small scene, on both sides
    cl = jck.build_clusters(np.asarray(js.geom.verts),
                            np.asarray(js.geom.tri_vidx))
    jcl = cl._replace(grouped=jck.group_clusters(
        cl, group=8, sort_origin=np.asarray(js.camera.pos)))
    tacc = ci.to_device(ci.group_clusters(
        ci.build_clusters(ts.geom.verts.numpy(), ts.geom.tri_vidx.numpy()),
        group=8, sort_origin=ts.camera.pos.numpy()), "cpu")
    return js, ts, jcl, dataclasses.replace(ts, accel=tacc)


def test_mesh_scene_equals_core_tpu_leaf_by_leaf(scenes):
    js, ts, jcl, tsg = scenes
    assert js.accel is None and ts.accel is None   # 1,634 tris: brute path
    for jscene, tscene in ((js, ts), (dataclasses.replace(js, accel=jcl),
                                      tsg)):
        jl, jst = convert.scene_to_numpy(jscene)
        tl, tst = convert.scene_to_numpy(tscene)
        assert jl.keys() == tl.keys()
        for k in jl:
            assert jl[k].dtype == tl[k].dtype, k
            np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)
        assert jst == tst
    assert [ls["type"] for ls in tst["lights"]] == ["SunLight", "BgLight"]
    assert tl["geom.smooth"].all() and tl["geom.uvs"].any()
    assert tl["lights.1.u_cdf"].shape == (128, 256)
    # the converted core_tpu scene is the port's scene
    back = convert.scene_from_numpy(jl, jst, device="cpu")
    for f in ci.GroupedAccel._fields:
        assert torch.equal(getattr(back.accel, f), getattr(tsg.accel, f)), f


def _points(seed, n=2048):
    rng = np.random.default_rng(seed)
    return rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["rockmarble", "cellvor", "skytex"])
def test_textures_match(scenes, name):
    js, ts, _, _ = scenes
    i = [d.name for d in js.textures.defs].index(name)
    p = _points(i)
    uv = np.zeros((p.shape[0], 2), np.float32)
    want = np.asarray(j_eval_texture_def(js.textures, i, jnp.asarray(p),
                                         jnp.asarray(uv)))
    tuv = torch.from_numpy(uv)
    rgb, alpha = eval_texture_def(ts.textures, i,
                                  tvec.v3(torch.from_numpy(p)),
                                  (tuv[:, 0], tuv[:, 1]))
    got = np.stack([rgb.x, rgb.y, rgb.z, alpha], axis=-1)
    np.testing.assert_allclose(got, want, **TOL)
    assert want[:, 3].std() > 0.05          # the texture varies


def _surface(seed, n=2048):
    """Random unit normals, a tilted geometric normal, a frame, wo and wi,
    and the samples, as numpy."""
    rng = np.random.default_rng(seed)

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)) \
            .astype(np.float32)
    n = unit(rng.normal(size=(n, 3)))
    ng = unit(n + 0.2 * rng.normal(size=n.shape))
    nu = unit(np.cross(n, rng.normal(size=n.shape)))
    nv = np.cross(n, nu).astype(np.float32)
    wo = unit(n + rng.normal(size=n.shape))
    wi = unit(n + rng.normal(size=n.shape))
    s1, s2 = rng.uniform(size=(2, n.shape[0])).astype(np.float32)
    return dict(n=n, ng=ng, nu=nu, nv=nv, wo=wo, wi=wi, s1=s1, s2=s2)


def _sps(s, mat):
    zeros = torch.zeros(s["n"].shape[0])
    ids = torch.full((s["n"].shape[0],), mat, dtype=torch.int32)
    return tvec.SPS(p=tvec.v3(torch.zeros(s["n"].shape)),
                    **{k: tvec.v3(torch.from_numpy(s[k]))
                       for k in ("n", "ng", "nu", "nv")},
                    u=zeros, v=zeros, mat=ids, light=ids, prim=ids, obj=ids)


def _jsp(s, mat):
    n = s["n"].shape[0]
    ids = jnp.full(n, mat, jnp.int32)
    return JSurfacePoints(p=jnp.zeros((n, 3)), n=jnp.asarray(s["n"]),
                          ng=jnp.asarray(s["ng"]), nu=jnp.asarray(s["nu"]),
                          nv=jnp.asarray(s["nv"]), uv=jnp.zeros((n, 2)),
                          mat=ids, light=ids, prim=ids, obj=ids)


def _np3(v):
    return np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], axis=-1)


@pytest.mark.parametrize("req", [BSDF.ALL, BSDF.GLOSSY | BSDF.REFLECT
                                 | BSDF.TRANSMIT])
def test_glossy_matches(scenes, req):
    js, ts, _, _ = scenes
    mat = 1                                   # the torus: glossy
    s = _surface(int(req))
    n = s["n"].shape[0]
    jp = j_gather_params(js.materials, jnp.full(n, mat, jnp.int32))
    tp = gather_params_s(ts.materials, torch.full((n,), mat))
    jsp, tsp = _jsp(s, mat), _sps(s, mat)
    wo, wi = (tvec.v3(torch.from_numpy(s[k])) for k in ("wo", "wi"))
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        _np3(tglossy.eval_bsdf_s(tp, tsp, wo, wi, req)),
        np.asarray(jglossy.eval_bsdf(jp, jsp, jnp.asarray(s["wo"]),
                                     jnp.asarray(s["wi"]), req)), **tol)
    np.testing.assert_allclose(
        tglossy.pdf_bsdf_s(tp, tsp, wo, wi, req).numpy(),
        np.asarray(jglossy.pdf_bsdf(jp, jsp, jnp.asarray(s["wo"]),
                                    jnp.asarray(s["wi"]), req)), **tol)
    jr = jglossy.sample_bsdf(jp, jsp, jnp.asarray(s["wo"]),
                             jnp.asarray(s["s1"]), jnp.asarray(s["s2"]), req)
    tr = tglossy.sample_bsdf_s(tp, tsp, wo, torch.from_numpy(s["s1"]),
                               torch.from_numpy(s["s2"]), req)
    np.testing.assert_array_equal(tr.flags.numpy(), np.asarray(jr.flags))
    for f in ("wi", "col", "pdf", "w"):
        g = getattr(tr, f)
        got = _np3(g) if isinstance(g, tvec.V3) else g.numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jr, f)), **tol,
                                   err_msg=f)
    assert (np.asarray(jr.pdf) > 0).mean() > 0.3
    spec = tglossy.get_specular_s(tp, tsp, wo)
    assert not spec.refl_valid.any() and not spec.refr_valid.any()


@pytest.mark.parametrize("which", [0, 1])      # the sun, the IBL light
def test_light_samples_match(scenes, which):
    js, ts, _, _ = scenes
    jl, tl = js.lights[which], ts.lights[which]
    s = _surface(10 + which)
    n = s["n"].shape[0]
    p = _points(20 + which, n) * 0.2
    jsps = jvec.SPS(p=jvec.v3(jnp.asarray(p)),
                    **{k: jvec.v3(jnp.asarray(s[k]))
                       for k in ("n", "ng", "nu", "nv")},
                    u=jnp.zeros(n), v=jnp.zeros(n),
                    **{k: jnp.zeros(n, jnp.int32)
                       for k in ("mat", "light", "prim", "obj")})
    tsps = _sps(s, 0)._replace(p=tvec.v3(torch.from_numpy(p)))
    want = jlights.illum_sample_s(jl, jsps, jnp.asarray(s["s1"]),
                                  jnp.asarray(s["s2"]))
    got = tlights.illum_sample_s(tl, tsps, torch.from_numpy(s["s1"]),
                                 torch.from_numpy(s["s2"]))
    for f in ("valid", "dist", "pdf"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    for f in ("wi", "col"):
        w = getattr(want, f)
        np.testing.assert_allclose(
            _np3(getattr(got, f)), np.stack([np.asarray(w.x),
                                             np.asarray(w.y),
                                             np.asarray(w.z)], -1), **TOL,
            err_msg=f)
    # MIS side: BSDF-sampled directions (wi) against the light
    d = s["wi"]
    jh = jlights.intersect_light_s(jl, jvec.RaysS(
        o=jvec.v3(jnp.asarray(p)), d=jvec.v3(jnp.asarray(d)),
        tmin=jnp.zeros(n), tmax=jnp.full(n, -1.0)))
    th = tlights.intersect_light_s(tl, tvec.RaysS(
        o=tvec.v3(torch.from_numpy(p)), d=tvec.v3(torch.from_numpy(d)),
        tmin=torch.zeros(n), tmax=torch.full((n,), -1.0)))
    for f in ("valid", "t", "ipdf"):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)), **TOL,
                                   err_msg=f)
    np.testing.assert_allclose(
        _np3(th.col), np.stack([np.asarray(c) for c in jh.col], -1), **TOL)
    # the pdf of choosing a given light point (the MIS weight of
    # bidirectional methods)
    far = (p + 5.0 * d).astype(np.float32)
    want_pdf = jlights.illum_pdf(jl, _jsp(s, 0)._replace(p=jnp.asarray(p)),
                                 jnp.asarray(far))
    got_pdf = tlights.illum_pdf_s(tl, tsps, tvec.v3(torch.from_numpy(far)))
    np.testing.assert_allclose(got_pdf.numpy(), np.asarray(want_pdf), **TOL)


def test_pixel_blocks_unblock_to_raster():
    """The 32x32 block order of cluster scenes, undone, is raster order."""
    spp, h, w = 2, 64, 96
    raster = torch.stack(render._pixel_grid_raster(h, w, spp, "cpu"), -1)
    blocked = torch.stack(render._pixel_grid_blocked(h, w, spp, "cpu"), -1)
    # lanes 0..1023 are the first sample of the top-left block
    assert int(blocked[:1024, 0].max()) == 31 == int(blocked[:1024, 1].max())
    assert torch.equal(render._unblock_to_raster(blocked, spp, h, w), raster)


def test_blocked_render_chunk_equals_raster(scenes, monkeypatch):
    """render_chunk on a 96x64, 2-spp wavefront gives the same film in
    block order (a scene with an accel) as in raster order (none).  The
    integrator is replaced by a function of each lane's ray and QMC keys,
    so any lane that lands on the wrong pixel changes the film."""
    _, ts, _, _ = scenes

    def lane_colour(scene, types, rays, pixel_sample, sampling_offs, opts):
        key = ((sampling_offs ^ pixel_sample) & 0xFF).to(torch.float32)
        return torch.cat([rays.d, key[:, None] / 255.0], dim=-1)

    monkeypatch.setitem(render._INTEGRATORS, "directlight",
                        (lane_colour, DirectOptions))
    cam = make_perspective(pos=(5.2, 3.4, -5.6), look=(0.0, 1.2, 0.0),
                           up=(5.2, 4.4, -5.6), resx=96, resy=64,
                           device="cpu")
    opts = RenderOptions(aa_samples=2, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))
    films = []
    for accel in (object(), None):          # blocked, then raster
        sc = dataclasses.replace(ts, camera=cam, accel=accel)
        films.append(render_chunk(sc, (), opts,
                                  tfilm.make_film(64, 96, device="cpu"),
                                  0, 2, 0))
    assert torch.equal(films[0].rgba, films[1].rgba)
    assert torch.equal(films[0].weight, films[1].weight)
    assert float(films[0].weight.min()) > 0


@pytest.fixture(scope="module")
def renders(scenes):
    """core_tpu's eager render and the port's, once per module."""
    js, _, _, tsg = scenes
    jopts = JRenderOptions(aa_samples=1, integrator="directlight",
                           integrator_opts=JDirectOptions(raydepth=1))
    jf = j_render_chunk(js, j_types(js), jopts, jfilm.make_film(RES, RES),
                        0, 1, 0, None)
    want = np.asarray(jf.rgba) / np.maximum(np.asarray(jf.weight)[..., None],
                                            1e-10)
    topts = RenderOptions(aa_samples=1, integrator="directlight",
                          integrator_opts=DirectOptions(raydepth=1))
    with torch.no_grad():
        tf = render_chunk(tsg, scene_material_types(tsg), topts,
                          tfilm.make_film(RES, RES, device="cpu"), 0, 1, 0)
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    return want, tfilm.normalized(tf).numpy()


def test_directlight_render_chunk_matches_core_tpu(renders):
    want, got = renders
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close[..., :3].mean() >= 0.99, close[..., :3].mean()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    jm, tm = want[..., :3].mean(), got[..., :3].mean()
    assert abs(tm - jm) <= 1e-5 * abs(jm), (tm, jm)
    # the image the repo's own check expects (tests/test_mesh_scene.py)
    assert jm > 0.05 and want[:4, :, 2].mean() > 0.05
