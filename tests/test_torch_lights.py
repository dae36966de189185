"""The sphere, mesh, background-portal and IES lights, the light registry
and the new element factories against core_tpu on the same numpy inputs.

- Each light's illum_sample_s (the IES light's illuminate_s),
  intersect_light_s and illum_pdf_s against core_tpu's on 256 lanes made
  from a seed: shading points below the light, QMC-like samples in [0, 1),
  and rays aimed at the light with some misses.  Masks equal; floats within
  rtol 1e-5 / atol 1e-6 (XLA's and torch's sqrt / acos / sin differ by
  ulps, and XLA sums a [.., 3] reduction in its own order).
- The mesh light one- and double-sided; its batched intersect against
  core_tpu's per-triangle loop on rays through shared edges of a coplanar
  grid, where the strict t < best_t decides (the first triangle in list
  order wins).
- parse_ies / resample_profile on tests/test_extras.py's sample text
  (copied here) exactly equal to core_tpu's.
- Every factory this slice adds (arealight, spherelight, ieslight,
  meshlight, bgPortalLight, bglight; glass, rough_glass, blend_mat,
  mask_mat, mirror, null, light_mat): one SceneBuilder program run by both
  packages gives equal scenes leaf by leaf (convert.scene_to_numpy; the
  bglight CDFs within rtol 1e-5 / atol 1e-6), and a meshlight or portal
  over an object with no triangles makes no light.
- The port's versions of tests/test_lights.py:90-135 (sphere solid angle,
  mesh light sampling) and tests/test_extras.py:24-67 (the IES profile,
  the portal's background radiance).
- diff.extract_params / apply_params reach the new lights' colour and the
  sphere's centre, and round-trip the light zoo's render exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import vec as jvec
from core_tpu.backgrounds import make_constant_background as j_constant
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.lights import base as jlb
from core_tpu.lights import ies as jies
from core_tpu.lights.mesh import make_mesh_light as j_mesh
from core_tpu.lights.portal import make_bg_portal_light as j_portal
from core_tpu.lights.sphere import make_sphere_light as j_sphere
from core_tpu.params import ParamMap as JParamMap
from core_tpu.types import SurfacePoints as JSurfacePoints
from core_tpu_torch import convert
from core_tpu_torch import vec as tvec
from core_tpu_torch.backgrounds import make_constant_background
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.lights import base as tlb
from core_tpu_torch.lights import extra
from core_tpu_torch.lights import ies as ties
from core_tpu_torch.lights.mesh import make_mesh_light
from core_tpu_torch.lights.portal import make_bg_portal_light
from core_tpu_torch.lights.sphere import make_sphere_light
from core_tpu_torch.params import ParamMap

torch.set_num_threads(1)
N = 256
TOL = dict(rtol=1e-5, atol=1e-6)

IES_SAMPLE = """IESNA:LM-63-1995
[TEST] demo
TILT=NONE
1 1000.0 1.0 5 1 1 2 0.0 0.0 0.0
1.0 1.0 100.0
0.0 45.0 90.0 135.0 180.0
0.0
1000.0 800.0 400.0 100.0 0.0
"""


def _grid(quads, z, flip=False):
    """A quads x quads grid on the plane z over [-1, 1]^2, normals -z (or
    +z flipped)."""
    xs = np.linspace(-1.0, 1.0, quads + 1)
    verts = np.array([(x, y, z) for x in xs for y in xs], np.float32)
    tris = []
    for i in range(quads):
        for j in range(quads):
            v00, v01 = i * (quads + 1) + j, i * (quads + 1) + j + 1
            v10, v11 = v00 + quads + 1, v01 + quads + 1
            tris += [(v00, v11, v10), (v00, v01, v11)]
    tris = np.array(tris, np.int32)
    return verts, (tris[:, ::-1] if flip else tris)


def _inputs(seed, z_light=3.0):
    """Shading points on z = 0 (normal +z), samples, and rays from those
    points aimed near the light's centre (some miss)."""
    rng = np.random.default_rng(seed)
    p = np.zeros((N, 3), np.float32)
    p[:, :2] = rng.uniform(-2.0, 2.0, (N, 2))
    s1, s2 = rng.random(N, np.float32), rng.random(N, np.float32)
    target = np.zeros((N, 3), np.float32)
    target[:, :2] = rng.uniform(-1.6, 1.6, (N, 2))
    target[:, 2] = z_light
    d = target - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, s1, s2, d.astype(np.float32)


def _sps_pair(p):
    up = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (N, 1))
    ex = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (N, 1))
    ey = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (N, 1))
    z = np.zeros(N, np.int32)
    jsp = JSurfacePoints(p=jnp.asarray(p), n=jnp.asarray(up),
                         ng=jnp.asarray(up), nu=jnp.asarray(ex),
                         nv=jnp.asarray(ey), uv=jnp.zeros((N, 2)),
                         mat=jnp.asarray(z), light=jnp.asarray(z - 1),
                         prim=jnp.asarray(z), obj=jnp.asarray(z))

    def t3(a):
        return tvec.v3(torch.from_numpy(a))
    tz = torch.from_numpy(z)
    tsp = tvec.SPS(p=t3(p), n=t3(up), ng=t3(up), nu=t3(ex), nv=t3(ey),
                   u=torch.zeros(N), v=torch.zeros(N), mat=tz, light=tz - 1,
                   prim=tz, obj=tz)
    return jsp, tsp


def _rays_pair(o, d):
    jr = jvec.RaysS(o=jvec.v3(jnp.asarray(o)), d=jvec.v3(jnp.asarray(d)),
                    tmin=jnp.zeros(N), tmax=jnp.full(N, -1.0))
    tr = tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                    d=tvec.v3(torch.from_numpy(d)), tmin=torch.zeros(N),
                    tmax=torch.full((N,), -1.0))
    return jr, tr


def _close(got, want, name):
    if isinstance(got, tvec.V3):
        got = np.stack([c.numpy() for c in got], -1)
        want = np.stack([np.asarray(c) for c in want], -1)
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def _check_light(jl, tl, seed, z_light=3.0):
    """illum_sample_s, intersect_light_s and illum_pdf_s of both packages
    on the same inputs; returns the port's sample and hit."""
    p, s1, s2, d = _inputs(seed, z_light)
    jsp, tsp = _sps_pair(p)
    assert tlb.dirac(tl) == jlb.dirac(jl)
    assert tlb.can_intersect(tl) == jlb.can_intersect(jl)
    assert tlb.n_samples(tl) == jlb.n_samples(jl)
    jls = jlb.illum_sample_s(jl, jvec.sp_to_soa(jsp), jnp.asarray(s1),
                             jnp.asarray(s2))
    tls = tlb.illum_sample_s(tl, tsp, torch.from_numpy(s1),
                             torch.from_numpy(s2))
    for f in ("valid", "wi", "dist", "col", "pdf"):
        _close(getattr(tls, f), getattr(jls, f), f"illum_sample.{f}")
    jr, tr = _rays_pair(p, d)
    jlh = jlb.intersect_light_s(jl, jr)
    tlh = tlb.intersect_light_s(tl, tr)
    for f in ("valid", "t", "col", "ipdf"):
        _close(getattr(tlh, f), getattr(jlh, f), f"intersect.{f}")
    # the pdf of reaching the sampled points (reached by the BSDF side)
    p_light = p + np.stack([np.asarray(c) for c in jls.wi], -1) \
        * np.asarray(jls.dist)[:, None]
    _close(tlb.illum_pdf_s(tl, tsp, tvec.v3(torch.from_numpy(
        p_light.astype(np.float32)))),
        jlb.illum_pdf(jl, jsp, jnp.asarray(p_light.astype(np.float32))),
        "illum_pdf")
    return tls, tlh


def test_sphere_light_matches_core_tpu():
    args = ((0.2, -0.3, 3.0), 0.8, (1.0, 0.9, 0.8), 5.0)
    ls, lh = _check_light(j_sphere(*args, samples=2),
                          make_sphere_light(*args, samples=2, device="cpu"),
                          seed=1)
    assert 0.9 < ls.valid.float().mean() <= 1.0
    assert 0.1 < lh.valid.float().mean() < 0.9


@pytest.mark.parametrize("double_sided", [False, True])
def test_mesh_light_matches_core_tpu(double_sided):
    verts, tris = _grid(2, 3.0)
    ls, lh = _check_light(
        j_mesh(verts, tris, (1.0, 0.8, 0.6), 4.0, samples=3,
               double_sided=double_sided),
        make_mesh_light(verts, tris, (1.0, 0.8, 0.6), 4.0, samples=3,
                        double_sided=double_sided, device="cpu"), seed=2)
    assert ls.valid.float().mean() > 0.95
    assert 0.3 < lh.valid.float().mean() < 1.0
    # from above, only the double-sided light is reached
    p, _, _, d = _inputs(3, 3.0)
    up = p + np.array([0, 0, 6.0], np.float32)
    _, tr = _rays_pair(up, -d)
    lh = tlb.intersect_light_s(make_mesh_light(
        verts, tris, (1.0, 0.8, 0.6), 4.0, double_sided=double_sided,
        device="cpu"), tr)
    assert bool(lh.valid.any()) == double_sided


def test_mesh_light_ties_go_to_the_first_triangle():
    """Rays through the grid's shared edges and vertices: core_tpu's loop
    keeps the first triangle (strict <); the batched test agrees, at any
    block size."""
    from core_tpu_torch.lights import mesh as tmesh
    verts, tris = _grid(4, 2.0)
    xs = np.linspace(-1.0, 1.0, 5, dtype=np.float32)
    pts = np.array([(x, y, 2.0) for x in xs for y in xs], np.float32)
    rng = np.random.default_rng(4)
    o = np.zeros((N, 3), np.float32)
    o[:, :2] = rng.uniform(-0.5, 0.5, (N, 2))
    d = pts[rng.integers(0, len(pts), N)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jl = j_mesh(verts, tris, (1, 1, 1), 1.0, double_sided=True)
    jr, tr = _rays_pair(o, d.astype(np.float32))
    want = jlb.intersect_light_s(jl, jr)
    for block in (tmesh.BLOCK_ELEMS, N * 5):
        tmesh.BLOCK_ELEMS, old = block, tmesh.BLOCK_ELEMS
        try:
            got = tlb.intersect_light_s(make_mesh_light(
                verts, tris, (1, 1, 1), 1.0, double_sided=True,
                device="cpu"), tr)
        finally:
            tmesh.BLOCK_ELEMS = old
        for f in ("valid", "t", "ipdf"):
            _close(getattr(got, f), getattr(want, f), f)
    assert got.valid.float().mean() > 0.5


def test_portal_light_matches_core_tpu():
    verts, tris = _grid(1, 3.0)
    ls, lh = _check_light(
        j_portal(verts, tris, j_constant((2.0, 1.0, 0.5)), power=1.5,
                 samples=2),
        make_bg_portal_light(verts, tris, make_constant_background(
            (2.0, 1.0, 0.5), device="cpu"), power=1.5, samples=2,
            device="cpu"), seed=5)
    # double-sided: every sample counts; the radiance is the background's
    assert bool(ls.valid.all())
    np.testing.assert_allclose(ls.col.x.numpy(), 3.0, rtol=1e-6)
    # no background: white
    white = make_bg_portal_light(verts, tris, None, device="cpu")
    p, s1, s2, _ = _inputs(5)
    _, tsp = _sps_pair(p)
    col = tlb.illum_sample_s(white, tsp, torch.from_numpy(s1),
                             torch.from_numpy(s2)).col
    assert all(bool((c == 1.0).all()) for c in col)


def test_ies_light_matches_core_tpu():
    args = ((0.1, 0.2, 3.0), (0.0, 0.5, 0.0), (1.0, 0.9, 0.8), 10.0)
    jl = jies.make_ies_light(*args, ies_text=IES_SAMPLE)
    tl = ties.make_ies_light(*args, ies_text=IES_SAMPLE, device="cpu")
    np.testing.assert_array_equal(tl.profile.numpy(), np.asarray(jl.profile))
    np.testing.assert_array_equal(tl.ndir.numpy(), np.asarray(jl.ndir))
    assert tlb.dirac(tl) and not tlb.can_intersect(tl)
    p, _, _, d = _inputs(6)
    jsp, tsp = _sps_pair(p)
    jls = jlb.illuminate_s(jl, jvec.sp_to_soa(jsp))
    tls = tlb.illuminate_s(tl, tsp)
    for f in ("valid", "wi", "dist", "col", "pdf"):
        _close(getattr(tls, f), getattr(jls, f), f"illuminate.{f}")
    jr, tr = _rays_pair(p, d)
    assert not bool(tlb.intersect_light_s(tl, tr).valid.any())
    assert not bool(np.asarray(jlb.intersect_light_s(jl, jr).valid).any())


def test_parse_ies_matches_core_tpu():
    from core_tpu_torch.scenes import LIGHT_ZOO_IES
    for text in (IES_SAMPLE, LIGHT_ZOO_IES):
        v, prof = ties.parse_ies(text)
        jv, jprof = jies.parse_ies(text)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(prof, jprof)
        np.testing.assert_array_equal(ties.resample_profile(v, prof),
                                      jies.resample_profile(jv, jprof))
    # tests/test_extras.py's checks
    v, prof = ties.parse_ies(IES_SAMPLE)
    assert len(v) == 5 and prof[0] == 1.0 and prof[-1] == 0.0
    with pytest.raises(ValueError, match="TILT"):
        ties.parse_ies("IESNA:LM-63-1995\n1 2 3\n")


def test_unknown_light_raises_or_dispatches_through_the_registry():
    class Plugin:
        pass

    class PluginOps:
        DIRAC = True

        @staticmethod
        def get_n_samples(light):
            return 3

    with pytest.raises(NotImplementedError, match="Plugin"):
        tlb.dirac(Plugin())
    extra.register(Plugin, PluginOps)
    try:
        assert tlb.dirac(Plugin()) and tlb.n_samples(Plugin()) == 3
    finally:
        extra._REGISTRY.pop(Plugin)


# ---------------------------------------------------------------------------
# factories: one builder program, both packages
# ---------------------------------------------------------------------------

def _factory_program(b, pm, ies_path, empty_obj=False):
    """Materials, three objects (a floor, an emitter grid, a portal quad),
    a constant background with ibl and every light factory of this slice."""
    b.create("material", "floor", pm({"type": "shinydiffusemat"}))
    b.create("material", "glass", pm({"type": "glass", "IOR": 1.5,
                                      "filter_color": (0.9, 1.0, 0.9),
                                      "dispersion_power": 0.2}))
    b.create("material", "rough", pm({"type": "rough_glass", "alpha": 0.3,
                                      "absorption": (0.1, 0.2, 0.3)}))
    b.create("material", "blend", pm({"type": "blend_mat",
                                      "material1": "floor",
                                      "material2": "glass",
                                      "blend_value": 0.3}))
    b.create("material", "mask", pm({"type": "mask_mat",
                                     "material1": "floor",
                                     "material2": "rough",
                                     "threshold": 0.4}))
    b.create("material", "mirror", pm({"type": "mirror", "reflect": 0.8,
                                       "color": (0.9, 0.9, 1.0)}))
    b.create("material", "null", pm({"type": "null"}))
    b.create("material", "emit", pm({"type": "light_mat",
                                     "color": (1.0, 0.8, 0.6),
                                     "power": 2.5}))
    a = b.assembler
    objs = []
    for mat, z, quads in (("floor", 0.0, 1), ("emit", 3.0, 2),
                          ("null", 5.0, 1)):
        m = a.start_mesh()
        verts, tris = _grid(quads, z)
        ids = [a.add_vertex(m, *v) for v in verts]
        for t in tris:
            a.add_triangle(m, *(ids[i] for i in t), b.material_index(mat))
        objs.append(m.obj_id)
    b.create("background", "bg", pm({"type": "constant",
                                     "color": (0.3, 0.4, 0.5), "ibl": True,
                                     "ibl_samples": 2}))
    panel = 99 if empty_obj else objs[1]
    portal = 98 if empty_obj else objs[2]
    for name, params in (
            ("area", {"type": "arealight", "corner": (-1, -1, 4.0),
                      "point1": (1, -1, 4.0), "point2": (-1, 1, 4.0),
                      "power": 2.0, "samples": 2}),
            ("sphere", {"type": "spherelight", "from": (1, 2, 3),
                        "radius": 0.5, "color": (0.5, 0.6, 0.7),
                        "power": 3.0, "samples": 2}),
            ("mesh", {"type": "meshlight", "object": panel,
                      "color": (1.0, 0.8, 0.6), "power": 2.5,
                      "double_sided": True, "samples": 3}),
            ("ies", {"type": "ieslight", "from": (0, 0, 4), "to": (0, 0, 0),
                     "power": 9.0, "file": ies_path}),
            ("portal", {"type": "bgPortalLight", "object": portal,
                        "power": 1.5, "samples": 2}),
            ("bg", {"type": "bglight", "samples": 3})):
        b.create("light", name, pm(params))
    b.create("camera", "cam", pm({"type": "perspective",
                                  "from": (0, -6, 2), "to": (0, 0, 1),
                                  "up": (0, -6, 3), "resx": 8, "resy": 8}))
    return b.compile_scene()


def _statics(static) -> str:
    return json.dumps(static, sort_keys=True, default=str)


@pytest.fixture(scope="module")
def ies_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ies") / "sample.ies"
    path.write_text(IES_SAMPLE)
    return str(path)


def test_factories_build_core_tpus_scene(ies_path):
    js = _factory_program(JSceneBuilder(), JParamMap, ies_path)
    ts = _factory_program(SceneBuilder("cpu"), ParamMap, ies_path)
    jl, jst = convert.scene_to_numpy(js)
    tl, tst = convert.scene_to_numpy(ts)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        if ".u_" in k or ".v_" in k:       # the bglights' CDFs
            np.testing.assert_allclose(tl[k], jl[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert _statics(tst) == _statics(jst)
    assert [type(x).__name__ for x in ts.lights] == [
        "AreaLight", "SphereLight", "IesLight", "BgLight", "MeshLight",
        "BgPortalLight", "BgLight"]
    assert ts.lights[4].double_sided and ts.lights[4].va.shape[0] == 8
    assert ts.lights[5].background is ts.background
    # the round trip rebuilds every light and the background
    back = convert.scene_from_numpy(tl, tst, device="cpu")
    assert [type(x).__name__ for x in back.lights] == [
        type(x).__name__ for x in ts.lights]
    assert _statics(convert.scene_to_numpy(back)[1]) == _statics(tst)


def test_lights_over_empty_objects_make_no_light(ies_path):
    for b, pm in ((JSceneBuilder(), JParamMap), (SceneBuilder("cpu"),
                                                 ParamMap)):
        scene = _factory_program(b, pm, ies_path, empty_obj=True)
        assert [type(x).__name__ for x in scene.lights] == [
            "AreaLight", "SphereLight", "IesLight", "BgLight", "BgLight"]


def test_translucent_still_raises():
    with pytest.raises(NotImplementedError, match="translucent"):
        SceneBuilder("cpu").create("material", "t", ParamMap(
            {"type": "translucent"}))


# ---------------------------------------------------------------------------
# the port's versions of tests/test_lights.py and tests/test_extras.py
# ---------------------------------------------------------------------------

def test_sphere_light_samples_hit_the_sphere():
    light = make_sphere_light((0, 0, 4), 1.0, (1, 1, 1), 5.0, samples=4,
                              device="cpu")
    p, s1, s2, _ = _inputs(7)
    _, tsp = _sps_pair(p)
    ls = tlb.illum_sample_s(light, tsp, torch.from_numpy(s1),
                            torch.from_numpy(s2))
    ok = ls.valid.numpy()
    assert ok.mean() > 0.95
    wi = np.stack([c.numpy() for c in ls.wi], -1)[ok]
    hit = p[ok] + wi * ls.dist.numpy()[ok][:, None]
    np.testing.assert_allclose(np.linalg.norm(hit - [0, 0, 4.0], axis=1),
                               1.0, atol=5e-3)


def test_mesh_light_samples_lie_on_the_quad():
    verts = np.array([[-1, -1, 3], [1, -1, 3], [1, 1, 3], [-1, 1, 3]],
                     np.float32)
    tris = np.array([[0, 2, 1], [0, 3, 2]], np.int32)     # normals -z
    light = make_mesh_light(verts, tris, (1, 1, 1), 4.0, samples=4,
                            device="cpu")
    assert float(light.area) == pytest.approx(4.0, rel=1e-5)
    p, s1, s2, _ = _inputs(8)
    _, tsp = _sps_pair(p)
    ls = tlb.illum_sample_s(light, tsp, torch.from_numpy(s1),
                            torch.from_numpy(s2))
    ok = ls.valid.numpy()
    assert ok.mean() > 0.95
    wi = np.stack([c.numpy() for c in ls.wi], -1)[ok]
    hit = p[ok] + wi * ls.dist.numpy()[ok][:, None]
    np.testing.assert_allclose(hit[:, 2], 3.0, atol=1e-3)
    assert (np.abs(hit[:, :2]) <= 1.0 + 1e-4).all()
    o = np.zeros((N, 3), np.float32)
    d = np.tile(np.array([[0, 0, 1.0]], np.float32), (N, 1))
    lh = tlb.intersect_light_s(light, _rays_pair(o, d)[1])
    assert bool(lh.valid.all())
    np.testing.assert_allclose(lh.t.numpy(), 3.0, atol=1e-4)


def test_ies_light_is_brightest_on_its_axis():
    light = ties.make_ies_light((0, 0, 2), (0, 0, 0), (1, 1, 1), 10.0,
                                IES_SAMPLE, device="cpu")
    n = 8
    p = np.stack([np.linspace(-2, 2, n), np.zeros(n), np.zeros(n)],
                 -1).astype(np.float32)
    t3 = tvec.v3(torch.from_numpy(p))
    z = torch.zeros(n, dtype=torch.int32)
    sp = tvec.SPS(p=t3, n=t3, ng=t3, nu=t3, nv=t3, u=torch.zeros(n),
                  v=torch.zeros(n), mat=z, light=z - 1, prim=z, obj=z)
    col = np.stack([c.numpy() for c in tlb.illuminate_s(light, sp).col], -1)
    assert np.isfinite(col).all()
    assert col[n // 2].mean() > col[0].mean()


def test_portal_radiance_is_the_background():
    bg = make_constant_background((2.0, 1.0, 0.5), device="cpu")
    verts = np.array([[0, 0, 2], [1, 0, 2], [1, 1, 2], [0, 1, 2]],
                     np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    light = make_bg_portal_light(verts, tris, bg, power=1.0, device="cpu")
    p = np.tile(np.array([[0.5, 0.5, 0.0]], np.float32), (N, 1))
    _, tsp = _sps_pair(p)
    s = torch.linspace(0.05, 0.95, N)
    ls = tlb.illum_sample_s(light, tsp, s, s)
    col = np.stack([c.numpy() for c in ls.col], -1)
    assert np.isfinite(col).all() and bool(ls.valid.all())
    np.testing.assert_allclose(col[0] / col[0][2], [4.0, 2.0, 1.0],
                               rtol=1e-5)


def test_params_reach_the_new_lights():
    """diff.extract_params / apply_params reach the sphere, mesh and IES
    lights' colour and the sphere's centre (the portal has no colour of
    its own: its radiance is the background's), and the round trip renders
    the light zoo unchanged."""
    from chip_smoke import light_zoo_opts, light_zoo_scene
    from core_tpu_torch import diff
    from core_tpu_torch.render import render_image
    ts = light_zoo_scene(8, device="cpu", grid=6, torus=(6, 4), samples=1,
                         panel=1)
    names = [type(x).__name__ for x in ts.lights]
    params = diff.extract_params(ts, geometry=True)
    for kind in ("SphereLight", "MeshLight", "IesLight"):
        assert f"light{names.index(kind)}.color" in params, kind
    assert f"light{names.index('SphereLight')}.center" in params
    assert not any(k.startswith(f"light{names.index('BgPortalLight')}.")
                   for k in params)
    moved = dict(params)
    i = names.index("SphereLight")
    moved[f"light{i}.center"] = params[f"light{i}.center"] + 0.5
    assert torch.equal(diff.apply_params(ts, moved).lights[i].center,
                       params[f"light{i}.center"] + 0.5)
    opts = light_zoo_opts("dl")
    assert torch.equal(render_image(diff.apply_params(ts, params), opts)[0],
                       render_image(ts, opts)[0])
