"""Cameras, backgrounds, colour conversion, the sun spectrum and the film
filters against core_tpu on the same numpy inputs.

- Each camera type's rays (perspective, the thin lens with every bokeh
  type and bias, architect, angular with its circular mask, orthographic)
  and project(), through core_tpu's and the port's factories, on 256
  pixel coordinates and lens samples made from a seed: weights equal,
  origins and directions within rtol 1e-5 / atol 1e-6 (sqrt, sin, cos and
  atan2 differ by ulps between XLA and torch).
- The lens streams of render_chunk: the port's radical inverse in bases 3
  and 5 against core_tpu's: base 3 equal, base 5 within one ulp (core_tpu
  jits it, and its CPU build contracts the digits' multiply-adds).
- Each background's radiance (constant, gradient with ground colours,
  sunsky, darksky by day, at night, with altitude, in every colour space,
  and the texture background's sphere and angular projections) on 256
  directions within rtol 1e-5 / atol 1e-6; darksky_sun_color and the
  factories' auto sun and background lights equal.
- colorconv and sunspectrum equal to core_tpu's numpy.
- Each filter's weights on a grid of offsets, and a 16 x 16 grid splat
  with each filter over two samples per pixel with a mask, within
  rtol 1e-5 / atol 1e-6; the splat is differentiable.
- The port's versions of tests/test_darksky.py and
  tests/test_backgrounds.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import backgrounds as jbg
from core_tpu import cameras as jcam
from core_tpu import film as jfilm
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.params import ParamMap as JParamMap
from core_tpu.sampling import qmc as jqmc
from core_tpu.sampling import sunspectrum as jsun
from core_tpu.textures.base import TexType as JTexType
from core_tpu.textures.base import TextureDef as JTextureDef
from core_tpu.textures.base import build_texture_set as j_texture_set
from core_tpu.utils import colorconv as jcc
from core_tpu_torch import backgrounds as tbg
from core_tpu_torch import cameras as tcam
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import vec as tvec
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.params import ParamMap
from core_tpu_torch.sampling import qmc as tqmc
from core_tpu_torch.sampling import sunspectrum as tsun
from core_tpu_torch.textures.base import TexType, TextureDef, \
    build_texture_set
from core_tpu_torch.utils import colorconv as tcc

torch.set_num_threads(1)
N = 256
TOL = dict(rtol=1e-5, atol=1e-6)
RES = 16


def _np3(v):
    if isinstance(v, tvec.V3):
        return np.stack([c.numpy() for c in v], -1)
    return np.asarray(v)


def _dirs(n=N, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d.astype(np.float32)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

CAMERAS = {
    "pinhole": {"type": "perspective", "focal": 1.3},
    "architect": {"type": "architect", "focal": 1.1},
    "angular": {"type": "angular", "angle": 80.0, "max_angle": 70.0,
                "circular": True},
    "angular_full": {"type": "angular", "angle": 100.0, "circular": False},
    "ortho": {"type": "orthographic", "scale": 3.0},
}
LENS_TYPES = ("disk1", "disk2", "triangle", "square", "pentagon", "hexagon",
              "ring")


def _camera(b, pm, params):
    base = {"from": (2.0, -5.0, 3.0), "to": (0.0, 0.0, 0.5),
            "up": (2.0, -5.0, 4.0), "resx": RES, "resy": 12}
    return b.create("camera", "cam", pm({**base, **params}))


def _shoot(params, seed=1):
    """(core_tpu's rays and weights, the port's) through each package's
    factory at the same pixel coordinates and lens samples."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, RES, N).astype(np.float32)
    py = rng.uniform(0, 12, N).astype(np.float32)
    lu, lv = rng.random(N, np.float32), rng.random(N, np.float32)
    jc = _camera(JSceneBuilder(), JParamMap, params)
    tc = _camera(SceneBuilder("cpu"), ParamMap, params)
    for f in ("pos", "cam_x", "cam_y", "cam_z", "vto", "vup", "vright"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in tcam.STATIC_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    jr, jw = jcam.shoot_ray(jc, jnp.asarray(px), jnp.asarray(py),
                            jnp.asarray(lu), jnp.asarray(lv))
    tr, tw = tcam.shoot_ray(tc, *(torch.from_numpy(a)
                                  for a in (px, py, lu, lv)))
    return (jr, jw), (tr, tw), (jc, tc)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_rays_match_core_tpu(name):
    (jr, jw), (tr, tw), _ = _shoot(CAMERAS[name])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for f in ("o", "d", "tmin", "tmax"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), err_msg=f,
                                   **TOL)
    if name == "angular":
        assert 0.2 < float((tw == 0).float().mean()) < 0.8


@pytest.mark.parametrize("bias", ["uniform", "center", "edge"])
@pytest.mark.parametrize("bokeh", LENS_TYPES)
def test_thin_lens_rays_match_core_tpu(bokeh, bias):
    """Every bokeh type under each of the three biases."""
    params = {"type": "perspective", "focal": 1.2, "aperture": 0.25,
              "dof_distance": 5.0, "bokeh_type": bokeh, "bokeh_bias": bias,
              "bokeh_rotation": 20.0}
    (jr, _), (tr, _), (_, tc) = _shoot(params, seed=2)
    for f in ("o", "d"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), err_msg=f,
                                   **TOL)
    # the lens moves the origins within the aperture
    shift = np.linalg.norm(tr.o.numpy() - tc.pos.numpy(), axis=1)
    assert 0.0 < shift.max() <= 0.25 + 1e-5


def test_project_inverts_shoot_ray():
    (_, _), (tr, _), (jc, tc) = _shoot(CAMERAS["pinhole"])
    d = tr.d
    jpx = jcam.project(jc, jnp.asarray(d.numpy()))
    tpx = tcam.project(tc, d)
    for got, want in zip(tpx, jpx):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool(tpx[3].all())


def test_lens_streams_match_core_tpu():
    """render_chunk's lens (u, v): radical inverses in bases 3 and 5 of
    pass_offs + sampling_offs + s + 1 (core_tpu render.py:226-233).  Base 3
    is equal; in base 5 core_tpu's jitted CPU build contracts the digit
    multiply-adds into FMAs, so there the two agree within one ulp."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    for base in (3, 5):
        want = np.asarray(jqmc.radical_inverse(base, jnp.asarray(idx)))
        got = tqmc.radical_inverse(base, torch.from_numpy(
            idx.astype(np.int64))).numpy()
        if base == 3:
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= np.spacing(want)).all()


# ---------------------------------------------------------------------------
# backgrounds
# ---------------------------------------------------------------------------

def _image_set(pkg):
    img = np.zeros((8, 16, 3), np.float32)
    img[:4] = (0, 1, 0)
    img[4:] = (1, 0, 0)
    img[:, 8:, 2] = 0.5
    if pkg == "j":
        return j_texture_set([JTextureDef(ttype=JTexType.IMAGE, image=img,
                                          clip_mode="repeat")])
    return build_texture_set([TextureDef(ttype=TexType.IMAGE, image=img,
                                         clip_mode="repeat")], "cpu")


BACKGROUNDS = {
    "constant": lambda m, kw: m.make_constant_background(
        (0.5, 0.25, 0.125), power=2.0, **kw),
    "gradient": lambda m, kw: m.make_gradient_background(
        horizon=(1, 0.9, 0.8), zenith=(0.1, 0.2, 0.9),
        horizon_ground=(0.3, 0.2, 0.1), zenith_ground=(0.05, 0.05, 0.05),
        power=1.5, **kw),
    "sunsky": lambda m, kw: m.make_sunsky_background(
        (0.3, 0.2, 0.8), turbidity=3.0, power=0.7, **kw),
    "sunsky_low": lambda m, kw: m.make_sunsky_background(
        (0.9, 0.1, 0.05), turbidity=5.0, a_var=1.2, e_var=0.8, **kw),
    "darksky": lambda m, kw: m.make_darksky_background(
        (0.4, 0.2, 0.7), turbidity=3.0, **kw),
    "darksky_night": lambda m, kw: m.make_darksky_background(
        (0.4, 0.2, 0.7), turbidity=3.0, night=True, bright=0.5, **kw),
    "darksky_altitude": lambda m, kw: m.make_darksky_background(
        (1.0, 0.0, 0.15), turbidity=2.5, altitude=0.8, gamma_enc=False,
        clamp_rgb=False, exposure=0.0, **kw),
    "darksky_srgb": lambda m, kw: m.make_darksky_background(
        (0.2, 0.5, 0.6), turbidity=4.0, color_space="sRGB (D65)",
        exposure=1.5, power=2.0, **kw),
    "texture_sphere": lambda m, kw: m.make_texture_background(
        _image_set("j" if m is jbg else "t"), power=2.0, rotation=30.0,
        **kw),
    "texture_angular": lambda m, kw: m.make_texture_background(
        _image_set("j" if m is jbg else "t"), power=1.5,
        projection="angular", **kw),
}


@pytest.mark.parametrize("name", sorted(BACKGROUNDS))
def test_background_radiance_matches_core_tpu(name):
    jb = BACKGROUNDS[name](jbg, {})
    tb = BACKGROUNDS[name](tbg, {"device": "cpu"})
    d = _dirs(seed=4)
    want = np.asarray(jbg.eval_background(jb, jnp.asarray(d)))
    got = _np3(tbg.eval_background_s(tb, tvec.v3(torch.from_numpy(d))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert got.std() > 0 or name == "constant"


@pytest.mark.parametrize("kw", [{}, {"night": True},
                                {"color_space": "sRGB (D50)"},
                                {"altitude": 0.3}],
                         ids=["day", "night", "srgb_d50", "altitude"])
def test_darksky_sun_color_matches_core_tpu(kw):
    jb = jbg.make_darksky_background((0.4, 0.2, 0.3), 3.5, **kw)
    tb = tbg.make_darksky_background((0.4, 0.2, 0.3), 3.5, device="cpu",
                                     **kw)
    np.testing.assert_array_equal(tbg.darksky_sun_color(tb, 3.5),
                                  jbg.darksky_sun_color(jb, 3.5))


def _sky_program(b, pm, kind):
    b.create("material", "m", pm({"type": "shinydiffusemat"}))
    m = b.assembler.start_mesh()
    ids = [b.assembler.add_vertex(m, *v)
           for v in ((0, 0, 0), (1, 0, 0), (0, 1, 0))]
    b.assembler.add_triangle(m, *ids, 0)
    params = {
        "darksky": {"type": "darksky", "from": (0.3, 0.3, 0.9),
                    "turbidity": 2.5, "add_sun": True, "sun_power": 2.0,
                    "background_light": True, "light_samples": 3,
                    "night": True},
        "sunsky": {"type": "sunsky", "from": (0.3, 0.5, 0.8),
                   "add_sun": True, "sun_power": 1.5, "ibl": True,
                   "ibl_samples": 2},
        "gradientback": {"type": "gradientback", "zenith_color": (0, 0, 1),
                         "ibl": True},
        "constant": {"type": "constant", "color": (0.2, 0.3, 0.4)},
    }[kind]
    b.create("background", "world", pm(params))
    b.create("camera", "cam", pm({"type": "perspective", "from": (0, -3, 1),
                                  "to": (0, 0, 0), "up": (0, -3, 2),
                                  "resx": 4, "resy": 4}))
    return b.compile_scene()


@pytest.mark.parametrize("kind", ["darksky", "sunsky", "gradientback",
                                  "constant"])
def test_background_factories_build_core_tpus_scene(kind):
    """The factories' backgrounds, their auto suns and background lights
    (darksky: background_light / light_samples; the others: ibl /
    ibl_samples) equal leaf by leaf (the CDFs within rtol 1e-5 / atol
    1e-6)."""
    js = _sky_program(JSceneBuilder(), JParamMap, kind)
    ts = _sky_program(SceneBuilder("cpu"), ParamMap, kind)
    jl, jst = convert.scene_to_numpy(js)
    tl, tst = convert.scene_to_numpy(ts)
    assert jl.keys() == tl.keys()
    for k in jl:
        if ".u_" in k or ".v_" in k:
            np.testing.assert_allclose(tl[k], jl[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert json.dumps(tst, sort_keys=True, default=str) == \
        json.dumps(jst, sort_keys=True, default=str)
    want = {"darksky": ["SunLight", "BgLight"],
            "sunsky": ["SunLight", "BgLight"],
            "gradientback": ["BgLight"], "constant": []}[kind]
    assert [type(x).__name__ for x in ts.lights] == want


def test_colorconv_and_sunspectrum_match_core_tpu():
    wl = np.arange(380.0, 750.0, 2.5)
    np.testing.assert_array_equal(tsun.cie_xyz_fit(wl), jsun.cie_xyz_fit(wl))
    for cos_t, turb in ((0.9, 2.0), (0.3, 4.5), (0.02, 2.0)):
        np.testing.assert_array_equal(tsun.attenuated_sun_xyz(cos_t, turb),
                                      jsun.attenuated_sun_xyz(cos_t, turb))
    rng = np.random.default_rng(5)
    xyz = rng.uniform(0.0, 2.0, (N, 3))
    for space, m in tcc.XYZ_TO_RGB.items():
        np.testing.assert_array_equal(m, jcc.XYZ_TO_RGB[space])
        for clamp, gamma in ((False, False), (True, True)):
            np.testing.assert_array_equal(
                tcc.xyz_to_rgb(xyz, m, clamp, gamma),
                jcc.xyz_to_rgb(xyz, m, clamp, gamma))
            got = tcc.xyz_to_rgb_s(tvec.v3(torch.from_numpy(
                xyz.astype(np.float32))), torch.from_numpy(m), clamp, gamma)
            np.testing.assert_allclose(_np3(got), jcc.xyz_to_rgb(
                xyz.astype(np.float32), m, clamp, gamma), **TOL)
    x, y, Y = (rng.uniform(0.0, 0.6, N) for _ in range(3))
    y[:4] = 0.0
    for exposure in (0.0, 1.0):
        np.testing.assert_array_equal(tcc.xyy_to_xyz(x, y, Y, exposure),
                                      jcc.xyy_to_xyz(x, y, Y, exposure))
        s = tcc.xyy_to_xyz_s(*(torch.from_numpy(a.astype(np.float32))
                               for a in (x, y, Y)), exposure=exposure)
        np.testing.assert_allclose(_np3(s), jcc.xyy_to_xyz(
            *(a.astype(np.float32) for a in (x, y, Y)), exposure), **TOL)


# ---------------------------------------------------------------------------
# film filters
# ---------------------------------------------------------------------------

FILTERS = ("BOX", "MITCHELL", "GAUSS", "LANCZOS")


@pytest.mark.parametrize("name", FILTERS)
def test_filter_weights_match_core_tpu(name):
    g = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    ndx, ndy = (a.ravel() for a in np.meshgrid(g, g))
    want = np.asarray(jfilm._filter_weight(
        jfilm.FilterType[name], jnp.asarray(ndx), jnp.asarray(ndy)))
    got = tfilm._filter_weight(tfilm.FilterType[name], torch.from_numpy(ndx),
                               torch.from_numpy(ndy)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for size in (1.0, 1.5, 2.5):
        assert tfilm.effective_filterw(size, tfilm.FilterType[name]) \
            == jfilm.effective_filterw(size, jfilm.FilterType[name])


@pytest.mark.parametrize("name", FILTERS)
def test_grid_splat_matches_core_tpu(name):
    spp, size = 2, 1.5
    rng = np.random.default_rng(6)
    n = spp * RES * RES
    dx, dy = (rng.random(n, np.float32) for _ in range(2))
    rgba = rng.uniform(0.0, 2.0, (n, 4)).astype(np.float32)
    mask = rng.random(n) > 0.1
    fw = tfilm.effective_filterw(size, tfilm.FilterType[name])
    jf = jfilm.add_samples_grid(
        jfilm.make_film(RES, RES), jnp.asarray(dx), jnp.asarray(dy),
        jnp.asarray(rgba), spp, filterw=fw, ftype=jfilm.FilterType[name],
        sample_mask=jnp.asarray(mask))
    col = torch.from_numpy(rgba).requires_grad_()
    tf = tfilm.add_samples_grid(
        tfilm.make_film(RES, RES, device="cpu"), torch.from_numpy(dx),
        torch.from_numpy(dy), col, spp, filterw=fw,
        ftype=tfilm.FilterType[name], sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tf.weight.detach().numpy(),
                               np.asarray(jf.weight), **TOL)
    np.testing.assert_allclose(tf.rgba.detach().numpy(), np.asarray(jf.rgba),
                               **TOL)
    # autograd reaches every unmasked sample through the stencil
    tfilm.normalized(tf).sum().backward()
    assert torch.isfinite(col.grad).all()
    assert bool((col.grad[torch.from_numpy(mask)].abs().sum(1) > 0).all())


# ---------------------------------------------------------------------------
# the port's versions of tests/test_darksky.py and tests/test_backgrounds.py
# ---------------------------------------------------------------------------

def _eval(bg, d):
    return _np3(tbg.eval_background_s(bg, tvec.v3(torch.from_numpy(d))))


def test_cie_fit_and_sun_reddening():
    wl = np.arange(380.0, 750.0, 1.0)
    cmf = tsun.cie_xyz_fit(wl)
    assert abs(wl[cmf[:, 1].argmax()] - 555.0) < 5.0
    assert abs(cmf[:, 1].max() - 1.0) < 0.02
    assert wl[cmf[:, 2].argmax()] < 460.0
    assert cmf[wl > 550.0, 2].max() < 0.02
    hi = tsun.attenuated_sun_xyz(0.9, 2.0)
    lo = tsun.attenuated_sun_xyz(0.02, 2.0)
    assert lo[0] / hi[0] < 0.2
    assert (lo[2] / lo[0]) < 0.3 * (hi[2] / hi[0])


def test_colorconv_spaces_exposure_and_clamp():
    xyz = tcc.xyy_to_xyz(np.float64(0.3127), np.float64(0.3290),
                         np.float64(0.5), exposure=0.0)
    rgb = tcc.xyz_to_rgb(xyz, tcc.XYZ_TO_RGB["sRGB (D65)"])
    assert abs(rgb[0] - rgb[1]) < 0.01 and abs(rgb[1] - rgb[2]) < 0.01
    xyz_e = tcc.xyy_to_xyz(np.float64(0.3127), np.float64(0.3290),
                           np.float64(0.5), exposure=1.0)
    assert xyz_e[1] > xyz[1]
    out = tcc.xyz_to_rgb(np.array([5.0, 5.0, 5.0]), tcc.XYZ_TO_RGB["CIE (E)"],
                         clamp=True, gamma_encode=True)
    assert out.max() <= 1.0


def test_darksky_shape_night_and_altitude():
    sun = np.array([0.4, 0.2, 0.7])
    bg = tbg.make_darksky_background(sun, turbidity=3.0, device="cpu")
    d = _dirs(seed=1)
    c = _eval(bg, d)
    assert np.isfinite(c).all() and (c >= 0).all() and c.max() <= 1.0 + 1e-5
    assert np.dot(d[c.mean(axis=1).argmax()], sun / np.linalg.norm(sun)) \
        > 0.6
    night = _eval(tbg.make_darksky_background(sun, turbidity=3.0,
                                              night=True, device="cpu"),
                  d[:64])
    assert night.mean() < 0.1 * c[:64].mean()
    assert night[:, 2].mean() / max(night[:, 0].mean(), 1e-9) \
        > c[:64, 2].mean() / c[:64, 0].mean()
    low = np.array([1.0, 0.0, 0.15])
    bg0, bg1 = (tbg.make_darksky_background(
        low, turbidity=3.0, altitude=alt, gamma_enc=False, clamp_rgb=False,
        device="cpu") for alt in (0.0, 0.8))
    assert float(bg1.sun_dir[2]) > float(bg0.sun_dir[2])


def test_darksky_factory_adds_the_real_sun():
    b = SceneBuilder("cpu")
    b.create("background", "world", ParamMap({
        "type": "darksky", "from": (0.3, 0.3, 0.9), "turbidity": 2.5,
        "add_sun": True, "sun_power": 2.0, "night": False}))
    assert b.background is not None and len(b.lights) == 1
    assert np.isfinite(b.lights[0].col_pdf.numpy()).all()


def test_sunsky_physical_shape():
    bg = tbg.make_sunsky_background(sun_dir=(0.3, 0.2, 0.8), turbidity=3.0,
                                    device="cpu")
    d = _dirs(512)
    c = _eval(bg, d)
    assert np.isfinite(c).all() and (c >= 0).all()
    up = d[:, 2] > 0.1
    assert c[up].mean() > 0.05
    sun = np.array([0.3, 0.2, 0.8]) / np.linalg.norm([0.3, 0.2, 0.8])
    assert np.dot(d[c.mean(axis=1).argmax()], sun) > 0.7
    assert c[d[:, 2] < -0.95].max() < 0.1
    assert c[d[:, 2] < -0.5].mean() < c[up].mean()


def test_texture_background_sphere_and_angular_mapping():
    img = np.zeros((8, 16, 3), np.float32)
    img[:4] = (0, 1, 0)     # image top = up hemisphere, green
    img[4:] = (1, 0, 0)     # image bottom = down hemisphere, red
    ctex = build_texture_set([TextureDef(ttype=TexType.IMAGE, image=img,
                                         clip_mode="repeat")], "cpu")
    bg = tbg.make_texture_background(ctex, tex_id=0, power=2.0,
                                     device="cpu")
    d = np.array([[0.2, 0, 0.98], [0.2, 0, -0.98]], np.float32)
    c = _eval(bg, d / np.linalg.norm(d, axis=1, keepdims=True))
    assert c[0, 1] > 1.5 and c[0, 0] < 0.5
    assert c[1, 0] > 1.5 and c[1, 1] < 0.5
    # angular (light probe): u = 0.5 + 0.5 (theta / pi) x / r, so +x
    # lands in the image's right half (blue here), -x in its left half
    img[:, 8:, 2] = 1.0
    ang = tbg.make_texture_background(build_texture_set(
        [TextureDef(ttype=TexType.IMAGE, image=img, clip_mode="repeat")],
        "cpu"), tex_id=0, projection="angular", device="cpu")
    c = _eval(ang, np.array([[0.7, 0.0, 0.7], [-0.7, 0.0, 0.7]],
                            np.float32))
    assert c[0, 2] > 0.9 and c[1, 2] < 0.1


def test_constant_and_gradient():
    cb = tbg.make_constant_background((0.5, 0.25, 0.125), power=2.0,
                                      device="cpu")
    np.testing.assert_allclose(_eval(cb, _dirs(8)),
                               np.tile([[1.0, 0.5, 0.25]], (8, 1)),
                               atol=1e-6)
    gb = tbg.make_gradient_background(horizon=(1, 1, 1), zenith=(0, 0, 1),
                                      device="cpu")
    np.testing.assert_allclose(_eval(gb, np.array([[0, 0, 1.0]],
                                                  np.float32)),
                               [[0, 0, 1.0]], atol=1e-6)
