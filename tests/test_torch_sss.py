"""Subsurface scattering in the port (the translucent material,
integrators/sss.py, DirectOptions / PathOptions(use_sss=True)) against
core_tpu on the same numpy inputs.

The scene is tests/test_sss.py's translucent box (the Cornell box whose
short block, triangles 10-33, wears a translucent material with
sigma_s = (8, 8, 8)) at 16^2, built by core_tpu and carried across by
convert.py, which carries the sigma_s and sss_g columns by name.
core_tpu's side runs once per test run (test_torch_diff.once_per_run) and
eagerly, with its scr_halton answered by the port's (as in
tests/test_torch_bidir.py).

- dipole_rd_1ch on 256 x 8 seeded distances and coefficients: rtol 1e-5.
- estimate_sss at 256 seeded shading points (the box's translucent and
  white material rows, two object ids, 90% active) on a seeded map of
  1,024 deposits (80% valid) in a cube of edge 3 at the origin: rtol 1e-4
  / atol 1e-6 x the largest value.  The port evaluates only the
  translucent lanes and the valid deposits and forms r^2 from the
  differences, where core_tpu expands |x|^2 + |xi|^2 - 2 x.xi over every
  pair; near the origin that expansion loses nothing that matters.  At
  the Cornell box's scale (|x|^2 ~ 7e4, an ulp ~ 0.008) it loses ~0.02
  of r^2: on the 16^2 box's camera hits with an 8,192-photon map the two
  estimates differ by a median 2.5e-4 and at most 1.2% of a lane's value
  (ROADMAP, known caveats), so this test does not compare there.
- build_sss_map with 2,048 photons, 2 surface bounces, 3 interior steps:
  a photon whose deposit masks differ is a flip.  An exit test starts on
  the face the photon entered through, so its ray can meet that face
  again at t within ulps of MIN_RAYDIST (5e-5): whether that counts as a
  hit is decided by the ulps by which the packages' rays differ.  Every
  flip must be that tie (at its first differing deposit, in one of the
  packages the exit ray hits the entry triangle at t < 2e-4), and at most
  FLIP_SHARE of the photons flip.  The other photons' deposits agree:
  masks and objects equal, positions and powers within 1e-5 of each
  field's largest value.
- direct.integrate(use_sss, raydepth 1) and path.integrate(use_sss,
  path_samples=1, bounces=1) on the box's 256 camera rays, both packages
  on core_tpu's map: rgba within rtol 1e-4 / atol 1e-5.
- Entry points: render_image with DirectOptions(use_sss=True) and
  PathOptions(use_sss=True); core_tpu's own assertions of
  tests/test_sss.py hold on the port (deposits land inside, finite and
  non-negative; the dipole is positive and decaying; SSS adds energy
  under both integrators); the translucent factory makes core_tpu's
  material row; chip_smoke.translucent_box is this scene leaf by leaf.
The card's twins (the 64^2 SSS renders through the kernels against the
plain versions) are in tests/test_torch_kernels_cuda.py.
"""
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import scene as jscene_mod
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.integrators import direct as jdirect
from core_tpu.integrators import path as jpath
from core_tpu.integrators import sss as jsss
from core_tpu.params import ParamMap as JParamMap
from core_tpu.materials.base import gather_params as j_gather_params
from core_tpu.render import scene_material_types as j_types
from core_tpu.types import SurfacePoints as JSurfacePoints
from core_tpu_torch import convert
from core_tpu_torch import scene as tscene_mod
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.integrators import direct as tdirect
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.integrators import sss as tsss
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.materials.base import MatType, gather_params_s
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.params import ParamMap
from core_tpu_torch.render import (RenderOptions, render_image,
                                   scene_material_types)
from core_tpu_torch.vec import SPS, v3, zeros3

from chip_smoke import translucent_box
from test_sss import _sss_scene
from test_torch_bidir import (_camera_rays, _j_rays, _np3, _port_halton,
                              _t_rays)
from test_torch_diff import once_per_run

torch.set_num_threads(1)
RES = 16
LANES = RES * RES
N_PHOTONS = 2048
STEPS = 3
BOUNCES = 2
FLIP_SHARE = 0.01
N_DEP = 1024
INTEGRATORS = {"dl": dict(raydepth=1),
               "pt": dict(path_samples=1, bounces=1, raydepth=1)}
BLOCK = (10, 34)         # the short block's triangles


def _dipole_inputs():
    rng = np.random.default_rng(17)
    f32 = np.float32
    return dict(r2=rng.uniform(0.0, 30.0, (LANES, 8)).astype(f32),
                sa=rng.uniform(0.01, 0.1, (LANES, 1)).astype(f32),
                ss=rng.uniform(1.0, 10.0, (LANES, 1)).astype(f32),
                g=rng.uniform(-0.5, 0.8, (LANES, 1)).astype(f32),
                ior=rng.uniform(1.1, 1.6, (LANES, 1)).astype(f32))


def _seeded_estimate():
    """LANES shading points in [-1, 1]^3 (unit normals and outgoing
    directions, the white row 0 or the translucent row 4, objects 0 and 1,
    90% active) and a map of N_DEP deposits in [-1.5, 1.5]^3 (objects 0
    and 1, 80% valid)."""
    rng = np.random.default_rng(18)
    f32 = np.float32

    def unit(n):
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(f32)

    return dict(p=rng.uniform(-1.0, 1.0, (LANES, 3)).astype(f32),
                n=unit(LANES), wo=unit(LANES),
                mat=np.where(rng.uniform(size=LANES) < 0.75, 4, 0)
                .astype(np.int32),
                obj=(rng.uniform(size=LANES) < 0.5).astype(np.int32),
                active=rng.uniform(size=LANES) < 0.9,
                pos=rng.uniform(-1.5, 1.5, (N_DEP, 3)).astype(f32),
                power=rng.uniform(0.0, 1.0, (N_DEP, 3)).astype(f32),
                dep_obj=(rng.uniform(size=N_DEP) < 0.5).astype(np.int32),
                valid=rng.uniform(size=N_DEP) < 0.8)


def _core_tpu_side() -> dict:
    out = {}
    js = _sss_scene(res=RES)
    ts = convert.scene_from_numpy(*convert.scene_to_numpy(js), device="cpu")
    with jax.disable_jit(), _port_halton():
        d = _dipole_inputs()
        out["dipole"] = np.asarray(jsss.dipole_rd_1ch(
            *(jnp.asarray(d[k]) for k in ("r2", "sa", "ss", "g", "ior"))))

        # estimate_sss at seeded points on a seeded map
        e = {k: jnp.asarray(v) for k, v in _seeded_estimate().items()}
        zero = jnp.zeros((LANES, 3))
        sp = JSurfacePoints(p=e["p"], n=e["n"], ng=e["n"], nu=zero, nv=zero,
                            uv=jnp.zeros((LANES, 2)), mat=e["mat"],
                            light=jnp.full(LANES, -1, jnp.int32),
                            prim=jnp.zeros(LANES, jnp.int32), obj=e["obj"])
        out["estimate"] = np.asarray(jsss.estimate_sss(
            jsss.SSSMap(e["pos"], e["power"], e["dep_obj"], e["valid"]), sp,
            j_gather_params(js.materials, e["mat"]), e["wo"], e["active"]))

        o, dvec, ps, offs = _camera_rays(ts)
        rays = _j_rays(o, dvec)

        # the map, with every closest hit's (prim, t) recorded
        calls = []
        orig = jscene_mod.closest_hit

        def record(scene, r, exclude_prim=None):
            h = orig(scene, r, exclude_prim=exclude_prim)
            calls.append(h)
            return h

        with mock.patch.object(jscene_mod, "closest_hit", record):
            smap = jsss.build_sss_map(js, j_types(js), n_photons=N_PHOTONS,
                                      interior_steps=STEPS)
        for k, a in zip(jsss.SSSMap._fields, smap):
            out[f"map:{k}"] = np.asarray(a)
        out["map:prim"] = np.stack([np.asarray(h.prim) for h in calls])
        out["map:t"] = np.stack([np.asarray(h.t) for h in calls])

        # both integrators on this map
        aux = {"dl": smap, "pt": {"sss": smap}}
        for kind, mod, cls in (("dl", jdirect, jdirect.DirectOptions),
                               ("pt", jpath, jpath.PathOptions)):
            out[f"render:{kind}"] = np.asarray(mod.integrate(
                js, j_types(js), rays, jnp.asarray(ps, jnp.int32),
                jnp.asarray(offs, jnp.uint32),
                cls(use_sss=True, **INTEGRATORS[kind]), aux=aux[kind]))
    return out


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    c, by = once_per_run(tmp_path_factory, "torch_sss_core", _core_tpu_side)
    print(f"sss: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return c


@pytest.fixture(scope="module")
def box():
    js = _sss_scene(res=RES)
    return js, convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                        device="cpu")


def test_dipole_and_estimate_match_core_tpu(core, box):
    _, ts = box
    d = {k: torch.tensor(v) for k, v in _dipole_inputs().items()}
    got = tsss.dipole_rd_1ch(d["r2"], d["sa"], d["ss"], d["g"], d["ior"])
    np.testing.assert_allclose(got.numpy(), core["dipole"], rtol=1e-5)
    assert (core["dipole"] > 0).all()

    e = {k: torch.tensor(v) for k, v in _seeded_estimate().items()}
    zero = torch.zeros(LANES)
    sp = SPS(p=v3(e["p"]), n=v3(e["n"]), ng=v3(e["n"]), nu=zeros3(zero),
             nv=zeros3(zero), u=zero, v=zero, mat=e["mat"],
             light=torch.full((LANES,), -1, dtype=torch.int32),
             prim=torch.zeros(LANES, dtype=torch.int32), obj=e["obj"])
    p = gather_params_s(ts.materials, e["mat"])
    est = tsss.estimate_sss(tsss.SSSMap(e["pos"], e["power"], e["dep_obj"],
                                        e["valid"]), sp, p, v3(e["wo"]),
                            e["active"])
    want = core["estimate"]
    translucent = (e["active"] & (p.mtype == int(MatType.TRANSLUCENT))) \
        .numpy()
    assert (want[translucent] > 0).all() and (want[~translucent] == 0).all()
    assert 100 < translucent.sum() < LANES
    np.testing.assert_allclose(_np3(est), want, rtol=1e-4,
                               atol=1e-6 * float(want.max()))


def _first_flip(want, got, n):
    """Per flipped photon: (id, its first differing deposit slot as
    (bounce, step), the call index of that step's exit test)."""
    wm = want.reshape(BOUNCES, STEPS, n)
    gm = got.reshape(BOUNCES, STEPS, n)
    out = []
    for i in np.nonzero((wm != gm).any(axis=(0, 1)))[0]:
        b, s = (int(x[0]) for x in np.nonzero(wm[:, :, i] != gm[:, :, i]))
        out.append((int(i), b, s, b * (STEPS + 1) + 1 + s))
    return out


def test_build_sss_map_matches_core_tpu(core, box):
    _, ts = box
    calls = []
    orig = tscene_mod.closest_hit_s

    def record(scene, r, exclude_prim=None):
        h = orig(scene, r, exclude_prim=exclude_prim)
        calls.append(h)
        return h

    with mock.patch.object(tscene_mod, "closest_hit_s", record):
        got = tsss.build_sss_map(ts, scene_material_types(ts),
                                 n_photons=N_PHOTONS, interior_steps=STEPS)
    assert len(calls) == core["map:prim"].shape[0] == BOUNCES * (STEPS + 1)
    gv, wv = got.valid.numpy(), core["map:valid"]
    flips = _first_flip(wv, gv, N_PHOTONS)
    named = []
    for i, b, s, c in flips:
        entry = c - 1 - s                   # the surface hit of bounce b
        ties = []
        for prim, t in ((core["map:prim"], core["map:t"]),
                        (np.stack([h.prim.numpy() for h in calls]),
                         np.stack([h.t.numpy() for h in calls]))):
            ties.append(prim[c, i] == prim[entry, i]
                        and BLOCK[0] <= prim[entry, i] < BLOCK[1]
                        and 0.0 < t[c, i] < 4.0 * MIN_RAYDIST)
        named.append((i, b, s, any(ties)))
    print(f"sss map: {len(flips)} flipped photons of {N_PHOTONS} "
          f"(id, bounce, step, the entry-face tie): {named}",
          file=sys.stderr)
    assert all(tie for *_, tie in named), named
    assert len(flips) <= FLIP_SHARE * N_PHOTONS, named
    keep = np.ones(N_PHOTONS, bool)
    keep[[i for i, *_ in flips]] = False
    keep = np.tile(keep, BOUNCES * STEPS)
    np.testing.assert_array_equal(gv[keep], wv[keep])
    np.testing.assert_array_equal(got.obj.numpy(), core["map:obj"])
    m = keep & wv
    assert m.sum() > 500
    for k in ("pos", "power"):
        want = core[f"map:{k}"][m]
        np.testing.assert_allclose(getattr(got, k).numpy()[m], want,
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("kind", sorted(INTEGRATORS))
def test_sss_render_matches_core_tpu(core, box, kind):
    _, ts = box
    smap = tsss.SSSMap(*(torch.tensor(core[f"map:{k}"])
                         for k in tsss.SSSMap._fields))
    o, d, ps, offs = _camera_rays(ts)
    mod, cls, aux = {"dl": (tdirect, DirectOptions, smap),
                     "pt": (tpath, PathOptions, {"sss": smap})}[kind]
    with torch.no_grad():
        rgba = mod.integrate(ts, scene_material_types(ts), _t_rays(o, d),
                             torch.from_numpy(ps), torch.from_numpy(offs),
                             cls(use_sss=True, **INTEGRATORS[kind]),
                             aux=aux)
    want = core[f"render:{kind}"]
    np.testing.assert_allclose(rgba.numpy(), want, rtol=1e-4, atol=1e-5)
    assert want[:, :3].std() > 0.05


def test_sss_entry_points(box):
    js, ts = box
    tp = scene_material_types(ts)
    # tests/test_sss.py's assertions on the port
    m = tsss.build_sss_map(ts, tp, n_photons=2048, interior_steps=3)
    assert int(m.valid.sum()) > 0
    pw = m.power[m.valid]
    assert bool(torch.isfinite(pw).all()) and bool((pw >= 0).all())
    rd = tsss.dipole_rd_1ch(torch.tensor([[0.01, 1.0, 25.0]]),
                            torch.full((1, 1), 0.05), torch.full((1, 1), 5.0),
                            torch.zeros((1, 1)), torch.full((1, 1), 1.3))[0]
    assert bool((rd > 0).all()) and rd[0] > rd[1] > rd[2]
    for integ, cls, common in (
            ("directlight", DirectOptions, dict(raydepth=1)),
            ("pathtracing", PathOptions,
             dict(path_samples=2, bounces=2, raydepth=1))):
        img_off, _ = render_image(ts, RenderOptions(
            integrator=integ, integrator_opts=cls(**common)))
        img_on, _ = render_image(ts, RenderOptions(
            integrator=integ, integrator_opts=cls(
                use_sss=True, sss_photons=2048, sss_steps=3, **common)))
        assert bool(torch.isfinite(img_on).all())
        gain = float(img_on[..., :3].sum() - img_off[..., :3].sum())
        assert gain > 0.0, (integ, gain)

    # the translucent factory: core_tpu's material row, parameter by
    # parameter
    params = {"type": "translucent", "color": (0.9, 0.7, 0.6),
              "glossy_color": (0.2, 0.2, 0.2), "glossy_reflect": 0.1,
              "diffuse_reflect": 0.4, "exponent": 30.0, "IOR": 1.4,
              "sigmaA": (0.02, 0.04, 0.06), "sigmaS": (8.0, 7.0, 6.0),
              "g": 0.3}
    rows = []
    for builder, pmap in ((SceneBuilder("cpu"), ParamMap),
                          (JSceneBuilder(), JParamMap)):
        i = builder.create("material", "sss", pmap(dict(params)))
        rows.append(builder.materials[i])
    for f in ("mtype", "diffuse_color", "glossy_color", "glossy_reflect",
              "diffuse_strength", "exp_u", "exp_v", "ior", "absorption",
              "sigma_s", "sss_g"):
        assert np.allclose(np.asarray(getattr(rows[0], f), np.float64),
                           np.asarray(getattr(rows[1], f), np.float64)), f
    assert rows[0].bsdf_flags() == rows[1].bsdf_flags()
    # convert carries the SSS columns of a core_tpu scene by name, and
    # chip_smoke's translucent_box (the card's scene) is this one, leaf by
    # leaf
    for f in ("sigma_s", "sss_g", "absorption"):
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)))
    want = convert.scene_to_numpy(js)[0]
    got = convert.scene_to_numpy(translucent_box(RES, 2, device="cpu"))[0]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
