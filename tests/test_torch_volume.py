"""The volumes in the port (volumes/regions.py, integrators/volume.py, the
NEE transmittance in integrators/common.py, the volume factories) against
core_tpu on the same numpy inputs.

core_tpu's side runs once per test run (test_torch_diff.once_per_run),
eagerly, with its scr_halton answered by the port's (as in
tests/test_torch_bidir.py).  Lanes: 256 everywhere (16^2 camera rays, or
seeded points and rays).

- Each of the five region types made by both packages from the same
  parameters: the leaves equal; density, sigma_a / sigma_s / sigma_t,
  emission and phase_hg at 256 seeded points and direction pairs, and
  cross_bb (hit equal; t0, t1) and tau (4 midpoints) on 256 seeded rays,
  among them rays with a zero or negative-zero direction component and
  rays with tmax <= 0: rtol 1e-5 / atol 1e-6 x the largest value.
- load_density_grid on df3 files of 1-, 2- and 4-byte voxels and on an
  .npy file, and the GridVolume factory on a density_file: equal arrays.
- integrate in emission and single-scatter modes (4 steps) on the 16^2
  volume-golden scene with two emitting regions (uniform, exponential)
  and an area light beside the spotlight, both packages on the port's camera
  rays and surface distances: rtol 1e-5 / atol 1e-6.  (A render's camera
  rays differ between the packages by an ulp, and a march whose first
  sample lies on the box's face can then count that sample inside in one
  package and outside in the other: a whole step's in-scatter.  So the
  march is compared on shared rays.)
- precompute_attenuation (a 4^3 grid per volume and light) and
  _att_lookup at 256 seeded points, and integrate with the grids
  (optimize): rtol 1e-5 / atol 1e-6.
- sky_constants equal; _sky_tau, sky_transmittance and sky_integrate (8
  steps) on 256 seeded rays under a gradient background: rtol 1e-5 / atol 1e-6 x the
  largest value; the Mie table lookup against np.interp at 256 angles and
  at the table's own points: rtol 1e-6.
- The NEE transmittance: direct.integrate (raydepth 1) and path.integrate
  (path_samples 1, bounces 1) on the fogged 16^2 Cornell box (a uniform
  and an exponential region), both packages on the port's camera rays:
  rgba rtol 1e-4 / atol 1e-5, and the fog darkens the image.
- Entry points: golden_volume_scene is core_tpu's, leaf by leaf; the five
  volumeregion factories make core_tpu's regions; render_image under each
  volume integrator is finite, single scattering adds light in the air,
  optimize agrees with the march; core_tpu's tests/test_volumes.py
  assertions (analytic uniform tau, exponential tau, trilinear grid,
  phase normalisation, NEE dimmed by exp(-sigma * 2)) hold on the port.
The card's twins (the volume golden, the 64^2 renders through the kernels
against the plain versions) are in tests/test_torch_kernels_cuda.py.
"""
import dataclasses
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.integrators import direct as jdirect
from core_tpu.integrators import path as jpath
from core_tpu.integrators import volume as jvol
from core_tpu.lights.area import make_area_light as j_area_light
from core_tpu.params import ParamMap as JParamMap
from core_tpu.render import scene_material_types as j_types
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.scenes import golden_volume_scene as j_golden_volume_scene
from core_tpu.types import Rays as JRays
from core_tpu.volumes import regions as jvr
from core_tpu_torch import convert
from core_tpu_torch import scene as tscene_mod
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.film import FilterType
from core_tpu_torch.integrators import common as tcommon
from core_tpu_torch.integrators import direct as tdirect
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.integrators import volume as tvol
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.integrators.volume import VolumeOptions
from core_tpu_torch.materials.base import gather_params_s
from core_tpu_torch.params import ParamMap
from core_tpu_torch.render import (RenderOptions, render_image,
                                   scene_material_types)
from core_tpu_torch.scenes import golden_volume_scene
from core_tpu_torch.vec import SPS, RaysS, V3, v3
from core_tpu_torch.volumes import regions as tvr

from test_shadow_sentinel import _sun_slab_scene
from test_torch_bidir import (_camera_rays, _j_rays, _np3, _port_halton,
                              _t_rays)
from test_torch_diff import once_per_run

torch.set_num_threads(1)
RES = 16
LANES = RES * RES
TOL = dict(rtol=1e-5, atol=1e-6)
BOX = dict(bmin=(0.0, 0.0, 0.0), bmax=(1.0, 1.5, 2.0))
GRID = np.random.default_rng(30).uniform(0.0, 1.0, (5, 4, 3)) \
    .astype(np.float32)
REGIONS = {
    "uniform": ("make_uniform_volume", dict(
        sigma_a=(0.3, 0.2, 0.1), sigma_s=0.2, l_e=(0.1, 0.2, 0.3), g=0.3,
        **BOX)),
    "exp": ("make_expdensity_volume", dict(
        sigma_a=0.4, sigma_s=(0.1, 0.3, 0.5), l_e=0.2, g=-0.4, a=1.5,
        b=2.0, **BOX)),
    "noise": ("make_noise_volume", dict(
        sigma_a=0.4, sigma_s=0.6, l_e=0.2, g=0.6, sharpness=2.0, cover=0.8,
        density=1.5, **BOX)),
    "grid": ("make_grid_volume", dict(
        grid=GRID, sigma_a=0.2, sigma_s=0.5, l_e=(0.0, 0.1, 0.2), g=0.1,
        **BOX)),
    "sky": ("make_sky_volume", dict(
        s_ray=0.05, s_mie=0.01, l_e=0.1, g=0.8, **BOX)),
}
TAU_STEPS = 4
STEPS = 4
ATT_RES = 4
SKY = dict(integrator="sky", steps=8, sky_alpha=0.5, sky_scale=0.02,
           sky_turbidity=3.0)
INTEGRATORS = {"dl": dict(raydepth=1),
               "pt": dict(path_samples=1, bounces=1, raydepth=1)}
CORNELL_FOG = dict(bmin=(0.0, 0.0, 0.0), bmax=(556.0, 548.8, 559.2))


def _region(pkg, kind):
    name, kw = REGIONS[kind]
    if pkg == "core":
        return getattr(jvr, name)(**kw)
    return getattr(tvr, name)(**kw, device="cpu")


def _seeded():
    """256 points around BOX, direction pairs, and rays (a zero x, a
    negative-zero y, and tmax <= 0 on some lanes)."""
    rng = np.random.default_rng(31)
    f32 = np.float32

    def unit(n):
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(f32)

    o = rng.uniform(-1.0, 2.5, (LANES, 3)).astype(f32)
    # 3/4 of the rays aim at a point of the box
    aim = rng.uniform(BOX["bmin"], BOX["bmax"], (LANES, 3)) - o
    d = np.where(np.arange(LANES)[:, None] < LANES // 4, unit(LANES),
                 aim / np.linalg.norm(aim, axis=1, keepdims=True)) \
        .astype(f32)
    d[:16, 0] = 0.0
    d[16:24, 1] = -0.0
    return dict(p=rng.uniform((-0.25, -0.25, -0.25), (1.25, 1.75, 2.25),
                              (LANES, 3)).astype(f32),
                wl=unit(LANES), ws=unit(LANES), o=o, d=d,
                tmax=np.where(rng.uniform(size=LANES) < 0.5,
                              rng.uniform(0.5, 4.0, LANES), -1.0)
                .astype(f32))


def _volume_scene(pkg):
    """The 16^2 volume-golden scene with two emitting regions and an area
    light beside the spotlight (core_tpu's, or the port's made from it by
    convert)."""
    js = j_golden_volume_scene(RES, RES)
    vols = (jvr.make_uniform_volume(sigma_a=0.01, sigma_s=0.05, l_e=0.02,
                                    bmin=(-2, 0, -2), bmax=(2, 4, 2)),
            jvr.make_expdensity_volume(sigma_a=0.02, sigma_s=0.1, l_e=0.05,
                                       a=1.0, b=0.5, bmin=(-3, 0, -3),
                                       bmax=(0, 2, 0)))
    area = j_area_light(corner=(-1.0, 5.0, -1.0), point1=(1.0, 5.0, -1.0),
                        point2=(-1.0, 5.0, 1.0), color=(1.0, 1.0, 0.9),
                        power=20.0, samples=1)
    js = dataclasses.replace(js, volumes=vols, lights=js.lights + (area,))
    if pkg == "core":
        return js
    return convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                    device="cpu")


def _fog_box(pkg, fog=True):
    js = j_cornell_box(resx=RES, resy=RES, light_samples=1)
    if fog:
        js = dataclasses.replace(js, volumes=(
            jvr.make_uniform_volume(sigma_a=0.001, sigma_s=0.0005,
                                    **CORNELL_FOG),
            jvr.make_expdensity_volume(sigma_a=0.002, sigma_s=0.001, a=1.0,
                                       b=0.004, bmin=(0.0, 0.0, 0.0),
                                       bmax=(556.0, 300.0, 559.2))))
    if pkg == "core":
        return js
    return convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                    device="cpu")


def _shared_rays(ts):
    """The port's camera rays of ts and their surface distances."""
    o, d, ps, offs = _camera_rays(ts)
    hits = tscene_mod.closest_hit_s(ts, RaysS(
        o=v3(torch.from_numpy(o)), d=v3(torch.from_numpy(d)),
        tmin=torch.zeros(LANES), tmax=torch.full((LANES,), -1.0)))
    return o, d, ps, offs, hits.t.numpy()


def _sky_inputs():
    rng = np.random.default_rng(32)
    d = rng.normal(size=(LANES, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8, 2] = 0.0
    return dict(o=rng.uniform((-5, -5, 0), (5, 5, 2), (LANES, 3))
                .astype(np.float32), d=d.astype(np.float32),
                t=np.where(rng.uniform(size=LANES) < 0.75,
                           rng.uniform(1.0, 60.0, LANES), -1.0)
                .astype(np.float32),
                h0=rng.uniform(0.0, 2.0, LANES).astype(np.float32),
                cos=rng.uniform(-1.0, 1.0, LANES).astype(np.float32),
                s=rng.uniform(0.0, 5.0, LANES).astype(np.float32),
                deg=rng.uniform(-10.0, 200.0, LANES).astype(np.float32))


def _sky_scene(pkg):
    from core_tpu.backgrounds import make_gradient_background
    bg = make_gradient_background((0.8, 0.7, 0.6), (0.2, 0.4, 1.0),
                                  (0.3, 0.25, 0.2), (0.1, 0.1, 0.1))
    js = dataclasses.replace(_sun_slab_scene(), background=bg)
    if pkg == "core":
        return js
    return convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                    device="cpu")


def _core_tpu_side() -> dict:
    out = {}
    s = {k: jnp.asarray(v) for k, v in _seeded().items()}
    rays = JRays(o=s["o"], d=s["d"], tmin=jnp.zeros(LANES), tmax=s["tmax"])
    with jax.disable_jit(), _port_halton():
        for kind in REGIONS:
            vol = _region("core", kind)
            for f in dataclasses.fields(vol):
                out[f"region:{kind}:leaf:{f.name}"] = np.asarray(
                    getattr(vol, f.name))
            out[f"region:{kind}:density"] = np.asarray(jvr.density(vol, s["p"]))
            for fn in ("sigma_a", "sigma_s", "sigma_t", "emission"):
                out[f"region:{kind}:{fn}"] = np.asarray(
                    getattr(jvr, fn)(vol, s["p"]))
            out[f"region:{kind}:phase"] = np.asarray(
                jvr.phase_hg(vol, s["wl"], s["ws"]))
            for k, a in zip(("hit", "t0", "t1"), jvr.cross_bb(vol, rays)):
                out[f"region:{kind}:{k}"] = np.asarray(a)
            out[f"region:{kind}:tau"] = np.asarray(
                jvr.tau(vol, rays, n_steps=TAU_STEPS))

        # the marches on the port's camera rays of the volume scene
        js = _volume_scene("core")
        o, d, ps, offs, ht = _shared_rays(_volume_scene("port"))
        jr = _j_rays(o, d)
        for mode in ("emission", "singlescatter"):
            out[f"integrate:{mode}"] = np.asarray(jvol.integrate(
                js, jr, jnp.asarray(ht), None, None,
                jvol.VolumeOptions(integrator=mode, steps=STEPS)))
        vo = jvol.VolumeOptions(integrator="singlescatter", steps=STEPS,
                                optimize=True, att_grid_res=ATT_RES)
        grids = jvol.precompute_attenuation(js, vo)
        for i, g in enumerate(grids):
            out[f"att:{i}"] = np.asarray(g)
            vol = js.volumes[i]
            out[f"lookup:{i}"] = np.asarray(jvol._att_lookup(
                g[1], vol.bmin, vol.bmax, s["p"] * 4.0 - 1.0))
        out["integrate:optimize"] = np.asarray(jvol.integrate(
            js, jr, jnp.asarray(ht), None, None, vo, vol_aux=grids))

        # the sky
        k = _sky_inputs()
        b_r, b_m, a_r, a_m = jvol.sky_constants(0.5, 3.0)
        out["sky:tau"] = np.asarray(jvol._sky_tau(
            b_r, a_r, jnp.asarray(k["h0"]), jnp.asarray(k["cos"]),
            jnp.asarray(k["s"])))
        sr = JRays(o=jnp.asarray(k["o"]), d=jnp.asarray(k["d"]),
                   tmin=jnp.zeros(LANES), tmax=jnp.asarray(k["t"]))
        so = jvol.VolumeOptions(**SKY)
        out["sky:tr"] = np.asarray(jvol.sky_transmittance(sr, so))
        out["sky:in"] = np.asarray(jvol.sky_integrate(
            _sky_scene("core"), sr, jnp.asarray(k["t"]), so))

        # the NEE transmittance inside both integrators
        jb = _fog_box("core")
        o, d, ps, offs, _ = _shared_rays(_fog_box("port"))
        for kind, mod, cls in (("dl", jdirect, jdirect.DirectOptions),
                               ("pt", jpath, jpath.PathOptions)):
            out[f"nee:{kind}"] = np.asarray(mod.integrate(
                jb, j_types(jb), _j_rays(o, d), jnp.asarray(ps, jnp.int32),
                jnp.asarray(offs, jnp.uint32), cls(**INTEGRATORS[kind])))
    return out


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    c, by = once_per_run(tmp_path_factory, "torch_volume_core",
                         _core_tpu_side)
    print(f"volume: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return c


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


@pytest.mark.parametrize("kind", sorted(REGIONS))
def test_region_matches_core_tpu(core, kind):
    vol = _region("port", kind)
    for f in dataclasses.fields(vol):
        np.testing.assert_array_equal(getattr(vol, f.name).numpy(),
                                      core[f"region:{kind}:leaf:{f.name}"], f.name)
    s = {k: torch.from_numpy(v) for k, v in _seeded().items()}
    p = v3(s["p"])
    _close(tvr.density(vol, p).numpy(), core[f"region:{kind}:density"], "density")
    for fn in ("sigma_a", "sigma_s", "sigma_t", "emission"):
        _close(_np3(getattr(tvr, fn)(vol, p)), core[f"region:{kind}:{fn}"], fn)
    _close(tvr.phase_hg(vol, v3(s["wl"]), v3(s["ws"])).numpy(),
           core[f"region:{kind}:phase"], "phase")
    rays = RaysS(o=v3(s["o"]), d=v3(s["d"]), tmin=torch.zeros(LANES),
                 tmax=s["tmax"])
    hit, t0, t1 = tvr.cross_bb(vol, rays)
    np.testing.assert_array_equal(hit.numpy(), core[f"region:{kind}:hit"])
    assert 100 < int(hit.sum()) < LANES
    for k, a in (("t0", t0), ("t1", t1)):
        m = core[f"region:{kind}:hit"]
        _close(a.numpy()[m], core[f"region:{kind}:{k}"][m], k)
    _close(_np3(tvr.tau(vol, rays, n_steps=TAU_STEPS)), core[f"region:{kind}:tau"],
           "tau")
    assert core[f"region:{kind}:tau"].max() > 0


def test_df3_reader_matches_core_tpu(tmp_path):
    nx, ny, nz = 3, 2, 4
    rng = np.random.default_rng(33)
    for bpv in (1, 2, 4):
        vox = rng.integers(0, 2 ** (8 * bpv), nx * ny * nz, dtype=np.uint64)
        path = tmp_path / f"g{bpv}.df3"
        path.write_bytes(struct.pack(">HHH", nx, ny, nz)
                         + vox.astype(f">u{bpv}").tobytes())
        got = tvr.load_density_grid(str(path))
        assert got.shape == (nx, ny, nz) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jvr.load_density_grid(str(path)))
        assert got[1, 0, 0] == np.float32(vox[1] / (2 ** (8 * bpv) - 1))
    np.save(tmp_path / "g.npy", GRID)
    np.testing.assert_array_equal(
        tvr.load_density_grid(str(tmp_path / "g.npy")), GRID)
    with pytest.raises(ValueError, match="bytes/voxel"):
        (tmp_path / "bad.df3").write_bytes(struct.pack(">HHH", 1, 1, 1)
                                           + b"abc")
        tvr.load_density_grid(str(tmp_path / "bad.df3"))
    # the factory on a density_file
    params = {"type": "GridVolume", "density_file": str(tmp_path / "g2.df3"),
              "sigma_a": 0.3, "sigma_s": 0.1, "minX": 0.0, "minY": 0.0,
              "minZ": 0.0, "maxX": 1.0, "maxY": 1.0, "maxZ": 1.0}
    grids = []
    for builder, pmap in ((SceneBuilder("cpu"), ParamMap),
                          (JSceneBuilder(), JParamMap)):
        builder.create("volumeregion", "smoke", pmap(dict(params)))
        grids.append(np.asarray(builder.volumes[0].grid))
    np.testing.assert_array_equal(*grids)


@pytest.mark.parametrize("mode", ["emission", "singlescatter"])
def test_integrate_matches_core_tpu(core, mode):
    ts = _volume_scene("port")
    o, d, ps, offs, ht = _shared_rays(ts)
    got = tvol.integrate(ts, _t_rays_s(o, d), torch.from_numpy(ht), None,
                         None, VolumeOptions(integrator=mode, steps=STEPS))
    want = core[f"integrate:{mode}"]
    _close(_np3(got), want)
    assert want.max() > 0.01 and (want <= 1.0).all()


def _t_rays_s(o, d):
    r = _t_rays(o, d)
    return RaysS(o=v3(r.o), d=v3(r.d), tmin=r.tmin, tmax=r.tmax)


def test_attenuation_grid_matches_core_tpu(core):
    ts = _volume_scene("port")
    vo = VolumeOptions(integrator="singlescatter", steps=STEPS,
                       optimize=True, att_grid_res=ATT_RES)
    grids = tvol.precompute_attenuation(ts, vo)
    assert len(grids) == 2
    p = torch.from_numpy(_seeded()["p"]) * 4.0 - 1.0
    for i, g in enumerate(grids):
        assert g.shape == (2, ATT_RES, ATT_RES, ATT_RES, 3)
        _close(g.numpy(), core[f"att:{i}"], f"grid {i}")
        vol = ts.volumes[i]
        _close(_np3(tvol._att_lookup(g[1], vol.bmin, vol.bmax, v3(p))),
               core[f"lookup:{i}"], f"lookup {i}")
    o, d, _, _, ht = _shared_rays(ts)
    got = tvol.integrate(ts, _t_rays_s(o, d), torch.from_numpy(ht), None,
                         None, vo, vol_aux=grids)
    _close(_np3(got), core["integrate:optimize"])
    assert tvol.precompute_attenuation(
        ts, dataclasses.replace(vo, optimize=False)) is None


def test_sky_matches_core_tpu(core):
    assert tvol.sky_constants(0.5, 3.0) == jvol.sky_constants(0.5, 3.0)
    k = {n: torch.from_numpy(v) for n, v in _sky_inputs().items()}
    b_r, _, a_r, _ = tvol.sky_constants(0.5, 3.0)
    _close(tvol._sky_tau(b_r, a_r, k["h0"], k["cos"], k["s"]).numpy(),
           core["sky:tau"], "tau")
    rays = RaysS(o=v3(k["o"]), d=v3(k["d"]), tmin=torch.zeros(LANES),
                 tmax=k["t"])
    so = VolumeOptions(**SKY)
    _close(_np3(tvol.sky_transmittance(rays, so)), core["sky:tr"], "tr")
    ins = tvol.sky_integrate(_sky_scene("port"), rays, k["t"], so)
    _close(_np3(ins), core["sky:in"], "in-scatter")
    assert core["sky:in"].max() > 0 and (core["sky:tr"] < 1.0).any()
    xp = torch.from_numpy(tvol._MIE_DEG)
    fp = torch.from_numpy(tvol._MIE_VAL)
    for x in (k["deg"], xp):
        np.testing.assert_allclose(
            tvol.interp(x, xp, fp).numpy(),
            np.interp(x.numpy(), tvol._MIE_DEG, tvol._MIE_VAL), rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(INTEGRATORS))
def test_nee_transmittance_matches_core_tpu(core, kind):
    o, d, ps, offs, _ = _shared_rays(_fog_box("port"))
    mod, cls = {"dl": (tdirect, DirectOptions),
                "pt": (tpath, PathOptions)}[kind]
    imgs = []
    for fog in (True, False):
        ts = _fog_box("port", fog)
        with torch.no_grad():
            imgs.append(mod.integrate(
                ts, scene_material_types(ts), _t_rays(o, d),
                torch.from_numpy(ps), torch.from_numpy(offs),
                cls(**INTEGRATORS[kind])).numpy())
    want = core[f"nee:{kind}"]
    np.testing.assert_allclose(imgs[0], want, rtol=1e-4, atol=1e-5)
    # the fog dims the light samples
    assert want[:, :3].sum() < 0.97 * imgs[1][:, :3].sum()


def test_volume_entry_points():
    # golden_volume_scene is core_tpu's, leaf by leaf
    want = convert.scene_to_numpy(j_golden_volume_scene(RES, RES))
    got = convert.scene_to_numpy(golden_volume_scene(RES, RES,
                                                     device="cpu"))
    assert sorted(got[0]) == sorted(want[0])
    for k, v in want[0].items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)
    assert got[1]["volumes"] == want[1]["volumes"] == ["UniformVolume"]
    # the five factories make core_tpu's regions
    box = {"minX": -1.0, "minY": 0.0, "minZ": -2.0, "maxX": 1.0,
           "maxY": 3.0, "maxZ": 2.0}
    for tname, extra in (("UniformVolume", {"l_e": 0.2}),
                         ("ExpDensityVolume", {"a": 2.0, "b": 0.5}),
                         ("NoiseVolume", {"sharpness": 3.0, "cover": 0.7,
                                          "density": 2.0}),
                         ("GridVolume", {"grid": GRID}),
                         ("SkyVolume", {"sigma_t": 0.1, "g": 0.7})):
        params = {"type": tname, "sigma_a": 0.2, "sigma_s": 0.3, **box,
                  **extra}
        vols = []
        for builder, pmap in ((SceneBuilder("cpu"), ParamMap),
                              (JSceneBuilder(), JParamMap)):
            builder.create("volumeregion", "v", pmap(dict(params)))
            vols.append(builder.volumes[0])
        assert type(vols[0]).__name__ == type(vols[1]).__name__ == tname
        for f in dataclasses.fields(vols[0]):
            np.testing.assert_array_equal(
                getattr(vols[0], f.name).numpy(),
                np.asarray(getattr(vols[1], f.name)), f"{tname}.{f.name}")

    # render_image under each volume integrator
    scene = golden_volume_scene(RES, RES, device="cpu")
    base = dict(aa_samples=2, spp_chunk=2, filter_size=1.0,
                filter_type=FilterType.BOX,
                integrator_opts=DirectOptions(raydepth=1))
    imgs = {}
    for name, vo in (("none", VolumeOptions()),
                     ("emission", VolumeOptions(integrator="emission")),
                     ("ss", VolumeOptions(integrator="singlescatter",
                                          steps=12)),
                     ("opt", VolumeOptions(integrator="singlescatter",
                                           steps=12, optimize=True)),
                     ("sky", VolumeOptions(integrator="sky"))):
        img, _ = render_image(scene, RenderOptions(**base, volume_opts=vo))
        assert bool(torch.isfinite(img).all()), name
        imgs[name] = img[..., :3].mean().item()
    assert imgs["ss"] > imgs["emission"] + 0.05
    assert abs(imgs["opt"] - imgs["ss"]) / imgs["ss"] < 0.03
    with pytest.raises(ValueError, match="volume integrator"):
        render_image(scene, RenderOptions(
            **base, volume_opts=VolumeOptions(integrator="fog")))

    # core_tpu's tests/test_volumes.py assertions on the port
    def rays(o, d, n=4):
        return RaysS(o=V3(*(torch.full((n,), c) for c in o)),
                     d=V3(*(torch.full((n,), c) for c in d)),
                     tmin=torch.zeros(n), tmax=torch.full((n,), -1.0))
    uni = tvr.make_uniform_volume(sigma_a=0.3, sigma_s=0.2, device="cpu")
    np.testing.assert_allclose(
        _np3(tvr.tau(uni, rays((-2.0, 0.5, 0.5), (1.0, 0.0, 0.0)))), 0.5,
        rtol=1e-5)
    assert float(_np3(tvr.tau(uni, rays((-2.0, 5.0, 0.5),
                                        (1.0, 0.0, 0.0)))).max()) == 0.0
    ex = tvr.make_expdensity_volume(sigma_a=1.0, sigma_s=0.0, a=1.0, b=2.0,
                                    device="cpu")
    for h, expect in ((0.0, 1.0), (0.5, np.exp(-1.0))):
        t = _np3(tvr.tau(ex, rays((-1.0, 0.5, h + 1e-4), (1.0, 0.0, 0.0), 1),
                         n_steps=64))[0, 0]
        assert abs(t - expect) < 0.02, (h, t)
    g = np.zeros((4, 4, 4), np.float32)
    g[2:] = 1.0
    gv = tvr.make_grid_volume(g, sigma_a=1.0, sigma_s=0.0, device="cpu")
    st = _np3(tvr.sigma_t(gv, v3(torch.tensor([[0.9, 0.5, 0.5],
                                               [0.1, 0.5, 0.5]]))))
    assert st[0, 0] > 0.9 and st[1, 0] < 0.1
    dd = torch.from_numpy(np.random.default_rng(0).normal(size=(20000, 3))
                          .astype(np.float32))
    dd = dd / dd.norm(dim=1, keepdim=True)
    ph = tvr.phase_hg(tvr.make_uniform_volume(g=0.4, device="cpu"),
                      v3(torch.tensor([[0.0, 0.0, 1.0]]).expand(20000, 3)),
                      v3(dd))
    np.testing.assert_allclose(float(ph.mean()) * 4 * np.pi, 1.0, rtol=0.05)
    # NEE through an absorbing slab: exp(-sigma * 2) at near-vertical rays
    slab = tvr.make_uniform_volume(sigma_a=0.35, sigma_s=0.0,
                                   bmin=(-15, 4.0, -15), bmax=(15, 6.0, 15),
                                   device="cpu")
    sc = golden_volume_scene(4, 4, device="cpu")
    n = 16
    up = V3(torch.zeros(n), torch.ones(n), torch.zeros(n))
    z = torch.zeros(n)
    sp = SPS(p=V3(torch.linspace(-1.0, 1.0, n) * 0.5, z,
                  torch.linspace(-1.0, 1.0, n)), n=up, ng=up,
             nu=V3(torch.ones(n), z, z), nv=V3(z, z, torch.ones(n)), u=z,
             v=z, mat=torch.zeros(n, dtype=torch.int32),
             light=torch.full((n,), -1, dtype=torch.int32),
             prim=torch.zeros(n, dtype=torch.int32),
             obj=torch.zeros(n, dtype=torch.int32))
    means = []
    for vols in ((), (slab,)):
        s2 = dataclasses.replace(sc, volumes=vols)
        col = tcommon.estimate_all_direct_s(
            s2, scene_material_types(s2),
            gather_params_s(s2.materials, sp.mat), sp, up,
            torch.arange(n), torch.zeros(n, dtype=torch.int64),
            torch.ones(n, dtype=torch.bool))
        means.append(float(torch.stack(list(col)).mean()))
    np.testing.assert_allclose(means[1] / means[0], np.exp(-0.35 * 2.0),
                               rtol=0.05)
