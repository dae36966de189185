"""The port's gradients against core_tpu's through the later families: the
light zoo (lights, backgrounds, a lens camera, a Gauss filter), the photon
integrators (photonmapping, the path tracer's photon caustics, SPPM), the
bidirectional integrator and SSS, and the volumes and the sky.

Each configuration's loss is written once per package from the same numpy
scene (convert.scene_to_numpy / scene_from_numpy): apply_params writes the
leaves of extract_params(geometry=True) into the scene; the integrator's
preprocess (render.integrator_preprocess: the photon maps, the caustic
map, the SSS map) builds its maps inside the loss from that scene, so the
light colours' gradients flow through the maps in both packages; one 1-spp
render_chunk (or two passes of render_sppm) renders it; the loss is the
mean squared RGB of the image against a zero target (bench.py:170-177).
The image is film.flush at gamma 1, which is film.normalized plus the
light image; only the bidirectional integrator fills the light image, so
elsewhere it is film.normalized.

Where a map is built inside the loss, geom.obj_offset is left out of the
leaves in both packages: core_tpu reads the scene's vertices on the host to
bound the photon and SSS shoots (integrators/photonmap.py:50), which
raises for vertices that carry a gradient.  Every other leaf is held at
offset 0 (ROADMAP Queue 3: a nonzero offset shades against a stale accel).

core_tpu's side of each family runs once per test run
(test_torch_diff.once_per_run), op by op as test_torch_diff's does,
with its scr_halton answered by the port's
(test_torch_bidir._port_halton).  The photon and SSS shoots run eagerly
(jax.disable_jit: no FMA contraction, so the roulettes fall the same way
in both packages, as in test_torch_photon.py), with the two photon
gathers compiled by jax.jit.
The volumes' core_tpu side renders the port's camera rays (_port_camera).
Every wavefront is 256 lanes (16^2, 1 spp, and the SSS photons; the sky
scene's 24^2) or 2,048 (the photon maps), with shallow depths.

Where the scenes differ from their forward tests' (each said again where it
is set): the photon box wears a mirror block where test_torch_photon.py's
has glass (PH_BOX), and the sky's loss leaves out two pixels whose camera
rays run along its ground quad's diagonal (SKY_TIES).

Tolerances (test_torch_diff.py's): the loss within rtol 1e-4; each leaf
elementwise within 1e-3 x max|g_core_tpu| of that leaf; a leaf whose
core_tpu gradient is 0 must be exactly 0 in the port, but for one whose
terms cancel in another order (SUM_TO_ZERO).  Entries where core_tpu's
gradient is NaN are those NAN_LEAVES names, for the causes written there.
The leaves named in LIVE must be nonzero in both packages.  One test item
per family; its message names every configuration and leaf that failed.
"""
import contextlib
import os
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import core_tpu.scenes as j_scenes
from core_tpu import diff as jdiff
from core_tpu import film as jfilm
from core_tpu import render as jrender
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.film import FilterType as JFilterType
from core_tpu.integrators import bidir as jbidir
from core_tpu.integrators import direct as jdirect
from core_tpu.integrators import path as jpath
from core_tpu.integrators import photonmap as jpm
from core_tpu.integrators import sppm as jsppm
from core_tpu.integrators import volume as jvol
from core_tpu.params import ParamMap as JParamMap
from core_tpu.photon import map as jmap
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.scenes import golden_volume_scene as j_golden_volume_scene
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert, diff
from core_tpu_torch import render as trender
from core_tpu_torch.cameras import shoot_ray as t_shoot_ray
from core_tpu_torch.film import FilterType
from core_tpu_torch.integrators import bidir as tbidir
from core_tpu_torch.integrators import direct as tdirect
from core_tpu_torch.integrators import path as tpath
from core_tpu_torch.integrators import photonmap as tpm
from core_tpu_torch.integrators import sppm as tsppm
from core_tpu_torch.integrators import volume as tvol

from chip_smoke import grad_image, light_zoo_builder
from test_sss import _sss_scene
from test_torch_bidir import _port_halton
from test_torch_diff import once_per_run
from test_torch_light_zoo import FILM as LZ_FILM
from test_torch_light_zoo import SMALL as LZ_SMALL
from test_torch_photon import BOX, _compiled_gathers
from test_torch_volume import _fog_box, _sky_scene

torch.set_num_threads(1)
RES = 16
RTOL_LOSS = 1e-4
RTOL_GRAD = 1e-3
N_PHOTONS = 2048
# the SSS map's photons: the camera wavefront's width, so the eager shoot's
# primitives are those the render compiles
SSS_PHOTONS = RES * RES
PH_RADIUS = 30.0
STEPS = 4

# each package's option classes, by name
PKG = {
    "core": dict(RenderOptions=jrender.RenderOptions,
                 DirectOptions=jdirect.DirectOptions,
                 PathOptions=jpath.PathOptions,
                 PhotonOptions=jpm.PhotonOptions,
                 SPPMOptions=jsppm.SPPMOptions,
                 BidirOptions=jbidir.BidirOptions,
                 VolumeOptions=jvol.VolumeOptions, FilterType=JFilterType),
    "port": dict(RenderOptions=trender.RenderOptions,
                 DirectOptions=tdirect.DirectOptions,
                 PathOptions=tpath.PathOptions,
                 PhotonOptions=tpm.PhotonOptions,
                 SPPMOptions=tsppm.SPPMOptions,
                 BidirOptions=tbidir.BidirOptions,
                 VolumeOptions=tvol.VolumeOptions, FilterType=FilterType),
}


def _lz_scene():
    return light_zoo_builder(JSceneBuilder(), JParamMap, j_scenes, RES,
                             **LZ_SMALL).compile_scene()


SCENES = {
    "light_zoo": _lz_scene,
    "photon_box": lambda: j_cornell_box(**PH_BOX, intersector="brute"),
    "cornell": lambda: j_cornell_box(resx=RES, resy=RES, light_samples=1,
                                     intersector="brute"),
    "translucent_box": lambda: _sss_scene(res=RES),
    "fog_box": lambda: _fog_box("core"),
    "volume_golden": lambda: j_golden_volume_scene(RES, RES),
    "sky": lambda: _sky_scene("core"),
}

# test_torch_photon.py's box with a mirror block where its glass block
# stands: the glass block's bottom face is coplanar with the floor, and the
# photons that reach it from inside flip between the packages on that tie
PH_BOX = dict(BOX, block_materials=("mirror", "glossy"))
PH = dict(photons=N_PHOTONS, c_photons=N_PHOTONS, bounces=2,
          diffuse_radius=PH_RADIUS, caustic_radius=PH_RADIUS,
          final_gather=True, fg_samples=1, raydepth=0)
SSS = dict(use_sss=True, sss_photons=SSS_PHOTONS, sss_steps=2)
VOL = dict(integrator="singlescatter", steps=STEPS)
SKY = dict(integrator="sky", steps=4, sky_alpha=0.5, sky_scale=0.02,
           sky_turbidity=3.0)

# the sky scene's camera looks straight down the diagonal of its ground
# quad, and the rays of these pixels pass through that diagonal: core_tpu's
# intersection misses both of its triangles there and the port's hits one
# (a tie in the forward pass, on the same rays), so the loss leaves them out
SKY_TIES = ((7, 7), (13, 13))

# family: {configuration: (scene, integrator, (options class, fields),
#                          RenderOptions fields, a map built in the loss)}
FAMILIES = {
    "lights": {
        "lightzoo_dl": ("light_zoo", "directlight",
                        ("DirectOptions", dict(raydepth=1)),
                        dict(filter=LZ_FILM), False),
        "lightzoo_pt": ("light_zoo", "pathtracing",
                        ("PathOptions", dict(path_samples=1, bounces=1,
                                             raydepth=0)),
                        dict(filter=LZ_FILM), False),
    },
    "photons": {
        "box_pm": ("photon_box", "photonmapping", ("PhotonOptions", PH), {},
                   True),
        "box_pt_caustic": ("photon_box", "pathtracing", (
            "PathOptions", dict(path_samples=1, bounces=1, raydepth=0,
                                caustic_type="photon", c_photons=N_PHOTONS,
                                caustic_radius=PH_RADIUS, caustic_depth=2)),
            {}, True),
        "box_sppm": ("photon_box", "SPPM", ("SPPMOptions", dict(
            passes=2, photons=N_PHOTONS, bounces=2, search_radius=PH_RADIUS,
            raydepth=1, pm_ire=True)), {}, True),
    },
    "bidir_sss": {
        "cornell_bd": ("cornell", "bidirectional", (
            "BidirOptions", dict(eye_depth=2, light_depth=2,
                                 do_light_image=True)), {}, False),
        "sss_dl": ("translucent_box", "directlight",
                   ("DirectOptions", dict(raydepth=0, **SSS)), {}, True),
        "sss_pt": ("translucent_box", "pathtracing",
                   ("PathOptions", dict(path_samples=1, bounces=1,
                                        raydepth=0, **SSS)), {}, True),
    },
    "volumes": {
        "fog_pt": ("fog_box", "pathtracing",
                   ("PathOptions", dict(path_samples=1, bounces=1,
                                        raydepth=0)),
                   dict(volume=VOL), False),
        "volume_ss": ("volume_golden", "directlight",
                      ("DirectOptions", dict(raydepth=0)),
                      dict(volume=VOL, filter=dict(filter_type="BOX",
                                                   filter_size=1.0)), False),
        "sky_dl": ("sky", "directlight", ("DirectOptions", dict(raydepth=0)),
                   dict(volume=SKY, exclude=SKY_TIES), False),
    },
}

# families whose core_tpu side renders the port's camera rays (_port_camera)
SHARED_RAYS = ("volumes",)

# entries of core_tpu's gradient that are NaN (ROADMAP Queue 3, known
# caveats of the reference): there is nothing to hold the port's against,
# so they are not compared; every other entry is, and the port's must be
# finite everywhere but where core_tpu's NaN comes from arithmetic the port
# shares.
# - fog_pt: an ExpDensity region's tau (core_tpu volumes/regions.py:199,
#   294-300) marches rays that miss its box too, far from it, where
#   a * exp(-b h) overflows to inf; jnp.where masks those lanes' depths,
#   and the backward multiplies the mask's zero cotangent by that inf.  The
#   NEE transmittance's rays come from the light's geometry and the
#   shading points.  The port marches the same way: NaN at the same entries.
# - box_sppm: the eye pass divides by max(total, 1e-20) (integrators/
#   sppm.py:144) and on lanes whose branch weights are all 0 the inverse's
#   derivative overflows to inf; jnp.maximum's backward multiplies it by
#   its 0/1 mask: NaN in every material row those lanes read.  The port's
#   clamp_min masks it: its entries are finite.
NAN_LEAVES = {("fog_pt", leaf): "shared" for leaf in (
    "geom.obj_offset", "light0.corner", "light0.to_x", "light0.to_y")}
NAN_LEAVES.update({("box_sppm", leaf): "finite" for leaf in (
    "mat.diffuse_color", "mat.mirror_color", "mat.strengths",
    "mat.transmit_filter")})

# leaves whose gradient is 0 by symmetry: sums of terms that cancel, in
# core_tpu exactly and in the port to within its rounding of them, so the
# port's may be up to ZERO_ULPS x the configuration's largest gradient
# instead of exactly 0.  The sky scene's sun is a directional light, so a
# translation of the ground changes no radiance; its normal's gradient
# reaches the ground's vertices from both ends of each edge (measured:
# 1.46e-11, 7.8e-13 of mat.strengths' 18.7).
ZERO_ULPS = 1e-9
SUM_TO_ZERO = {("sky_dl", "geom.obj_offset")}

# leaves whose gradient must be nonzero in both packages
LIVE = {
    "lightzoo_dl": ("light1.color", "light1.center", "light2.color",
                    "light4.color", "mat.diffuse_color", "mat.glossy_color",
                    "mat.glossy_reflect", "mat.strengths",
                    "mat.emit_strength", "geom.obj_offset"),
    "lightzoo_pt": ("light1.color", "light1.center", "light2.color",
                    "light4.color", "mat.diffuse_color", "mat.glossy_color",
                    "mat.glossy_reflect", "mat.strengths",
                    "mat.emit_strength", "geom.obj_offset"),
    "box_pm": ("light0.color", "mat.diffuse_color", "mat.mirror_color",
               "mat.glossy_color", "mat.strengths"),
    "box_pt_caustic": ("light0.color", "mat.diffuse_color",
                       "mat.mirror_color", "mat.glossy_color",
                       "mat.strengths"),
    "box_sppm": ("light0.color", "light0.corner", "mat.glossy_color",
                 "mat.emit_strength"),
    "cornell_bd": ("light0.color", "light0.corner", "light0.to_x",
                   "light0.to_y", "mat.diffuse_color", "mat.strengths",
                   "geom.obj_offset"),
    "sss_dl": ("light0.color", "light0.corner", "light0.to_x", "light0.to_y",
               "mat.diffuse_color", "mat.glossy_color", "mat.glossy_reflect",
               "mat.strengths"),
    "sss_pt": ("light0.color", "light0.corner", "light0.to_x", "light0.to_y",
               "mat.diffuse_color", "mat.glossy_color", "mat.glossy_reflect",
               "mat.strengths"),
    "fog_pt": ("light0.color", "mat.diffuse_color", "mat.strengths",
               "mat.emit_strength"),
    "volume_ss": ("light0.color", "light0.pos", "mat.diffuse_color",
                  "mat.strengths", "geom.obj_offset"),
    "sky_dl": ("mat.diffuse_color", "mat.strengths", "mat.emit_strength"),
}


def _opts(pkg, integrator, io, extra):
    ns = PKG[pkg]
    cls, fields = io
    kw = {}
    if "filter" in extra:
        kw.update(filter_type=ns["FilterType"][extra["filter"][
            "filter_type"]], filter_size=extra["filter"]["filter_size"])
    if "volume" in extra:
        kw["volume_opts"] = ns["VolumeOptions"](**extra["volume"])
    return ns["RenderOptions"](integrator=integrator,
                               integrator_opts=ns[cls](**fields), **kw)


def _with_jit(fn):
    """fn run with jit enabled, inside jax.disable_jit too."""
    def call(*a, **kw):
        with jax.disable_jit(False):
            return fn(*a, **kw)
    return call


@contextlib.contextmanager
def _eager_shoots():
    """core_tpu's photon and SSS shoots eagerly (jax.disable_jit), its two
    photon gathers compiled (test_torch_photon._compiled_gathers)."""
    with _compiled_gathers(), \
            mock.patch.object(jmap, "gather_photons",
                              _with_jit(jmap.gather_photons)), \
            mock.patch.object(jsppm, "_gather_flat",
                              _with_jit(jsppm._gather_flat)), \
            jax.disable_jit():
        yield


def _j_image(sc, opts):
    """core_tpu's image of one configuration, [H, W, 4]."""
    types = jrender.scene_material_types(sc)
    if opts.integrator == "SPPM":
        with _eager_shoots():
            return jsppm.render_sppm(sc, opts.integrator_opts)
    with _eager_shoots():
        aux = jrender.integrator_preprocess(sc, types, opts)
    vol_aux = jvol.precompute_attenuation(sc, opts.volume_opts)
    cam = sc.camera
    film = jrender.render_chunk(sc, types, opts,
                                jfilm.make_film(cam.resy, cam.resx), 0, 1, 0,
                                None, aux=aux, vol_aux=vol_aux)
    return jfilm.flush(film)


@contextlib.contextmanager
def _port_camera(js):
    """core_tpu's camera rays answered by the port's for the same pixel
    and lens samples.  A render's camera rays differ between the packages
    by an ulp on some lanes, and a march whose first sample lies on a
    volume box's face then counts it inside in one package only
    (test_torch_volume.py compares its marches on shared rays for that
    reason).  The rays carry no leaf, so the gradients are the same
    functions of them in both packages."""
    ts = convert.scene_from_numpy(*convert.scene_to_numpy(js), device="cpu")

    def shoot(cam, px, py, lu=None, lv=None):
        lens = (None, None) if ts.camera.aperture == 0.0 else (
            torch.from_numpy(np.asarray(lu)), torch.from_numpy(np.asarray(lv)))
        rays, wt = t_shoot_ray(ts.camera, torch.from_numpy(np.asarray(px)),
                               torch.from_numpy(np.asarray(py)), *lens)
        return JRays(*(jnp.asarray(a.numpy()) for a in rays)), \
            jnp.asarray(wt.numpy())

    with mock.patch.object(jrender, "shoot_ray", shoot):
        yield


def _keep(extra, h, w):
    """[H, W] 1 on the pixels the loss sees, 0 on the configuration's
    excluded ones; None when it sees them all."""
    if "exclude" not in extra:
        return None
    keep = np.ones((h, w), np.float32)
    keep[tuple(np.transpose(extra["exclude"]))] = 0.0
    return keep


def _leaves(params, map_in_loss):
    if map_in_loss:
        params = {k: v for k, v in params.items() if k != "geom.obj_offset"}
    return params


def _core_tpu_family(family) -> dict:
    """core_tpu's loss and gradients of every configuration of a family,
    {"cfg:loss": [], "cfg:leaf": gradient, "cfg:seconds": []}."""
    out, scenes = {}, {}
    for cfg, (scene, integ, io, extra, in_loss) in FAMILIES[family].items():
        t0 = time.perf_counter()
        if scene not in scenes:
            scenes[scene] = SCENES[scene]()
        js = scenes[scene]
        opts = _opts("core", integ, io, extra)
        keep = _keep(extra, js.camera.resy, js.camera.resx)

        def loss_fn(params):
            img = _j_image(jdiff.apply_params(js, params), opts)
            if keep is None:
                return jnp.mean(img[..., :3] ** 2)
            return jnp.sum(img[..., :3] ** 2 * keep[..., None]) \
                / (3.0 * keep.sum())

        with _port_halton(), (_port_camera(js) if family in SHARED_RAYS
                               else contextlib.nullcontext()):
            loss, grads = jax.value_and_grad(loss_fn)(
                _leaves(jdiff.extract_params(js, geometry=True), in_loss))
        out[f"{cfg}:loss"] = np.asarray(loss)
        for k, g in grads.items():
            out[f"{cfg}:{k}"] = np.asarray(g)
        out[f"{cfg}:seconds"] = np.asarray(time.perf_counter() - t0)
    return out


def _port_family(family) -> dict:
    """The port's loss and gradients of every configuration of a family,
    each scene carried across from core_tpu's by convert.py."""
    out, scenes = {}, {}
    for cfg, (scene, integ, io, extra, in_loss) in FAMILIES[family].items():
        if scene not in scenes:
            scenes[scene] = convert.scene_from_numpy(
                *convert.scene_to_numpy(SCENES[scene]()), device="cpu")
        ts = scenes[scene]
        opts = _opts("port", integ, io, extra)
        keep = _keep(extra, ts.camera.resy, ts.camera.resx)

        def loss_fn(params):
            img = grad_image(diff.apply_params(ts, params), opts)
            if keep is None:
                return torch.mean(img[..., :3] ** 2)
            return torch.sum(img[..., :3] ** 2
                             * torch.from_numpy(keep)[..., None]) \
                / (3.0 * float(keep.sum()))

        loss, grads = diff.value_and_grad(loss_fn)(
            _leaves(diff.extract_params(ts, geometry=True), in_loss))
        out[f"{cfg}:loss"] = loss.numpy()
        for k, g in grads.items():
            out[f"{cfg}:{k}"] = g.numpy()
    return out


def _compare(family, core, port):
    """Every configuration's loss and leaves; returns the failures."""
    bad = []
    for cfg in FAMILIES[family]:
        jl, tl = float(core[f"{cfg}:loss"]), float(port[f"{cfg}:loss"])
        if not np.isfinite(tl) or abs(tl - jl) > RTOL_LOSS * abs(jl):
            bad.append(f"{cfg} loss: port {tl!r}, core_tpu {jl!r}")
        jleaves = sorted(k[len(cfg) + 1:] for k in core
                         if k.startswith(cfg + ":") and k.count(":") == 1
                         and k[len(cfg) + 1:] not in ("loss", "seconds"))
        tleaves = sorted(k[len(cfg) + 1:] for k in port
                         if k.startswith(cfg + ":")
                         and k[len(cfg) + 1:] != "loss")
        if jleaves != tleaves:
            bad.append(f"{cfg} leaves: port {tleaves}, core_tpu {jleaves}")
            continue
        top = max(float(np.nanmax(np.abs(core[f"{cfg}:{k}"])))
                  for k in jleaves)
        for leaf in jleaves:
            want, got = core[f"{cfg}:{leaf}"], port[f"{cfg}:{leaf}"]
            if got.shape != want.shape:
                bad.append(f"{cfg} {leaf}: shape {got.shape}, core_tpu's "
                           f"{want.shape}")
                continue
            # core_tpu's NaN entries only where NAN_LEAVES expects them,
            # and the port's as NAN_LEAVES says
            nan = np.isnan(want)
            kind = NAN_LEAVES.get((cfg, leaf))
            want_nan = nan if kind == "shared" else np.zeros_like(nan)
            if (nan.any() and kind is None) \
                    or (np.isnan(got) != want_nan).any():
                bad.append(f"{cfg} {leaf}: NaN at "
                           f"{np.argwhere(np.isnan(got)).tolist()}, "
                           f"core_tpu's at {np.argwhere(nan).tolist()}")
                continue
            if kind is not None and not nan.any():
                bad.append(f"{cfg} {leaf}: core_tpu's gradient has no NaN")
            want, got = want[~nan], got[~nan]
            if not np.isfinite(got).all():
                bad.append(f"{cfg} {leaf}: not finite")
                continue
            scale = float(np.abs(want).max(initial=0.0))
            err = float(np.abs(got - want).max(initial=0.0))
            if (cfg, leaf) in SUM_TO_ZERO and scale == 0.0:
                scale = ZERO_ULPS / RTOL_GRAD * top
            if err > RTOL_GRAD * scale or (scale == 0.0 and err != 0.0):
                bad.append(f"{cfg} {leaf}: max |port - core_tpu| {err:.4e}"
                           f" > {RTOL_GRAD} x max|g| {scale:.4e}")
        for leaf in LIVE[cfg]:
            for who, g in (("core_tpu", core), ("port", port)):
                if not float(np.nanmax(np.abs(g[f"{cfg}:{leaf}"]))) > 0.0:
                    bad.append(f"{cfg} {leaf}: zero gradient in {who}")
    return bad


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_grads_match_core_tpu(family, tmp_path_factory):
    core, by = once_per_run(tmp_path_factory, f"torch_grad_{family}",
                            lambda: _core_tpu_family(family))
    port = _port_family(family)
    secs = {cfg: round(float(core[f"{cfg}:seconds"]), 2)
            for cfg in FAMILIES[family]}
    print(f"grad {family}: core_tpu's side computed by {by} ({secs} s), "
          f"read by {os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    bad = _compare(family, core, port)
    assert not bad, f"{family}: " + "; ".join(bad)
