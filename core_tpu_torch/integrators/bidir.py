"""Bidirectional path tracer, wavefront form, pdf-ratio MIS
(counterpart of core_tpu/integrators/bidir.py).

Reference: src/integrators/bidirpath.cc + include/integrators/bdpt.h: eye
and light subpaths, vertex connections (connectPaths / connectLPath /
connectPathE), per-technique pdf-ratio weights under the MAXIMUM heuristic
(pathWeight / pathWeight_0t, bidirpath.cc:697-830), s=1 light sampling and
t=1 light-image splats.

Both subpaths are fixed-depth wavefront loops that keep one vertex record
per depth (SoA: vec.V3, vec.SPS, MatParamsS; no russian roulette, so the
reference's qi factors are 1).  Every (eye i, light j) vertex pair is
connected with one visibility launch (scene.any_hit_s: kernel 3 on a brute
scene, 5 on a flat one, 8 on a grouped one), two BSDF evals and four BSDF
pdfs; the subpaths trace through scene.closest_hit_s (kernel 1, 4 or 7).
Every lane advances in lockstep under masks.

Strategies per path length k (k segments):
  s=0  the eye path hits an emitter              (pathWeight_0t)
  s=1  one light sample at the eye vertex        (connectLPath)
  s>=2 a connection eye_i <-> light_j            (connectPaths)
  t=1  a light vertex connected to the camera, splatted into the film's
       light image (film.add_density_samples), merged at flush scaled by
       w*h / n_paths (imagefilm.cc:402,411).

The QMC dimensions are core_tpu's: the eye walk from 2, the light's
emission 20-24 and its walk from 25, the s=1 light pick 40 + i and its
sample 44 + 2i, 45 + 2i at eye vertex i.  Every light is evaluated on every
lane and the picked one selected, as core_tpu does.  Visibility rays whose
connection is masked out anyway get dead t caps (0 < tcap <= tmin), which
changes no result.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.cameras import project
from core_tpu_torch.integrators.photonmap import scene_center_radius
from core_tpu_torch.lights import base as light_base
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST, SHADOW_BIAS, luminance
from core_tpu_torch.photon.emit import emit_photon
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (V3, RaysS, dot3, rays_to_soa, splat3,
                                where3, zeros3)

_EPS = 1e-20
_DEAD_TCAP = 0.5 * SHADOW_BIAS   # 0 < tcap <= tmin: an empty t interval


@dataclass(frozen=True)
class BidirOptions:
    """core_tpu's BidirOptions (core_tpu/integrators/bidir.py:52-57)."""
    eye_depth: int = 3          # eye subpath surface vertices
    light_depth: int = 3        # light subpath surface vertices
    transp_background: bool = False
    do_light_image: bool = True  # t=1 light-tracing splats (_DO_LIGHTIMAGE)


class _Vertex:
    """One wavefront of subpath vertices (the reference's pathVertex_t):
    pdf_wo / cos_wo the sampled continuation's solid-angle pdf and |cos|,
    pdf_wi / cos_wi the reverse pdf and the incoming |cos|, G the geometric
    factor to the previous vertex, specular the sampled delta flag."""

    def __init__(self, sp, p, wo, throughput, active, cos_wi, ds, G):
        self.sp = sp
        self.p = p
        self.wo = wo                  # V3 toward the previous vertex
        self.throughput = throughput  # V3: the weight up to here
        self.active = active
        self.cos_wi = cos_wi
        self.ds = ds                  # squared distance to the previous one
        self.G = G
        self.pdf_wo = None
        self.cos_wo = None
        self.pdf_wi = None
        self.specular = None


def _open_rays(o: V3, d: V3) -> RaysS:
    return RaysS(o=o, d=d, tmin=torch.full_like(o.x, MIN_RAYDIST),
                 tmax=torch.full_like(o.x, -1.0))


def _walk(scene, types_present, rays: RaysS, throughput0: V3, active0,
          depth: int, base, dim0: int, prev_cos_wo):
    """Trace a subpath (createPath, bidirpath.cc:355-430): one _Vertex per
    surface hit, with the pdf bookkeeping of core_tpu's _walk."""
    verts = []
    throughput = throughput0
    active = active0
    exclude = None
    cur = rays
    dim = dim0
    prev_p = rays.o
    prev_cos = prev_cos_wo
    for d in range(depth):
        hits = scene_mod.closest_hit_s(scene, cur, exclude_prim=exclude)
        active = active & hits.valid
        sp = scene_mod.surface_points_s(scene, cur, hits)
        p = scene_mod.material_params_s(scene, sp)
        wo = -cur.d
        cos_wi = dot3(cur.d, sp.n).abs()
        dp = sp.p - prev_p
        ds = dot3(dp, dp)
        G = prev_cos * cos_wi / ds.clamp_min(_EPS)
        v = _Vertex(sp, p, wo, throughput, active, cos_wi, ds, G)
        verts.append(v)
        s1 = qmc.scr_halton(dim, base)
        s2 = qmc.scr_halton(dim + 1, base)
        dim += 2
        sres = detach_sample(dispatch.sample_bsdf_s(
            types_present, p, sp, wo, s1, s2, BSDF.ALL))
        v.pdf_wo = sres.pdf
        v.cos_wo = sres.w * sres.pdf          # W = |cos| / pdf -> |cos|
        v.specular = (sres.flags & BSDF.SPECULAR) != 0
        rev = dispatch.pdf_bsdf_s(types_present, p, sp, sres.wi, wo,
                                  BSDF.ALL)
        # a specular event has no meaningful reverse pdf; the weighting
        # zeroes the adjacent techniques anyway: the forward pdf stands in
        v.pdf_wi = torch.where(v.specular, sres.pdf, rev)
        if d == depth - 1:
            break
        throughput = throughput * sres.col * sres.w
        active = active & (sres.pdf > 0) & (luminance(throughput) > 0)
        cur = _open_rays(sp.p, sres.wi)
        exclude = sp.prim
        prev_p = sp.p
        prev_cos = v.cos_wo
    return verts


def _safe_div(a, b):
    return a / b.clamp_min(_EPS)


def _max_heuristic(p, s):
    """1 where no other technique has a larger pdf than p[s] (pathWeight's
    maximum heuristic, compared after the corrections), else 0."""
    ref = p[s]
    worse = torch.zeros_like(ref, dtype=torch.bool)
    for i, pi in enumerate(p):
        if i != s and pi is not None:
            worse = worse | (pi > ref)
    return torch.where(worse, 0.0, 1.0)


def _path_weight(pdf_f, pdf_b, G, spec, pdf_A_0, s, k, light_image,
                 singular_l, pdf_illum, pdf_emit):
    """pathWeight (bidirpath.cc:697-759) over the lanes.  pdf_f / pdf_b /
    G / spec: python lists of [N] tensors indexed 0..k (None where no
    technique reads them); pdf_A_0 [N]; s the technique (light vertices);
    k = s + t - 1."""
    p = [None] * (k + 2)
    p[s] = torch.ones_like(pdf_A_0)
    for i in range(s, k):
        p[i + 1] = p[i] * _safe_div(pdf_f[i - 1] * G[i],
                                    pdf_b[i + 1] * G[i + 1])
    for i in range(s - 1, 0, -1):
        p[i] = p[i + 1] * _safe_div(pdf_b[i + 1] * G[i + 1],
                                    pdf_f[i - 1] * G[i])
    if s >= 1:
        p[0] = p[1] * _safe_div(pdf_b[1] * G[1], pdf_A_0)
    p[k + 1] = None          # camera-lens hits cannot be sampled
    if not light_image and k >= 0:
        p[k] = None          # the t=1 technique is off
    _zero_specular(p, spec, k)
    if p[0] is not None:
        p[0] = torch.where(singular_l, 0.0, p[0])
    # the direct-lighting correction (unconditional in the reference; for
    # s=1 it rescales p[s] itself and the comparison is relative)
    if p[1] is not None:
        p[1] = p[1] * torch.where(singular_l, 1.0,
                                  _safe_div(pdf_illum, pdf_emit))
    return _max_heuristic(p, s)


def _zero_specular(p, spec, k):
    """A specular vertex i rules out the techniques i and i + 1."""
    for i in range(k + 1):
        if spec[i] is None:
            continue
        if p[i] is not None:
            p[i] = torch.where(spec[i], 0.0, p[i])
        if p[i + 1] is not None:
            p[i + 1] = torch.where(spec[i], 0.0, p[i + 1])


def _emission(scene, n_lights, base, like):
    """The light subpath's origin (bidirpath.cc:215-231): every light
    emits on every lane, the one picked by scr_halton(24) is kept."""
    s1, s2, s3, s4 = (qmc.scr_halton(dim, base) for dim in (20, 21, 22, 23))
    pick = (qmc.scr_halton(24, base) * n_lights).to(torch.int32) \
        .clamp_max(n_lights - 1)
    center, radius = scene_center_radius(scene)
    z3 = zeros3(like)
    ones = torch.ones_like(like)
    o, d, col = z3, z3, z3
    ipdf = torch.zeros_like(like)
    area_pdf, dir_pdf, cos_wo = ones, ones, ones
    spec = torch.zeros_like(like, dtype=torch.bool)
    sing = torch.zeros_like(like, dtype=torch.bool)
    for li, light in enumerate(scene.lights):
        lo, ld, lc, lip = emit_photon(light, s1, s2, s3, s4, center, radius)
        ap, dp, cw, sng, ddir = light_base.emit_pdf(light, lo, ld,
                                                    scene_radius=radius)
        m = pick == li
        o, d, col = where3(m, lo, o), where3(m, ld, d), where3(m, lc, col)
        ipdf = torch.where(m, lip, ipdf)
        area_pdf = torch.where(m, ap, area_pdf)
        dir_pdf = torch.where(m, dp, dir_pdf)
        cos_wo = torch.where(m, cw, cos_wo)
        spec = spec | (m & bool(ddir))
        sing = sing | (m & bool(sng))
    return pick, o, d, col * (ipdf * n_lights), area_pdf, dir_pdf, cos_wo, \
        spec, sing


def _inner_light_pdfs(light_verts, j, pdf_f, pdf_b, G, spec):
    """The light subpath's inner vertices 1..s-2 of a connection to its
    vertex j."""
    for m in range(j):
        v = light_verts[m]
        pdf_f[m + 1] = _safe_div(v.pdf_wo, v.cos_wo)
        pdf_b[m + 1] = _safe_div(v.pdf_wi, v.cos_wi)
        G[m + 1] = v.G
        spec[m + 1] = v.specular


def _visible(scene, o: V3, d: V3, r, live, exclude_prim, exclude_prim2=None):
    """[N] bool: nothing between o and o + r d (SHADOW_BIAS off both
    ends); lanes that are not live get a dead cap."""
    tcap = torch.where(live, r - SHADOW_BIAS, _DEAD_TCAP)
    rays = RaysS(o=o, d=d, tmin=torch.full_like(r, SHADOW_BIAS), tmax=tcap)
    return ~scene_mod.any_hit_s(scene, rays, exclude_prim=exclude_prim,
                                exclude_prim2=exclude_prim2)


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: BidirOptions):
    """BDPT integrate() for a camera wavefront -> (rgba [N, 4], splat).

    rays: types.Rays ([N, 3] o, d); pixel_sample, sampling_offs: [N] int64
    tensors holding uint32 values.  splat: the t=1 light-image splats
    (px, py, colour V3, mask, n_paths) for film.add_density_samples, or
    None when the light image is off."""
    rs = rays_to_soa(rays)
    like = rs.tmin
    n = like.shape[0]
    base = (pixel_sample * 7919 + sampling_offs) & qmc.MASK32
    n_lights = len(scene.lights)
    cam = scene.camera
    ones = torch.ones_like(like)

    # the camera vertex (eyePath[0], bidirpath.cc:175-190): pdf_wo the
    # image plane's importance pdf of the primary direction, cos_wo 1
    cam_pdf = _camera_pdf(cam, rs.d)

    eye = _walk(scene, types_present, rs, V3(ones, ones, ones),
                torch.ones_like(like, dtype=torch.bool), opts.eye_depth,
                base, dim0=2, prev_cos_wo=ones)
    primary_valid = eye[0].active

    light_verts = []
    l0 = None
    if n_lights > 0 and opts.light_depth > 0:
        pick, o, d, lpow, area_pdf, dir_pdf, cos_wo0, spec0, sing0 = \
            _emission(scene, n_lights, base, like)
        light_verts = _walk(scene, types_present, _open_rays(o, d), lpow,
                            torch.ones_like(like, dtype=torch.bool),
                            opts.light_depth, base, dim0=25,
                            prev_cos_wo=cos_wo0)
        # the pick pdf is uniform 1/n_lights, and the reference's
        # lightNumPdf is relative to uniform: a factor 1
        l0 = dict(area_pdf=area_pdf, pdf_f=_safe_div(dir_pdf, cos_wo0),
                  spec=spec0, singular=sing0, pdf_illum=ones, pdf_emit=ones)
        if light_verts:
            lv1 = light_verts[0]
            pdf_illum = torch.zeros_like(like)
            for li, light in enumerate(scene.lights):
                pdf_illum = torch.where(pick == li, light_base.illum_pdf_s(
                    light, lv1.sp, o), pdf_illum)
            l0["pdf_illum"] = pdf_illum
            l0["pdf_emit"] = area_pdf * lv1.ds / cos_wo0.clamp_min(1e-9)

    light_image = opts.do_light_image and len(light_verts) > 0 \
        and cam is not None

    def eye_tail(pdf_f, pdf_b, G, spec, s, t, i):
        """copyEyeSubpath: entries s+1..k from eye vertices i-1..0 and the
        camera vertex at k."""
        for m in range(i):
            v = eye[i - 1 - m]
            ip = s + 1 + m
            pdf_f[ip] = _safe_div(v.pdf_wi, v.cos_wi)
            pdf_b[ip] = _safe_div(v.pdf_wo, v.cos_wo)
            G[ip] = eye[i - m].G
            spec[ip] = v.specular
        k = s + t - 1
        pdf_f[k] = ones
        pdf_b[k] = cam_pdf
        G[k] = eye[0].G
        spec[k] = None

    col = zeros3(like)
    for i, ev in enumerate(eye):
        t = i + 2                            # eye vertices, camera included

        # s=0: the eye path hit an emitter (pathWeight_0t)
        has_emit = (ev.p.flags & BSDF.EMIT) != 0
        w0 = ones if i == 0 else _weight_0t(scene, eye, i, cam_pdf,
                                            light_image, ones)
        col = col + where3(ev.active & has_emit, ev.throughput
                           * dispatch.emit_ss(types_present, ev.p) * w0, 0.0)

        # s=1: one light sample at this eye vertex (connectLPath)
        if n_lights > 0:
            col = col + _connect_light_sample(scene, types_present, eye, i,
                                              base, light_image, ones,
                                              eye_tail)

        # s>=2: a connection to every light surface vertex (connectPaths)
        for j, lv in enumerate(light_verts):
            s = j + 2
            k = s + t - 1
            delta = lv.sp.p - ev.sp.p
            r2 = dot3(delta, delta)
            r = torch.sqrt(r2.clamp_min(1e-12))
            cdir = V3(delta.x / r, delta.y / r, delta.z / r)
            cos_e = dot3(ev.sp.n, cdir).abs()
            cos_l = dot3(lv.sp.n, -cdir).abs()
            g = _safe_div(cos_e * cos_l, r2)
            f_e = dispatch.eval_bsdf_s(types_present, ev.p, ev.sp, ev.wo,
                                       cdir, BSDF.ALL)
            f_l = dispatch.eval_bsdf_s(types_present, lv.p, lv.sp, lv.wo,
                                       -cdir, BSDF.ALL)
            live = ev.active & lv.active & (r2 > 1e-8)
            ok = live & _visible(scene, ev.sp.p, cdir, r, live, ev.sp.prim,
                                 lv.sp.prim)

            # the unified path's pdfs (connectPaths, bidirpath.cc:468-546)
            pdf_f, pdf_b, G, spec = ([None] * (k + 1) for _ in range(4))
            pdf_f[0] = l0["pdf_f"]
            spec[0] = l0["spec"]
            _inner_light_pdfs(light_verts, j, pdf_f, pdf_b, G, spec)
            y_pdf_f = dispatch.pdf_bsdf_s(types_present, lv.p, lv.sp, lv.wo,
                                          cdir, BSDF.ALL)
            y_pdf_b = dispatch.pdf_bsdf_s(types_present, lv.p, lv.sp, cdir,
                                          lv.wo, BSDF.ALL)
            pdf_f[s - 1] = _safe_div(y_pdf_f, cos_l)
            pdf_b[s - 1] = _safe_div(y_pdf_b, lv.cos_wi)
            G[s - 1] = lv.G
            spec[s - 1] = None
            z_pdf_b = dispatch.pdf_bsdf_s(types_present, ev.p, ev.sp, ev.wo,
                                          -cdir, BSDF.ALL)
            z_pdf_f = dispatch.pdf_bsdf_s(types_present, ev.p, ev.sp, -cdir,
                                          ev.wo, BSDF.ALL)
            pdf_b[s] = _safe_div(z_pdf_b, cos_e)
            pdf_f[s] = _safe_div(z_pdf_f, ev.cos_wi)
            G[s] = g
            spec[s] = None
            eye_tail(pdf_f, pdf_b, G, spec, s, t, i)

            wt = _path_weight(pdf_f, pdf_b, G, spec, l0["area_pdf"], s, k,
                              light_image, l0["singular"], l0["pdf_illum"],
                              l0["pdf_emit"])
            # connectPaths returns false where a connection pdf vanishes
            wt = wt * (y_pdf_f > 1e-6) * (z_pdf_b > 1e-6)
            contrib = ev.throughput * f_e * g * f_l * lv.throughput * wt
            col = col + where3(ok, contrib, 0.0)

    splat = _light_image(scene, types_present, light_verts, l0, ones) \
        if light_image else None

    col = where3(primary_valid, col, eval_background_s(scene.background,
                                                       rs.d))
    alpha = torch.where(primary_valid, 1.0,
                        0.0 if opts.transp_background else 1.0)
    return torch.stack([col.x, col.y, col.z, alpha], dim=-1), splat


def _light_image(scene, types_present, light_verts, l0, ones):
    """t=1: every light vertex connected to the camera (connectPathE,
    bidirpath.cc:626-690) -> (px, py, colour V3, mask, n_paths) of all
    light vertices, concatenated."""
    cam = scene.camera
    sxs, sys_, scols, smasks = [], [], [], []
    for j, lv in enumerate(light_verts):
        s = j + 2
        k = s                                # t=1 -> k = s
        delta = splat3(cam.pos) - lv.sp.p
        r2 = dot3(delta, delta)
        r = torch.sqrt(r2.clamp_min(1e-12))
        dir_le = V3(delta.x / r, delta.y / r, delta.z / r)
        px, py, cos_e, okp = project(cam, -torch.stack(list(dir_le), -1))
        f_l = dispatch.eval_bsdf_s(types_present, lv.p, lv.sp, lv.wo,
                                   dir_le, BSDF.ALL)
        cos_l = dot3(lv.sp.n, dir_le).abs()
        live = lv.active & okp
        ok = live & _visible(scene, lv.sp.p, dir_le, r, live, lv.sp.prim)
        jac = (cam.focal * cam.focal) \
            / (cos_e.clamp_min(1e-6) ** 3 * cam.aspect_ratio)

        # pathWeight(s, 1)
        pdf_f, pdf_b, G, spec = ([None] * (k + 1) for _ in range(4))
        pdf_f[0] = l0["pdf_f"]
        spec[0] = l0["spec"]
        _inner_light_pdfs(light_verts, j, pdf_f, pdf_b, G, spec)
        y_pdf_f = dispatch.pdf_bsdf_s(types_present, lv.p, lv.sp, lv.wo,
                                      dir_le, BSDF.ALL)
        y_pdf_b = dispatch.pdf_bsdf_s(types_present, lv.p, lv.sp, dir_le,
                                      lv.wo, BSDF.ALL)
        pdf_f[s - 1] = _safe_div(y_pdf_f, cos_l)
        pdf_b[s - 1] = _safe_div(y_pdf_b, lv.cos_wi)
        G[s - 1] = lv.G
        spec[s - 1] = None
        pdf_f[k] = ones
        pdf_b[k] = jac                       # the camera's importance pdf
        G[k] = _safe_div(cos_l, r2)
        spec[k] = None
        wt = _path_weight(pdf_f, pdf_b, G, spec, l0["area_pdf"], s, k, True,
                          l0["singular"], l0["pdf_illum"], l0["pdf_emit"])
        wt = wt * (y_pdf_f > 1e-6)
        contrib = lv.throughput * f_l \
            * (cos_l / r2.clamp_min(1e-8) * jac * wt)
        sxs.append(px)
        sys_.append(py)
        scols.append(where3(ok, contrib, 0.0))
        smasks.append(ok)
    cat = torch.cat
    return (cat(sxs), cat(sys_), V3(*(cat([c[a] for c in scols])
                                     for a in range(3))),
            cat(smasks), float(ones.shape[0]))


def _camera_pdf(cam, d: V3):
    """The image plane's importance pdf of a primary direction (the
    reference feeds cam->project's pdf into eyePath[0].pdf_wo)."""
    cz = dot3(d, splat3(cam.cam_z)).abs()
    return (cam.focal * cam.focal) / (cz.clamp_min(1e-6) ** 3
                                      * cam.aspect_ratio)


def _weight_0t(scene, eye, i, cam_pdf, light_image, ones):
    """pathWeight_0t (bidirpath.cc:762-830): the weight of s=0 at eye
    vertex i (t = i + 2 >= 3).  The emitter hit is path[0]; its emitPdf and
    illumPdf are evaluated for every light that is not dirac and selected
    by the hit's light id."""
    ev = eye[i]
    prev = eye[i - 1]
    if not scene.lights:
        return ones
    k = i + 1
    area_pdf, dir_pdf, cos_wo = ones, ones, ones
    pdf_illum = torch.zeros_like(ones)
    for li, light in enumerate(scene.lights):
        if light_base.dirac(light):
            continue                          # a dirac light is never hit
        ap, dp, cw, _, _ = light_base.emit_pdf(light, ev.sp.p, ev.wo)
        ip = light_base.illum_pdf_s(light, prev.sp, ev.sp.p)
        m = ev.sp.light == li
        area_pdf = torch.where(m, ap, area_pdf)
        dir_pdf = torch.where(m, dp, dir_pdf)
        cos_wo = torch.where(m, cw, cos_wo)
        pdf_illum = torch.where(m, ip, pdf_illum)
    pdf_emit = area_pdf * ev.ds / cos_wo.clamp_min(1e-9)

    pdf_f, pdf_b, G, spec = ([None] * (k + 1) for _ in range(4))
    pdf_f[0] = _safe_div(dir_pdf, cos_wo)
    # path[1] = eye[i-1] ... path[k] = the camera
    for m in range(i):
        v = eye[i - 1 - m]
        pdf_f[1 + m] = _safe_div(v.pdf_wi, v.cos_wi)
        pdf_b[1 + m] = _safe_div(v.pdf_wo, v.cos_wo)
        G[1 + m] = eye[i - m].G
        spec[1 + m] = v.specular
    pdf_f[k] = ones
    pdf_b[k] = cam_pdf
    G[k] = eye[0].G
    spec[k] = None

    # pathWeight_0t's recurrence: p[0] = 1, p[1] from the area pdf
    p = [None] * (k + 2)
    p[0] = torch.ones_like(ones)
    p[1] = _safe_div(area_pdf, pdf_b[1] * G[1])
    for i2 in range(1, k):
        p[i2 + 1] = p[i2] * _safe_div(pdf_f[i2 - 1] * G[i2],
                                      pdf_b[i2 + 1] * G[i2 + 1])
    if not light_image:
        p[k] = None
    _zero_specular(p, spec, k)
    if p[1] is not None:
        p[1] = p[1] * _safe_div(pdf_illum, pdf_emit)
    return _max_heuristic(p, 0)


def _connect_light_sample(scene, types_present, eye, i, base, light_image,
                          ones, eye_tail):
    """s=1 (connectLPath, bidirpath.cc:553-625): one light sample at eye
    vertex i, weighted by pathWeight(1, t) -> V3 [N] (masked)."""
    n_lights = len(scene.lights)
    ev = eye[i]
    t = i + 2
    s = 1
    k = t

    pick = (qmc.scr_halton(40 + i, base) * n_lights).to(torch.int32) \
        .clamp_max(n_lights - 1)
    s1 = qmc.scr_halton(44 + 2 * i, base)
    s2 = qmc.scr_halton(45 + 2 * i, base)
    diag2 = 2.0 * _scene_diag(scene)

    z3 = zeros3(ones)
    wi, lcol = z3, z3
    ldist = torch.zeros_like(ones)
    lpdf = ones
    lvalid = torch.zeros_like(ones, dtype=torch.bool)
    area_pdf, dir_pdf, cos_wo = ones, ones, ones
    spec0 = torch.zeros_like(lvalid)
    sing0 = torch.zeros_like(lvalid)
    for li, light in enumerate(scene.lights):
        sing = light_base.dirac(light)
        ls = light_base.illuminate_s(light, ev.sp) if sing else \
            light_base.illum_sample_s(light, ev.sp, s1, s2)
        m = pick == li
        wi = where3(m, ls.wi, wi)
        lcol = where3(m, ls.col, lcol)
        dist = torch.where(ls.dist > 0, ls.dist, diag2)
        ldist = torch.where(m, dist, ldist)
        lpdf = torch.where(m, ls.pdf, lpdf)
        lvalid = torch.where(m, ls.valid, lvalid)
        ap, dp, cw, sng, ddir = light_base.emit_pdf(
            light, ev.sp.p + ls.wi * dist, -ls.wi)
        area_pdf = torch.where(m, ap, area_pdf)
        dir_pdf = torch.where(m, dp, dir_pdf)
        cos_wo = torch.where(m, cw, cos_wo)
        spec0 = spec0 | (m & bool(ddir))
        sing0 = sing0 | (m & bool(sng or sing))

    f_z = dispatch.eval_bsdf_s(types_present, ev.p, ev.sp, ev.wo, wi,
                               BSDF.ALL)
    cos_z = dot3(ev.sp.n, wi).abs()
    live = ev.active & lvalid & (lpdf > 1e-6)
    ok = live & _visible(scene, ev.sp.p, wi, ldist, live, ev.sp.prim)

    z_pdf_b = dispatch.pdf_bsdf_s(types_present, ev.p, ev.sp, ev.wo, wi,
                                  BSDF.ALL)
    z_pdf_f = dispatch.pdf_bsdf_s(types_present, ev.p, ev.sp, wi, ev.wo,
                                  BSDF.ALL)
    r2 = ldist * ldist
    pdf_emit = area_pdf * r2 / cos_wo.clamp_min(1e-9)

    pdf_f, pdf_b, G, spec = ([None] * (k + 1) for _ in range(4))
    pdf_f[0] = _safe_div(dir_pdf, cos_wo)
    spec[0] = spec0
    pdf_b[1] = _safe_div(z_pdf_b, cos_z)
    pdf_f[1] = _safe_div(z_pdf_f, ev.cos_wi)
    G[1] = _safe_div(cos_wo * cos_z, r2)
    spec[1] = None
    eye_tail(pdf_f, pdf_b, G, spec, s, t, i)

    # lpdf is the solid-angle illum pdf
    wt = _path_weight(pdf_f, pdf_b, G, spec, area_pdf, s, k, light_image,
                      sing0, lpdf, pdf_emit)
    wt = wt * torch.where(sing0, 1.0, (z_pdf_b > 1e-6).to(torch.float32))
    contrib = ev.throughput * f_z * lcol \
        * (cos_z / lpdf.clamp_min(1e-12) * float(n_lights) * wt)
    return where3(ok, contrib, 0.0)


def _scene_diag(scene):
    v = scene.geom.verts
    return torch.sqrt(((v.max(dim=0).values - v.min(dim=0).values) ** 2)
                      .sum())
