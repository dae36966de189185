"""The rest of render_image in the port (adaptive AA passes, show_sam_pix,
on_flush, render_zbuffer, render and SPPM checkpoints) and the scene-file
entry points (setup_render_options, the sphere object) against core_tpu on
the same numpy inputs.

core_tpu's side runs once per test run (test_torch_diff.once_per_run),
eagerly, with its scr_halton answered by the port's (as in
tests/test_torch_bidir.py).  The scene is core_tpu's 16^2 Cornell box
(light_samples 1, directlight raydepth 1) carried across by convert.py;
the adaptive render takes aa_samples 2 then one pass of aa_inc_samples 2
over the flagged pixels (aa_threshold 0.05), in 2-spp chunks.

- next_pass_flags on a seeded 16^2 film, and on the box's film after its
  first pass: the flags equal.  A flag may flip only where a pixel's
  brightness difference to a neighbour lies within 1e-6 of aa_threshold
  (a tie decided by the packages' last ulps); each flip is named with its
  difference, and there are none on these inputs.
- The adaptive render: the image rtol 1e-4 / atol 1e-5 and the film's
  weights equal (the second pass splats only the flagged pixels); its
  flags after the first pass as above; show_sam_pix paints exactly the
  final flags red.
- render_zbuffer, raw and normalised: rtol 1e-6 / atol 1e-6.
- setup_render_options on the same ParamMaps (every surface integrator,
  each volume integrator with stepSize and a volume span, the film
  settings): every field equal.
- The sphere object: core_tpu's vertices, corner normals, uvs, faces and
  smooth flags, exactly.
- Render checkpoints: core_tpu's state after the first pass, saved by
  core_tpu's save_checkpoint, resumed by the port; and the port's
  checkpoint of a render stopped (by an on_flush that raises) at the start
  of its second pass, resumed by core_tpu: each resumed image within
  rtol 1e-4 / atol 1e-5 of the other package's uninterrupted render, and
  the port's own resume equal to its uninterrupted render.
- SPPM checkpoints: the port's file read by core_tpu's
  load_sppm_checkpoint to the same arrays; that state written back by
  core_tpu's save_sppm_checkpoint and resumed by the port equals the
  port's uninterrupted render.
- on_flush is called after every chunk with the flushed image, the pass
  and the chunk; RenderOptions has every field of core_tpu's.
"""
import dataclasses
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import checkpoint as jck
from core_tpu import film as jfilm
from core_tpu import render as jrender
from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.environment import setup_render_options as j_setup
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.params import ParamMap as JParamMap
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu_torch import checkpoint as tck
from core_tpu_torch import convert
from core_tpu_torch import film as tfilm
from core_tpu_torch import render as trender
from core_tpu_torch.environment import SceneBuilder, setup_render_options
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.sppm import SPPMOptions
from core_tpu_torch.params import ParamMap
from core_tpu_torch.render import RenderOptions, render_image

from test_torch_bidir import _port_halton
from test_torch_diff import once_per_run

torch.set_num_threads(1)
RES = 16
THRESH = 0.05
TIE = 1e-6
PASSES = dict(aa_passes=2, aa_samples=2, aa_inc_samples=2,
              aa_threshold=THRESH, spp_chunk=2)
TOL = dict(rtol=1e-4, atol=1e-5)
SPPM = dict(passes=2, photons=512, bounces=2, search_radius=40.0)
SPHERE = {"type": "sphere", "center": (0.5, -1.0, 2.0), "radius": 1.5,
          "material": "m", "tess_u": 12, "tess_v": 6}
# (render params, integrator params, volume integrator params, span)
OPTION_CASES = [
    ({}, None, None, None),
    ({"AA_passes": 3, "AA_minsamples": 4, "AA_inc_samples": 2,
      "AA_threshold": 0.02, "filter_type": "mitchell", "AA_pixelwidth": 2.0,
      "gamma": 2.2, "clamp_rgb": True, "premult": True, "bg_transp": True,
      "show_sam_pix": True, "z_channel": True},
     {"type": "directlighting", "raydepth": 3, "transpShad": True,
      "shadowDepth": 2, "do_AO": True, "AO_samples": 8, "AO_distance": 2.0,
      "AO_color": (0.5, 0.6, 0.7), "useSSS": True, "sssPhotons": 1000},
     {"type": "SingleScatterIntegrator", "stepSize": 0.2,
      "optimize": True, "attgridScale": 3}, 6.9),
    ({"filter_type": "gauss"},
     {"type": "pathtracing", "path_samples": 4, "bounces": 2,
      "caustic_type": "both", "photons": 1000, "caustic_radius": 0.5},
     {"type": "EmissionIntegrator", "stepSize": 0.01}, 100.0),
    ({"filter_type": "lanczos"},
     {"type": "photonmapping", "photons": 5000, "cPhotons": 2000,
      "finalGather": False, "fg_samples": 4},
     {"type": "SkyIntegrator", "alpha": 0.7, "sigma_t": 0.05,
      "turbidity": 4.0, "stepSize": 2.0}, 3.0),
    ({}, {"type": "SPPM", "passNums": 3, "photonRadius": 2.0,
          "times": 1.5, "pmIRE": True, "searchNum": 16}, {"type": "none"},
     None),
    ({}, {"type": "bidirectional", "raydepth": 9, "do_LightImage": False},
     None, None),
    ({}, {"type": "DebugIntegrator", "debugType": 4, "showPN": True},
     None, None),
]


def _box(pkg):
    js = j_cornell_box(resx=RES, resy=RES, light_samples=1)
    if pkg == "core":
        return js
    return convert.scene_from_numpy(*convert.scene_to_numpy(js),
                                    device="cpu")


def _seeded_film():
    """A 16^2 film with smooth regions and edges: rgba sums and weights."""
    rng = np.random.default_rng(40)
    y, x = np.mgrid[0:RES, 0:RES].astype(np.float32)
    base = np.where(x + 0.5 * y > 11.0, 0.7, 0.2)[..., None] \
        + rng.uniform(0.0, 0.04, (RES, RES, 3))
    w = rng.uniform(1.0, 3.0, (RES, RES)).astype(np.float32)
    rgba = np.concatenate([base, np.ones((RES, RES, 1))], -1) * w[..., None]
    return rgba.astype(np.float32), w


def _j_opts(**kw):
    return jrender.RenderOptions(integrator_opts=JDirectOptions(raydepth=1),
                                 **{**PASSES, **kw})


def _t_opts(**kw):
    return RenderOptions(integrator_opts=DirectOptions(raydepth=1),
                         **{**PASSES, **kw})


def _film_arrays(prefix, film):
    return {f"{prefix}:{f}": np.asarray(getattr(film, f))
            for f in jfilm.Film._fields}


class _Interrupt(Exception):
    pass


def _interrupted(ts, ck):
    """The port's adaptive render stopped at the first chunk of its second
    pass, after the first pass's checkpoint was written to ck."""
    def stop(img, pass_idx, chunk_idx):
        if pass_idx == 1:
            raise _Interrupt

    with pytest.raises(_Interrupt):
        render_image(ts, _t_opts(), checkpoint_path=ck, on_flush=stop)


def _core_tpu_side(tmp) -> dict:
    out = {}
    rgba, w = _seeded_film()
    out["flags:seeded"] = np.asarray(jfilm.next_pass_flags(
        jfilm.Film(rgba=jnp.asarray(rgba), weight=jnp.asarray(w),
                   density=jnp.zeros((RES, RES, 3)),
                   n_density=jnp.zeros(())), THRESH))
    js = _box("core")
    saved = []
    orig_save = jck.save_checkpoint

    def record(path, film, pass_idx, offs, meta=None):
        saved.append((film, pass_idx, offs))
        return orig_save(path, film, pass_idx, offs, meta)

    with jax.disable_jit(), _port_halton():
        with mock.patch.object(jck, "save_checkpoint", record):
            img, film = jrender.render_image(
                js, _j_opts(), checkpoint_path=os.path.join(tmp, "j.npz"))
        out["render:img"] = np.asarray(img)
        out.update(_film_arrays("render", film))
        out["flags:final"] = np.asarray(jfilm.next_pass_flags(film, THRESH))
        f1, pass_idx, offs = saved[0]
        out.update(_film_arrays("pass1", f1))
        out["pass1:flags"] = np.asarray(jfilm.next_pass_flags(f1, THRESH))
        assert (pass_idx, offs) == (1, PASSES["aa_samples"])
        for norm in (True, False):
            out[f"z:{norm}"] = np.asarray(jrender.render_zbuffer(
                js, normalize=norm))
        # the port's first pass, resumed by core_tpu
        ck = os.path.join(tmp, "t.npz")
        _interrupted(_box("port"), ck)
        img, _ = jrender.render_image(js, _j_opts(), checkpoint_path=ck)
        out["resumed:img"] = np.asarray(img)
    return out


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("passes_core"))
    c, by = once_per_run(tmp_path_factory, "torch_passes_core",
                         lambda: _core_tpu_side(tmp))
    print(f"passes: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return c


@pytest.fixture(scope="module")
def port():
    """The port's uninterrupted adaptive render of the box, and the flags
    of its film after the first pass."""
    ts = _box("port")
    firsts = []
    orig = tfilm.next_pass_flags

    def record(film, thr):
        flags = orig(film, thr)
        firsts.append(flags)
        return flags

    with mock.patch.object(tfilm, "next_pass_flags", record):
        img, film = render_image(ts, _t_opts())
    return ts, img, film, firsts[0]


def _named_flips(img, want, got, thr):
    """Pixels whose flags differ, each with the brightness differences to
    its four neighbour pairs nearest to thr; fails unless every flip is a
    tie (a difference within TIE of thr)."""
    b = img[..., :3].astype(np.float64).mean(-1)
    h, w = b.shape
    named = []
    for y, x in zip(*np.nonzero(want != got)):
        near = min(abs(abs(abs(b[y, x]) - b[yy, xx]) - thr)
                   for yy, xx in ((y, x + 1), (y + 1, x), (y + 1, x + 1),
                                  (y + 1, x - 1), (y, x - 1), (y - 1, x),
                                  (y - 1, x - 1), (y - 1, x + 1))
                   if 0 <= yy < h and 0 <= xx < w)
        named.append(((int(y), int(x)), float(near)))
    print(f"flag flips (pixel, |delta - threshold|): {named}",
          file=sys.stderr)
    assert all(near < TIE for _, near in named), named
    return named


def test_next_pass_flags_match_core_tpu(core, port):
    rgba, w = _seeded_film()
    film = tfilm.Film(rgba=torch.from_numpy(rgba), weight=torch.from_numpy(w))
    got = tfilm.next_pass_flags(film, THRESH).numpy()
    want = core["flags:seeded"]
    assert 10 < want.sum() < RES * RES - 10
    _named_flips(rgba / w[..., None], want, got, THRESH)
    np.testing.assert_array_equal(got, want)
    # the box after its first pass
    _, _, _, first = port
    img1 = core["pass1:rgba"] / np.maximum(core["pass1:weight"],
                                           1e-10)[..., None]
    _named_flips(img1, core["pass1:flags"], first.numpy(), THRESH)
    np.testing.assert_array_equal(first.numpy(), core["pass1:flags"])


def test_adaptive_render_matches_core_tpu(core, port):
    ts, img, film, first = port
    np.testing.assert_allclose(img.numpy(), core["render:img"], **TOL)
    np.testing.assert_array_equal(film.weight.numpy(),
                                  core["render:weight"])
    np.testing.assert_allclose(film.rgba.numpy(), core["render:rgba"],
                               **TOL)
    # the second pass added weight only around the flagged pixels
    n1 = int(first.sum())
    assert 0 < n1 < RES * RES
    grew = film.weight.numpy() > core["pass1:weight"] + 1e-6
    assert grew.sum() >= n1 and not grew.all()
    # show_sam_pix: the final flags in red
    marked, _ = render_image(ts, _t_opts(show_sam_pix=True))
    flags = tfilm.next_pass_flags(film, THRESH)
    np.testing.assert_array_equal(flags.numpy(), core["flags:final"])
    red = torch.tensor([1.0, 0.0, 0.0, 1.0])
    assert bool((marked[flags] == red).all())
    assert torch.equal(marked[~flags], img[~flags])


def test_render_zbuffer_matches_core_tpu(core):
    ts = _box("port")
    for norm in (True, False):
        z = trender.render_zbuffer(ts, normalize=norm).numpy()
        np.testing.assert_allclose(z, core[f"z:{norm}"], rtol=1e-6,
                                   atol=1e-6)
    zn = core["z:True"]
    assert zn.min() == 0.0 and zn.max() == 1.0


def _fields(o):
    """A RenderOptions (either package's) as a flat dict of plain values."""
    out = {}
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = type(v).__name__
            out.update({f"{f.name}.{k}": w for k, w in _fields(v).items()})
        else:
            out[f.name] = int(v) if f.name == "filter_type" else v
    return out


def test_setup_render_options_matches_core_tpu():
    assert [f.name for f in dataclasses.fields(RenderOptions)] == \
        [f.name for f in dataclasses.fields(jrender.RenderOptions)]
    for rp, ip, vp, span in OPTION_CASES:
        args = [[None if p is None else pm(dict(p)) for p in (rp, ip, vp)]
                for pm in (ParamMap, JParamMap)]
        got = _fields(setup_render_options(*args[0], volume_span=span))
        want = _fields(j_setup(*args[1], volume_span=span))
        assert got == want, (ip, vp)
    with pytest.raises(ValueError, match="unknown surface integrator"):
        setup_render_options(ParamMap(), ParamMap({"type": "nope"}), None)
    # SceneBuilder.render_options takes the span from its volumes
    b = SceneBuilder("cpu")
    b.create("volumeregion", "fog", ParamMap({
        "type": "UniformVolume", "maxX": 2.0, "maxY": 4.0, "maxZ": 4.0}))
    b.create("integrator", "vol", ParamMap({
        "type": "SingleScatterIntegrator", "stepSize": 0.5}))
    assert b.render_options().volume_opts.steps == 12


def test_sphere_object_matches_core_tpu():
    geoms = []
    for builder, pmap, extra in (
            (SceneBuilder("cpu"), ParamMap,
             dict(device="cpu")), (JSceneBuilder(), JParamMap, {})):
        builder.create("material", "m", pmap({"type": "shinydiffusemat"}))
        obj = builder.create("object", "ball", pmap(dict(SPHERE)))
        assert obj == 0
        geoms.append(builder.assembler.build(**extra))
    got, want = geoms
    assert int(got.tri_vidx.shape[0]) == 12 * 6 * 2 - 2 * 12
    for f in ("verts", "tri_vidx", "corner_n", "uvs", "smooth", "tri_mat",
              "tri_obj"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    r = np.linalg.norm(got.verts.numpy() - np.asarray(SPHERE["center"]),
                       axis=1)
    np.testing.assert_allclose(r, SPHERE["radius"], rtol=1e-6)


@pytest.mark.parametrize("writer", ["core_tpu", "port"])
def test_render_checkpoint_crosses_packages(core, port, tmp_path, writer):
    ts, img, film, _ = port
    if writer == "core_tpu":
        # core_tpu's first-pass film saved by core_tpu, resumed by the port
        ck = str(tmp_path / "j.npz")
        jck.save_checkpoint(ck, jfilm.Film(
            **{f: jnp.asarray(core[f"pass1:{f}"])
               for f in jfilm.Film._fields}), 1, PASSES["aa_samples"])
        resumed, _ = render_image(ts, _t_opts(), checkpoint_path=ck)
        np.testing.assert_allclose(resumed.numpy(), core["render:img"],
                                   **TOL)
        np.testing.assert_allclose(resumed.numpy(), img.numpy(), **TOL)
        # the finished render's checkpoint reads back in core_tpu
        f2, pass_idx, offs, _ = jck.load_checkpoint(ck)
        assert (pass_idx, offs) == (2, 4)
        np.testing.assert_array_equal(np.asarray(f2.weight),
                                      tck.load_checkpoint(ck, device="cpu")
                                      [0].weight.numpy())
    else:
        # the port's first pass resumed by core_tpu (core_tpu's side), and
        # by the port itself
        np.testing.assert_allclose(core["resumed:img"], img.numpy(), **TOL)
        ck = str(tmp_path / "t.npz")
        _interrupted(ts, ck)
        f1, pass_idx, offs, meta = tck.load_checkpoint(ck, device="cpu")
        assert (pass_idx, offs, meta) == (1, 2, {})
        resumed, rfilm = render_image(ts, _t_opts(), checkpoint_path=ck)
        assert torch.equal(resumed, img)
        assert torch.equal(rfilm.rgba, film.rgba)


def test_sppm_checkpoint_crosses_packages(tmp_path):
    ts = _box("port")
    opts = RenderOptions(integrator="SPPM",
                         integrator_opts=SPPMOptions(**SPPM))
    img, _ = render_image(ts, opts)
    ck = str(tmp_path / "t.npz")
    render_image(ts, dataclasses.replace(opts, integrator_opts=SPPMOptions(
        **{**SPPM, "passes": 1})), checkpoint_path=ck)
    state, pass_idx = tck.load_sppm_checkpoint(ck, device="cpu")
    jstate, jpass = jck.load_sppm_checkpoint(ck)
    assert pass_idx == jpass == 1
    for f in jstate._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jstate, f)),
            np.stack(list(getattr(state, f)), -1)
            if f in ("tau", "direct") else getattr(state, f).numpy(), f)
    assert float(state.acc_n.max()) > 0
    # core_tpu writes that state; the port resumes from it
    ck2 = str(tmp_path / "j.npz")
    jck.save_sppm_checkpoint(ck2, jstate, jpass)
    resumed, _ = render_image(ts, opts, checkpoint_path=ck2)
    assert torch.equal(resumed, img)


def test_on_flush_and_render_chunk_mask():
    ts = _box("port")
    calls = []
    img, film = render_image(ts, _t_opts(spp_chunk=1), on_flush=lambda
                             im, p, c: calls.append((p, c, im.copy())))
    assert [(p, c) for p, c, _ in calls] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    np.testing.assert_array_equal(calls[-1][2], tfilm.flush(film).numpy())
    # render_chunk's resample_mask: unmasked pixels take no sample
    mask = torch.zeros((RES, RES), dtype=torch.bool)
    mask[4:9, 2:12] = True
    f = trender.render_chunk(ts, trender.scene_material_types(ts),
                             _t_opts(), tfilm.make_film(RES, RES,
                                                        device="cpu"),
                             0, 1, 0, resample_mask=mask)
    # the box filter of size 1.5 reaches one pixel around the mask
    near = torch.nn.functional.max_pool2d(mask[None, None].float(), 3, 1,
                                          1)[0, 0] > 0
    assert bool((f.weight[~near] == 0).all()) and bool(
        (f.weight[mask] > 0).all())
