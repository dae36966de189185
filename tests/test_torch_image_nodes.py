"""Image textures, shader nodes, ray differentials and the golden mesh scene
against core_tpu, on the same numpy inputs made from a seed.

- read_image: both refgold assets bit-equal to core_tpu's PIL-based
  read_image, and synthetic TGAs written here (32-bit bottom-left, run-length
  encoded 24- and 32-bit, right-to-left) bit-equal to PIL's decode.
- _eval_image on 256 lanes at rtol 1e-6 / atol 1e-7: every interpolation x
  clip mode, with and without a mip footprint, over a set whose first def
  is procedural and whose two images differ in size (slots 0 and 1, the
  second padded in the atlas), at uvs that straddle 0 and 1, negatives
  and large repeats.
- eval_graph on 256 lanes (rtol 1e-6 / atol 1e-7; 1e-5 / 1e-6 for the
  tube and sphere maps' atan2 and acos): texture_mapper with texco uv /
  global / normal / reflect / transformed, mapping plain / tube / sphere /
  cube, the axis swizzle, scale and offset, over a smooth image; the
  value node.
- golden_mesh_scene(16, 16) leaf by leaf through convert.scene_to_numpy:
  geometry, smoothed normals and uvs, textures and atlases, node programs,
  the background; its bglight CDFs (rasterised through the sky image) at
  rtol 1e-5 / atol 1e-6, since atan2 and acos differ by an ulp between XLA
  and torch.  On that scene, at its 256 pixel-centre camera rays (sample
  0): texture_lod at their hits and a mip-filtered checker lookup at those
  footprints (rtol 1e-5 / atol 1e-6); the slice as direct.integrate on
  those rays with their differentials (directlight raydepth=1,
  ibl_samples=1), the work of a 16x16 1-spp render_chunk but the film,
  against core_tpu's eager integrate at test_torch_mesh_scene.py's
  tolerances (>= 99% of channels within rtol 1e-4 / atol 1e-5, mean within
  1e-5); and the background on 256 directions (rtol 1e-5 / atol 1e-6).
  core_tpu's eager render_chunk of the scene costs ~15 s in a cold
  process, its integrate on these rays ~6 s once texture_lod has compiled
  the same shapes.

Everything core_tpu computes on the golden scene is computed once per run
(test_torch_diff.once_per_run: the first xdist worker saves it, the others
load it); core_tpu runs eagerly throughout.
"""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from core_tpu import scene as jscene
from core_tpu.backgrounds import eval_background as j_eval_background
from core_tpu.cameras import shoot_ray as j_shoot_ray
from core_tpu.differentials import camera_diff_dirs as j_camera_diff_dirs
from core_tpu.differentials import texture_lod as j_texture_lod
from core_tpu.integrators import direct as j_direct
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.io.image import read_image as j_read_image
from core_tpu.render import scene_material_types as j_types
from core_tpu.sampling import qmc as jqmc
from core_tpu.scenes import golden_mesh_scene as j_golden_mesh_scene
from core_tpu.textures import base as jtex
from core_tpu.textures.nodes import NodeDef as JNodeDef
from core_tpu.textures.nodes import eval_graph as j_eval_graph
from core_tpu.types import Hits as JHits
from core_tpu.types import Rays as JRays
from core_tpu_torch import convert
from core_tpu_torch import scene as tscene
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.differentials import camera_diff_dirs, texture_lod
from core_tpu_torch.integrators import direct
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.io.image import read_image
from core_tpu_torch.render import RenderOptions, scene_material_types
from core_tpu_torch.scenes import ASSET_DIR, golden_mesh_scene
from core_tpu_torch.textures import base as ttex
from core_tpu_torch.textures.nodes import NodeDef, eval_graph
from core_tpu_torch.types import Hits, Rays
from core_tpu_torch.vec import V3, rays_to_soa, v3
from test_torch_diff import once_per_run

torch.set_num_threads(1)
N = 256
EXACT = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(resx=16, resy=16, ibl_samples=1)


# ---- read_image ----

@pytest.mark.parametrize("name", ["checker.tga", "sky.tga"])
def test_read_image_assets_bit_equal(name):
    path = os.path.join(ASSET_DIR, name)
    got, want = read_image(path), j_read_image(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _rle(px: np.ndarray) -> bytes:
    """TGA run-length packets of one row of [n, bpp] pixels: runs of equal
    pixels (up to 128) and raw stretches between."""
    out, k, n = bytearray(), 0, px.shape[0]
    while k < n:
        r = 1
        while k + r < n and r < 128 and np.array_equal(px[k + r], px[k]):
            r += 1
        if r >= 2:
            out += bytes([0x80 | (r - 1)]) + px[k].tobytes()
            k += r
            continue
        e = k + 1
        while e < n and e - k < 128 and not (
                e + 1 < n and np.array_equal(px[e], px[e + 1])):
            e += 1
        out += bytes([e - k - 1]) + px[k:e].tobytes()
        k = e
    return bytes(out)


def _write_tga(path, rgb8, alpha8, rle, desc):
    """A true-colour TGA of the [h, w, 3] rgb8 (and [h, w] alpha8, None for
    24 bits) as it appears on screen, stored in the row and column order
    descriptor bits 5 (top first) and 4 (right first) say."""
    h, w, _ = rgb8.shape
    px = rgb8[..., ::-1]
    if alpha8 is not None:
        px = np.concatenate([px, alpha8[..., None]], -1)
    if not desc & 0x20:
        px = px[::-1]
    if desc & 0x10:
        px = px[:, ::-1]
    px = np.ascontiguousarray(px)
    hdr = bytearray(18)
    hdr[0] = 3                                   # an id field to skip
    hdr[2] = 10 if rle else 2
    hdr[12:14] = w.to_bytes(2, "little")
    hdr[14:16] = h.to_bytes(2, "little")
    hdr[16] = 8 * px.shape[-1]
    hdr[17] = desc | (8 if alpha8 is not None else 0)
    # packets stay within a row, as the TGA 2.0 specification asks
    body = b"".join(_rle(row) for row in px) if rle else px.tobytes()
    path.write_bytes(bytes(hdr) + b"id!" + body)


@pytest.mark.parametrize("bits,rle,desc", [(32, False, 0x00),
                                           (24, True, 0x20),
                                           (32, True, 0x10)])
def test_read_tga_matches_pil(tmp_path, bits, rle, desc):
    rng = np.random.default_rng(bits + desc)
    # few distinct colours, so the RLE file has runs
    pal = rng.integers(0, 256, (3, 3), dtype=np.uint8)
    rgb8 = pal[rng.integers(0, 3, (9, 13)) * (rng.random((9, 13)) < 0.7)]
    alpha8 = rng.integers(0, 256, (9, 13), dtype=np.uint8) \
        if bits == 32 else None
    path = tmp_path / "t.tga"
    _write_tga(path, rgb8, alpha8, rle, desc)
    got = read_image(str(path))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"), np.float32) / 255.0
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(np.round(got * 255).astype(np.uint8), rgb8)


def test_image_and_node_errors_raise(tmp_path):
    with pytest.raises(NotImplementedError, match=r"\.jpg"):
        read_image(str(tmp_path / "sky.jpg"))
    # .png, .hdr, .pic and .exr are read now: a missing file is the error
    for ext in ("png", "hdr", "pic", "exr"):
        with pytest.raises(FileNotFoundError):
            read_image(str(tmp_path / f"sky.{ext}"))
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.tga"))
    grey = tmp_path / "grey.tga"
    grey.write_bytes(bytes([0, 0, 3] + [0] * 9 + [1, 0, 1, 0, 8, 0]) + b"\0")
    with pytest.raises(NotImplementedError, match="type 3"):
        read_image(str(grey))
    with pytest.raises(FileNotFoundError):
        golden_mesh_scene(8, 8, asset_dir=str(tmp_path), device="cpu")
    cyc = [NodeDef("a", "value", (("input", "b"),)),
           NodeDef("b", "value", (("input", "a"),))]
    one = torch.ones(4)
    ctx = {"p": V3(one, one, one), "uv": (one, one), "n": V3(one, one, one),
           "texture_names": {}}
    with pytest.raises(ValueError, match="cycle"):
        eval_graph(cyc, "a", ctx, None)
    with pytest.raises(ValueError, match="no texture named 'nope'"):
        eval_graph([NodeDef("m", "texture_mapper", (("texture", "nope"),))],
                   "m", ctx, None)


# ---- the image texture and the nodes on a small texture set ----

def _texture_sets():
    """(core_tpu's set, the port's) of a marble def and three images: 24 x
    40 RGB noise, 13 x 20 RGBA noise under gamma 2.2 with repeats 2 x 3
    (padded in the atlas; odd sides on the way down the mips), and a smooth
    16 x 24 RGB one, whose neighbouring texels differ little, for the
    mappers."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:16, 0:24] / 8.0
    smooth = np.stack([0.5 + 0.4 * np.sin(x), 0.5 + 0.4 * np.cos(y),
                       0.5 + 0.2 * np.sin(x + y)], -1)
    imgs = [rng.uniform(0, 1, (24, 40, 3)).astype(np.float32),
            rng.uniform(0, 1, (13, 20, 4)).astype(np.float32),
            smooth.astype(np.float32)]
    kws = [dict(ttype="MARBLE", color1=(0.2, 0.3, 0.4), size=1.7),
           dict(ttype="IMAGE", image=imgs[0]),
           dict(ttype="IMAGE", image=imgs[1], gamma=2.2, xrepeat=2,
                yrepeat=3),
           dict(ttype="IMAGE", image=imgs[2])]

    def defs(mod):
        return [mod.TextureDef(**{**k, "ttype": mod.TexType[k["ttype"]],
                                  "name": f"t{i}"})
                for i, k in enumerate(kws)]

    return jtex.build_texture_set(defs(jtex)), \
        ttex.build_texture_set(defs(ttex), "cpu")


@pytest.fixture(scope="module")
def texsets():
    return _texture_sets()


def _uv(seed, n=N):
    """uvs over [-3, 4) with exact 0s, 1s, -0.5s and large repeats."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-3.0, 4.0, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [-0.5, 0.5], [0.999999, 0],
              [37.25, -12.5], [-0.0, 1e-7]]
    return uv


def test_texture_sets_match(texsets):
    jc, tc = texsets
    assert tc.slots == (-1, 0, 1, 2)
    np.testing.assert_array_equal(tc.atlas.numpy(), np.asarray(jc.tset.atlas))
    assert len(tc.mips) == len(jc.tset.mips) == 4
    for lvl, (jm, jhw) in enumerate(zip(jc.tset.mips, jc.tset.mips_hw), 1):
        np.testing.assert_array_equal(tc.mips[lvl - 1].numpy(),
                                      np.asarray(jm))
        assert [list(x) for x in tc.hw[lvl]] == np.asarray(jhw).tolist()


@pytest.mark.parametrize("lod", [False, True], ids=["point", "mip"])
@pytest.mark.parametrize("clip", ["repeat", "checker", "extend", "clip"])
@pytest.mark.parametrize("interp", ["none", "bilinear", "bicubic"])
def test_eval_image_matches(texsets, interp, clip, lod):
    jc, tc = texsets
    uv = _uv(["none", "bilinear", "bicubic"].index(interp) * 4
             + ["repeat", "checker", "extend", "clip"].index(clip))
    rng = np.random.default_rng(5)
    fp = (2.0 ** rng.uniform(-13.0, 1.0, N)).astype(np.float32) \
        if lod else None
    for i in (1, 2):
        jd, td = jc.defs[i], tc.defs[i]
        jd.interpolate = td.interpolate = interp
        jd.clip_mode = td.clip_mode = clip
        want = np.asarray(jtex._eval_image(
            jd, jc.tset, jnp.asarray(uv),
            None if fp is None else jnp.asarray(fp)))
        got = ttex._eval_image(td, tc, tc.slots[i], (
            torch.from_numpy(uv[:, 0]), torch.from_numpy(uv[:, 1])),
            None if fp is None else torch.from_numpy(fp))
        np.testing.assert_allclose(got.numpy(), want, **EXACT)
        if clip == "clip":
            assert (want[:, 3] == 0).any() and (want[:, 3] > 0).any()


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


MAPPERS = {
    "uv": dict(texco="uv"),
    "global": dict(texco="global", scale=(0.5, 0.25, 1.0),
                   offset=(0.1, -0.2, 0.0)),
    "normal_swizzle": dict(texco="normal", proj_x=2, proj_y=3, proj_z=0),
    "reflect": dict(texco="reflect"),
    "transformed": dict(texco="transformed", transform=[
        0.8, -0.6, 0.0, 0.3, 0.6, 0.8, 0.0, -0.1, 0.0, 0.0, 1.0, 0.0,
        0.0, 0.0, 0.0, 1.0]),
    "tube": dict(texco="global", mapping="tube"),
    "sphere": dict(texco="global", mapping="sphere"),
    "cube": dict(texco="global", mapping="cube", texture="t2"),
}


@pytest.mark.parametrize("case", list(MAPPERS) + ["value"])
def test_eval_graph_matches(texsets, case):
    jc, tc = texsets
    for d in jc.defs[1:] + tc.defs[1:]:
        d.interpolate, d.clip_mode = "bilinear", "repeat"
    rng = np.random.default_rng(sorted(MAPPERS).index(case)
                                if case in MAPPERS else 99)
    p = rng.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    p[:4] = [[0, 0, 1], [0, 0, -1], [0, 1e-3, 0.5], [-1e-3, 0, 0]]  # poles
    n = _unit(rng.normal(size=(N, 3)))
    wo = _unit(rng.normal(size=(N, 3)))
    uv = _uv(3)
    if case == "value":
        params = {"color": (0.25, 0.5, 0.75), "alpha": 0.6, "scalar": 0.3}
        ntype = "value"
    else:
        params = {"texture": "t3", **MAPPERS[case]}
        ntype = "texture_mapper"
    frozen = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                          for k, v in params.items()))
    names = {"t0": 0, "t1": 1, "t2": 2, "t3": 3}
    rgba, sval = j_eval_graph(
        [JNodeDef("m", ntype, frozen)], "m",
        {"p": jnp.asarray(p), "uv": jnp.asarray(uv), "n": jnp.asarray(n),
         "wo": jnp.asarray(wo), "texture_names": names}, jc)
    tp, tn = v3(torch.from_numpy(p)), v3(torch.from_numpy(n))
    rgb, alpha, tval = eval_graph(
        [NodeDef("m", ntype, frozen)], "m",
        {"p": tp, "uv": (torch.from_numpy(uv[:, 0]),
                         torch.from_numpy(uv[:, 1])), "n": tn,
         "wo": v3(torch.from_numpy(wo)), "texture_names": names}, tc)
    got = torch.stack([rgb.x, rgb.y, rgb.z, alpha], -1).numpy()
    # the tube and sphere maps' atan2 and acos differ by ulps between XLA
    # and torch (XLA's acos is 2 atan2(sqrt(1 - x^2), 1 + x))
    tol = TOL if case in ("tube", "sphere") else EXACT
    np.testing.assert_allclose(got, np.asarray(rgba), **tol)
    np.testing.assert_allclose(tval.numpy(), np.asarray(sval), **tol)
    assert np.asarray(rgba)[:, :3].std() > 0 or case == "value"


# ---- the golden mesh scene ----

def _jsonable(static) -> str:
    return json.dumps(static, sort_keys=True)


def _pixel_centres(res=SMALL["resx"]):
    """(px, py, pixel_sample, sampling_offs) of a res x res 1-spp chunk's
    camera rays, as render_chunk makes them (aa_samples=1: the pixel
    centres, sample 0), as numpy."""
    y, x = (a.ravel().astype(np.uint64) for a in np.mgrid[0:res, 0:res])
    offs = jqmc.fnv32a(jnp.asarray(y.astype(np.uint32)) * jqmc.fnv32a(
        jnp.asarray(x.astype(np.uint32))))
    return (x.astype(np.float32) + 0.5, y.astype(np.float32) + 0.5,
            np.zeros(x.shape, np.int32), np.asarray(offs))


def _camera_hits(ts):
    """The port's camera rays at the pixel centres, their neighbour
    directions and closest hits (the plain version), as numpy; both
    packages' texture_lod take these same hits."""
    px, py = (torch.from_numpy(a) for a in _pixel_centres()[:2])
    rays, _ = shoot_ray(ts.camera, px, py)
    dxd, dyd = camera_diff_dirs(ts.camera, px, py)
    hits = tscene.closest_hit_s(ts, rays_to_soa(rays))
    return {"o": rays.o.numpy(), "d": rays.d.numpy(),
            "dxd": torch.stack(list(dxd), -1).numpy(),
            "dyd": torch.stack(list(dyd), -1).numpy(),
            **{f"hit_{f}": getattr(hits, f).numpy()
               for f in ("t", "prim", "u", "v")}}


def _dirs(seed=8, n=N):
    return _unit(np.random.default_rng(seed).normal(size=(n, 3)))


def _core_tpu_side(ts) -> dict:
    """Everything core_tpu computes on golden_mesh_scene(16, 16), as numpy:
    its leaves and static settings, texture_lod and the footprint-filtered
    checker at the port's camera hits, its eager directlight integrate on
    the pixel-centre camera rays, and the background on seeded
    directions."""
    js = j_golden_mesh_scene(**SMALL)
    leaves, static = convert.scene_to_numpy(js)
    out = {f"leaf:{k}": v for k, v in leaves.items()}
    out["static"] = np.array(_jsonable(static))
    ins = _camera_hits(ts)
    rays = JRays(jnp.asarray(ins["o"]), jnp.asarray(ins["d"]),
                 jnp.zeros(N, jnp.float32), jnp.full(N, -1.0, jnp.float32))
    hits = JHits(*[jnp.asarray(ins[f"hit_{f}"])
                   for f in ("t", "prim", "u", "v")])
    sp = jscene.surface_points(js, rays, hits)
    lod = j_texture_lod(js, sp, rays, jnp.asarray(ins["dxd"]),
                        jnp.asarray(ins["dyd"]))
    out["lod"] = np.asarray(lod)
    out["lod_rgba"] = np.asarray(jtex.eval_texture(
        js.textures, jnp.zeros(N, jnp.int32), sp.p, sp.uv, lod=lod))
    px, py, ps, offs = (jnp.asarray(a) for a in _pixel_centres())
    cam, _ = j_shoot_ray(js.camera, px, py)
    out["integrate"] = np.asarray(j_direct.integrate(
        js, j_types(js), cam, ps, offs, JDirectOptions(raydepth=1),
        diff=j_camera_diff_dirs(js.camera, px, py)))
    out["background"] = np.asarray(j_eval_background(
        js.background, jnp.asarray(_dirs())))
    return out


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """(core_tpu's numpy results, once per run; the port's scene)."""
    ts = golden_mesh_scene(**SMALL, device="cpu")
    core, by = once_per_run(tmp_path_factory, "torch_image_nodes_core",
                            lambda: _core_tpu_side(ts))
    print(f"golden: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return core, ts


def test_golden_mesh_scene_equals_core_tpu_leaf_by_leaf(golden):
    core, ts = golden
    tl, tst = convert.scene_to_numpy(ts)
    jl = {k[5:]: v for k, v in core.items() if k.startswith("leaf:")}
    assert jl.keys() == tl.keys()
    cdfs = {k for k in jl if k.startswith("lights.0.")}
    assert cdfs == {f"lights.0.{f}" for f in ("u_pdf", "u_cdf", "v_pdf",
                                              "v_cdf")}
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        if k in cdfs:
            np.testing.assert_allclose(tl[k], jl[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert _jsonable(tst) == str(core["static"])
    assert ts.geom.n_tris == 2306 and ts.accel is None
    assert [p[1] for p in tst["node_programs"]] == ["diffuse_shader"] * 2
    assert tl["textures.0.image"].shape == (256, 256, 3)
    assert tl["background.textures.0.image"].shape == (128, 256, 3)
    # the CDFs follow the sky: the brightest rows are not the darkest
    assert jl["lights.0.v_pdf"].std() > 0.05


def test_texture_lod_matches_core_tpu(golden):
    core, ts = golden
    ins = _camera_hits(ts)
    rays = rays_to_soa(Rays(torch.from_numpy(ins["o"]),
                            torch.from_numpy(ins["d"]), torch.zeros(N),
                            torch.full((N,), -1.0)))
    hits = Hits(*[torch.from_numpy(ins[f"hit_{f}"])
                  for f in ("t", "prim", "u", "v")])
    sp = tscene.surface_points_s(ts, rays, hits)
    lod = texture_lod(ts, sp, rays, v3(torch.from_numpy(ins["dxd"])),
                      v3(torch.from_numpy(ins["dyd"])))
    valid = ins["hit_prim"] >= 0
    assert valid.mean() > 0.5
    np.testing.assert_allclose(lod.numpy()[valid], core["lod"][valid], **TOL)
    assert (lod.numpy()[valid] > 0).all()
    rgb, alpha = ttex.eval_texture(ts.textures,
                                   torch.zeros(N, dtype=torch.int32), sp.p,
                                   (sp.u, sp.v), lod)
    got = torch.stack([rgb.x, rgb.y, rgb.z, alpha], -1).numpy()
    np.testing.assert_allclose(got[valid], core["lod_rgba"][valid], **TOL)


def test_background_and_bg_light_match_core_tpu(golden):
    core, ts = golden
    rad = eval_background_s(ts.background, v3(torch.from_numpy(_dirs())))
    got = torch.stack(list(rad), -1).numpy()
    np.testing.assert_allclose(got, core["background"], **TOL)
    assert got.std() > 0.01                      # the sky varies
    # the IBL light evaluates the same background (its CDFs are held in
    # the leaf-by-leaf test)
    assert ts.lights[-1].background is ts.background


def test_directlight_integrate_matches_core_tpu(golden):
    core, ts = golden
    px, py, ps, offs = (torch.from_numpy(a.astype(np.int64)
                                         if a.dtype != np.float32 else a)
                        for a in _pixel_centres())
    rays, _ = shoot_ray(ts.camera, px, py)
    with torch.no_grad():
        got = direct.integrate(ts, scene_material_types(ts), rays, ps, offs,
                               DirectOptions(raydepth=1),
                               diff=camera_diff_dirs(ts.camera, px, py))
    got, want = got.numpy(), core["integrate"]
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close[:, :3].mean() >= 0.99, close[:, :3].mean()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    jm, tm = want[:, :3].mean(), got[:, :3].mean()
    assert abs(tm - jm) <= 1e-5 * abs(jm), (tm, jm)
    assert want[:, :3].std() > 0.01


def test_golden_dl_gradient_reaches_mapped_materials(golden):
    """A directlight fwd+bwd of the 16x16 golden scene: finite gradients,
    and the diffuse_reflect leaf (strengths column 3) of both node-mapped
    materials nonzero."""
    from core_tpu_torch import diff
    _, ts = golden
    # four IBL samples: with one, some torus pixels happen to be dark
    sc = dataclasses.replace(
        ts, lights=(dataclasses.replace(ts.lights[0], samples=4),))
    opts = RenderOptions(aa_samples=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))
    loss, grads = diff.value_and_grad_fn(sc, opts, 1, torch.zeros(16, 16, 4))(
        diff.extract_params(sc, geometry=False))
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert (grads["mat.strengths"][:, 3].abs() > 0).all()
