"""The procedural textures, the mix and layer nodes, the anisotropic and
coated glossy material and the PNG / HDR / EXR readers of the port against
core_tpu, on the same numpy inputs made from a seed.

core_tpu runs eagerly (jax.disable_jit), so XLA contracts no multiply-adds
into FMAs that could decide a floor or a tie differently; everything it
computes here is computed once per run (test_torch_diff.once_per_run) and
the parametrised cases read slices of it.  256 lanes throughout.

- Every noise generator (newperlin, stdperlin, blender, cellnoise,
  voronoi_f1..f4, f2f1, crackle) and every voronoi distance metric (the
  four feature distances), every texture type, wood shape (sin, saw, tri;
  bands and rings), blend stype, voronoi colour mode and musgrave kind
  (with fractional and whole octaves over several generators):
  rtol 1e-6 / atol 1e-7, except where noted by TOL_ULP below.
- eval_graph of a mix node in each of the ten modes (mode 5, "divide",
  mixes by lerp in core_tpu and here), of mix nodes named by their mode
  and fed constants, and of layer nodes over nine flag sets: colour,
  alpha and scalar at rtol 1e-6 / atol 1e-7.
- scene.apply_bump_s against core_tpu's apply_bump on 256 random frames,
  half of them of the program's material, with a musgrave fBm bump
  (smooth where its ramp does not clip): n, nu and nv at rtol 1e-5 /
  atol 1e-6.
- Glossy eval, pdf and sample (every field) on isotropic, anisotropic,
  coated and coated-anisotropic rows, and get_specular_s on every row:
  rtol 1e-5 / atol 1e-6 on the anisotropic rows (their tan, atan and pow
  differ by ulps); on the Blinn rows rtol 2.5e-7 x the exponent (1.25e-5
  at 50, 2e-5 at 80): the lobe raises the half vector's cosine to that
  power, so each ulp of the cosine (~6e-8, a few from the sampled
  direction's sin, cos and pow) becomes that many ulps of the value, as
  test_torch_mesh_scene.py notes for its glossy torus.
- PNG files (RGB, RGBA and a 2-D grey image, written by core_tpu's
  write_png; and files written here with every scanline filter in colour
  types grey, grey + alpha, RGB and RGBA), HDR files (core_tpu's flat
  write_hdr, and run-length scanlines written here, as .hdr and .pic) and
  EXR files (core_tpu's write_exr with and without alpha), read bit-equal
  by both packages.

TOL_ULP (rtol 1e-5 / atol 1e-6) where the two packages' transcendentals
differ by an ulp: pow (the Minkowski metric, the musgrave octave weights
are plain floats so they do not), and torch's CPU sqrt, which is not
correctly rounded (XLA's is): the wood rings multiply the radius by 20
before their wave, so an ulp of it moves the colour by up to ~4e-6 at
|p| ~ 2; those cases use rtol 1e-5 / atol 1e-5 (TOL_RINGS).
"""
import os
import struct
import sys
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import scene as jscene
from core_tpu.io import image as jimage
from core_tpu.materials import glossy as jglossy
from core_tpu.materials.base import MaterialDef as JMaterialDef
from core_tpu.materials.base import MatType as JMatType
from core_tpu.materials.base import build_material_table as j_build_table
from core_tpu.materials.base import gather_params as j_gather_params
from core_tpu.textures import base as jtex
from core_tpu.textures import noise as jnoise
from core_tpu.textures.nodes import NodeDef as JNodeDef
from core_tpu.textures.nodes import eval_graph as j_eval_graph
from core_tpu.types import SurfacePoints as JSurfacePoints
from core_tpu_torch import scene as tscene
from core_tpu_torch import vec as tvec
from core_tpu_torch.io.image import read_image
from core_tpu_torch.materials import glossy as tglossy
from core_tpu_torch.materials.base import MaterialDef, MatType
from core_tpu_torch.materials.base import build_material_table, \
    gather_params_s
from core_tpu_torch.textures import base as ttex
from core_tpu_torch.textures import noise as tnoise
from core_tpu_torch.textures.nodes import NodeDef, eval_graph
from test_torch_diff import once_per_run

torch.set_num_threads(1)
N = 256
EXACT = dict(rtol=1e-6, atol=1e-7)
TOL_ULP = dict(rtol=1e-5, atol=1e-6)
TOL_RINGS = dict(rtol=1e-5, atol=1e-5)

GENERATORS = ("newperlin", "stdperlin", "blender", "cellnoise", "voronoi_f1",
              "voronoi_f2", "voronoi_f3", "voronoi_f4", "voronoi_f2f1",
              "voronoi_crackle")
METRICS = {"real": 0, "squared": 1, "manhattan": 2, "chebychev": 3,
           "minkovsky_half": 4, "minkovsky_four": 5, "minkovsky": 6}

# name -> TextureDef settings (ttype and mus_type by name), both packages
TEXTURES = {
    "clouds": dict(ttype="CLOUDS", color1=(0.2, 0.3, 0.4), depth=3,
                   hard=True, bias=1, size=1.3),
    "marble": dict(ttype="MARBLE", color1=(0.1, 0.2, 0.3), shape="tri",
                   sharpness=2.0, turb=3.0, depth=2, size=2.0),
    "wood_bands_sin": dict(ttype="WOOD", shape="sin", turb=2.0, depth=2,
                           size=4.0, noise_type="blender"),
    "wood_rings_saw": dict(ttype="WOOD", shape="saw", rings=True, turb=2.0,
                           depth=2, size=4.0, noise_type="blender"),
    "wood_bands_tri": dict(ttype="WOOD", shape="tri", turb=0.0),
    "wood_rings_sin": dict(ttype="WOOD", shape="sin", rings=True, turb=1.0,
                           hard=True, noise_type="cellnoise"),
    "voronoi_f2f1": dict(ttype="VORONOI", vor_type=4, vor_iscale=1.6,
                         size=1.4, color1=(0.05, 0.12, 0.3)),
    "voronoi_weighted": dict(ttype="VORONOI", vor_type=6, vor_metric=2,
                             vor_weights=(1.0, -0.5, 0.25, 0.1), size=2.0),
    "voronoi_color1": dict(ttype="VORONOI", vor_color_mode=1, size=2.5),
    "voronoi_color2": dict(ttype="VORONOI", vor_color_mode=2, vor_metric=6,
                           vor_mk_exp=1.5, vor_weights=(1, 0.5, 0.25, 0),
                           size=3.0),
    "voronoi_color3": dict(ttype="VORONOI", vor_color_mode=3, vor_metric=3,
                           vor_weights=(0.3, 0.3, 0.3, 0.3), vor_iscale=2.0),
    "musgrave_fbm": dict(ttype="MUSGRAVE", mus_type="FBM", mus_octaves=3.5,
                         mus_h=0.7, size=1.5),
    "musgrave_fbm_whole": dict(ttype="MUSGRAVE", mus_type="FBM",
                               mus_octaves=2.0, noise_type="cellnoise"),
    "musgrave_multifractal": dict(ttype="MUSGRAVE", mus_type="MULTIFRACTAL",
                                  mus_octaves=2.25, noise_type="stdperlin",
                                  mus_lacunarity=2.5),
    "musgrave_hetero": dict(ttype="MUSGRAVE", mus_type="HETERO_TERRAIN",
                            mus_octaves=3.5, mus_offset=0.8,
                            noise_type="cellnoise", size=2.0),
    "musgrave_hybrid": dict(ttype="MUSGRAVE", mus_type="HYBRID_MF",
                            mus_octaves=4.75, mus_offset=0.9, mus_gain=1.5,
                            noise_type="blender", mus_iscale=0.8),
    "musgrave_ridged": dict(ttype="MUSGRAVE", mus_type="RIDGED_MF",
                            mus_octaves=4.0, mus_offset=1.0, mus_gain=2.0,
                            size=1.5),
    "distorted": dict(ttype="DISTORTED", distort=2.0,
                      noise_type="voronoi_crackle", noise_type2="stdperlin",
                      size=1.2),
    "rgb_cube": dict(ttype="RGB_CUBE"),
    **{f"blend_{b}": dict(ttype="BLEND", blend_type=b)
       for b in ("quad", "ease", "sphere", "halo")},
    # two coloured ramps: cheap node inputs whose colour and alpha vary
    "blend_lin": dict(ttype="BLEND", blend_type="lin",
                      color1=(0.9, 0.2, 0.1), color2=(0.1, 0.4, 0.8)),
    "blend_diag": dict(ttype="BLEND", blend_type="diag",
                       color1=(0.2, 0.7, 0.3), color2=(1.0, 0.9, 0.2)),
}
# the wood rings and the Minkowski pow (see the module docstring)
TEX_TOL = {"wood_rings_saw": TOL_RINGS, "wood_rings_sin": TOL_RINGS,
           "voronoi_color2": TOL_ULP}


def _defs(mod):
    return [mod.TextureDef(**{**k, "ttype": mod.TexType[k["ttype"]],
                              "mus_type": mod.MusgraveType[
                                  k.get("mus_type", "FBM")],
                              "name": name})
            for name, k in TEXTURES.items()]


def _points(seed, lo=-1.25, hi=1.25):
    """[N, 3] points over a box that straddles the blend textures' unit
    ranges, with four on cell corners (integer coordinates)."""
    p = np.random.default_rng(seed).uniform(lo, hi, (N, 3)) \
        .astype(np.float32)
    p[:4] = [[0, 0, 0], [1, -1, 1], [-1, 0, 1], [0.5, 0.5, -0.5]]
    return p


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _graph_inputs():
    rng = np.random.default_rng(21)
    return dict(p=_points(22), n=_unit(rng.normal(size=(N, 3))),
                wo=_unit(rng.normal(size=(N, 3))),
                uv=rng.uniform(0, 1, (N, 2)).astype(np.float32))


def _mapper(name, tex, **kw):
    return (name, "texture_mapper", {"texture": tex, **kw})


# node graphs: name -> (nodes as (name, type, params), output node)
_MIX_INPUTS = [_mapper("a", "rgb_cube", scale=(0.8, 0.6, 0.7)),
               _mapper("b", "blend_diag"),
               _mapper("f", "blend_ease", texco="uv")]
GRAPHS = {
    **{f"mix_mode{m}": (_MIX_INPUTS + [("out", "mix", {
        "input1": "a", "input2": "b", "factor": "f", "mode": m})], "out")
       for m in range(10)},
    "mix_screen_type": ([_mapper("a", "musgrave_ridged"), ("out", "screen", {
        "input1": "a", "color2": (0.9, 0.2, 0.4), "value2": 0.7,
        "value": 0.35})], "out"),
    "mix_constants": ([("out", "mix", {
        "mode": 9, "color1": (0.2, 0.6, 0.9), "value1": 0.3,
        "color2": (0.7, 0.1, 0.5), "value2": 0.8, "cfactor": 0.25})], "out"),
}
# layer flag sets: (mode, flags); the upper layer is a mapper whose alpha
# varies, except in the last set, where it is a constant
LAYERS = [
    dict(mode=0),
    dict(mode=1, use_alpha=True, colfac=0.5),
    dict(mode=2, colfac=0.7),
    dict(mode=3, negative=True, do_scalar=True),
    dict(mode=4, stencil=True, use_alpha=True, do_scalar=True),
    dict(mode=5, noRGB=True, do_scalar=True, valfac=0.6),
    dict(mode=6, color_input=False, stencil=True, do_scalar=True),
    dict(mode=8, stencil=True, noRGB=True, negative=True, do_scalar=True,
         def_val=0.4),
    dict(mode=7, do_color=False, do_scalar=True, upper_color=(0.3, 0.5, 0.7),
         upper_value=0.45),
]
for _i, _flags in enumerate(LAYERS):
    _up = {} if "upper_color" in _flags else {"upper_layer": "u"}
    GRAPHS[f"layer{_i}_mode{_flags['mode']}"] = (
        [_mapper("i", "blend_lin", scale=(2, 2, 2), texco="uv"),
         _mapper("u", "blend_diag")] + [("out", "layer", {
             "input": "i", **_up, **_flags})], "out")


# a bump program: a mapper over a smooth texture, with a scale whose norm
# divides the strength
BUMP = [_mapper("bump", "musgrave_fbm", scale=(2.0, 1.0, 2.0),
                bump_strength=3.0)]


def _frozen(params):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in params.items()))


def _nodes(cls, graph):
    return [cls(name, ntype, _frozen(params)) for name, ntype, params
            in graph]


TEX_NAMES = {name: i for i, name in enumerate(TEXTURES)}

# glossy rows: plain / coated x isotropic / anisotropic
GLOSSY = {
    "iso": dict(mtype="GLOSSY", exp_u=50.0, exp_v=50.0),
    "aniso": dict(mtype="GLOSSY", exp_u=200.0, exp_v=20.0),
    "coated": dict(mtype="COATED_GLOSSY", exp_u=80.0, exp_v=80.0, ior=1.5),
    "coated_aniso": dict(mtype="COATED_GLOSSY", exp_u=20.0, exp_v=200.0,
                         ior=1.6),
}


def _glossy_defs(material_def, mat_type):
    return [material_def(**{
        **k, "mtype": mat_type[k["mtype"]], "glossy_reflect": 0.6,
        "diffuse_strength": 0.5, "as_diffuse": False,
        "diffuse_color": (0.4, 0.5, 0.6), "glossy_color": (0.9, 0.8, 0.7),
        "mirror_color": (1.0, 0.9, 0.6)}) for k in GLOSSY.values()]


def _surface(seed=31):
    """Unit normals, a tilted geometric normal, a frame, wo and wi near the
    normal (so the lobes are not all 0), and the two samples."""
    rng = np.random.default_rng(seed)
    n = _unit(rng.normal(size=(N, 3)))
    ng = _unit(n + 0.2 * rng.normal(size=n.shape))
    nu = _unit(np.cross(n, rng.normal(size=n.shape)))
    nv = np.cross(n, nu).astype(np.float32)
    wo = _unit(n + 0.6 * rng.normal(size=n.shape))
    wi = _unit(2.0 * np.sum(n * wo, -1, keepdims=True) * n - wo
               + 0.15 * rng.normal(size=n.shape))
    s1, s2 = rng.uniform(size=(2, N)).astype(np.float32)
    return dict(n=n, ng=ng, nu=nu, nv=nv, wo=wo, wi=wi, s1=s1, s2=s2)


def _jsp(s):
    ids = jnp.zeros(N, jnp.int32)
    return JSurfacePoints(p=jnp.zeros((N, 3)), n=jnp.asarray(s["n"]),
                          ng=jnp.asarray(s["ng"]), nu=jnp.asarray(s["nu"]),
                          nv=jnp.asarray(s["nv"]), uv=jnp.zeros((N, 2)),
                          mat=ids, light=ids, prim=ids, obj=ids)


def _bump_inputs():
    """Points, a frame per point (n, nu, nv), uvs and material ids (half of
    the lanes of material 0, the program's)."""
    s = _surface(51)
    return dict(p=_points(52), n=s["n"], ng=s["ng"], nu=s["nu"], nv=s["nv"],
                uv=np.random.default_rng(53).uniform(0, 1, (N, 2))
                .astype(np.float32), mat=(np.arange(N) % 2).astype(np.int32))


def _bump_scene(node_def, ctex):
    """What apply_bump reads of a scene: its node programs, texture names
    and texture set."""
    return SimpleNamespace(
        node_programs=((0, "bump_shader", tuple(_nodes(node_def, BUMP)),
                        "bump"),),
        texture_name_map=tuple(TEX_NAMES.items()), textures=ctex)


def _core_tpu_side() -> dict:
    """Everything core_tpu computes for this file, eagerly, as numpy."""
    out = {}
    with jax.disable_jit():
        p = jnp.asarray(_points(1, -3.0, 3.0))
        for g in GENERATORS:
            out[f"gen:{g}"] = np.asarray(jnoise.generator(g)(p))
        for name, m in METRICS.items():
            out[f"metric:{name}"] = np.asarray(
                jnoise.voronoi_features(p, m, 1.5)[0])
        ctex = jtex.build_texture_set(_defs(jtex))
        pt = jnp.asarray(_points(2))
        for i, name in enumerate(TEXTURES):
            out[f"tex:{name}"] = np.asarray(jtex.eval_texture_def(
                ctex, i, pt, jnp.zeros((N, 2))))
        g = _graph_inputs()
        ctx = {"p": jnp.asarray(g["p"]), "uv": jnp.asarray(g["uv"]),
               "n": jnp.asarray(g["n"]), "wo": jnp.asarray(g["wo"]),
               "texture_names": TEX_NAMES}
        for name, (graph, outn) in GRAPHS.items():
            rgba, sval = j_eval_graph(_nodes(JNodeDef, graph), outn, ctx, ctex)
            out[f"graph:{name}"] = np.concatenate(
                [np.asarray(rgba), np.asarray(sval)[:, None]], -1)
        b = _bump_inputs()
        ids = jnp.asarray(b["mat"])
        bumped = jscene.apply_bump(_bump_scene(JNodeDef, ctex), JSurfacePoints(
            p=jnp.asarray(b["p"]), n=jnp.asarray(b["n"]),
            ng=jnp.asarray(b["ng"]), nu=jnp.asarray(b["nu"]),
            nv=jnp.asarray(b["nv"]), uv=jnp.asarray(b["uv"]), mat=ids,
            light=ids, prim=ids, obj=ids))
        for f in ("n", "nu", "nv"):
            out[f"bump:{f}"] = np.asarray(getattr(bumped, f))
        table = j_build_table(_glossy_defs(JMaterialDef, JMatType))
        s = _surface()
        sp = _jsp(s)
        wo, wi = jnp.asarray(s["wo"]), jnp.asarray(s["wi"])
        for row, name in enumerate(GLOSSY):
            jp = j_gather_params(table, jnp.full(N, row, jnp.int32))
            out[f"glossy:{name}:eval"] = np.asarray(
                jglossy.eval_bsdf(jp, sp, wo, wi))
            out[f"glossy:{name}:pdf"] = np.asarray(
                jglossy.pdf_bsdf(jp, sp, wo, wi))
            r = jglossy.sample_bsdf(jp, sp, wo, jnp.asarray(s["s1"]),
                                    jnp.asarray(s["s2"]))
            for f in r._fields:
                out[f"glossy:{name}:sample:{f}"] = np.asarray(getattr(r, f))
            spec = jglossy.get_specular(jp, sp, wo)
            for f in spec._fields:
                out[f"glossy:{name}:spec:{f}"] = np.asarray(getattr(spec, f))
    return out


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    out, by = once_per_run(tmp_path_factory, "torch_procedural_core",
                           _core_tpu_side)
    print(f"procedural: core_tpu's side computed by {by}, read by "
          f"{os.environ.get('PYTEST_XDIST_WORKER', 'master')}",
          file=sys.stderr)
    return out


@pytest.fixture(scope="module")
def ctex():
    return ttex.build_texture_set(_defs(ttex), "cpu")


def _t3(a) -> tvec.V3:
    return tvec.v3(torch.from_numpy(np.ascontiguousarray(a)))


def _np3(v: tvec.V3) -> np.ndarray:
    return np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], -1)


# ---- noise and textures ----

@pytest.mark.parametrize("gen", GENERATORS)
def test_noise_generator_matches(core, gen):
    got = tnoise.generator(gen)(_t3(_points(1, -3.0, 3.0))).numpy()
    want = core[f"gen:{gen}"]
    np.testing.assert_allclose(got, want, **EXACT)
    assert want.std() > 0.05


@pytest.mark.parametrize("metric", list(METRICS))
def test_voronoi_metric_matches(core, metric):
    got = tnoise.voronoi_features(_t3(_points(1, -3.0, 3.0)),
                                  METRICS[metric], 1.5).numpy()
    want = core[f"metric:{metric}"]
    np.testing.assert_allclose(got, want, **(
        TOL_ULP if metric == "minkovsky" else EXACT))
    assert (np.diff(want, axis=-1) >= 0).all()


@pytest.mark.parametrize("name", list(TEXTURES))
def test_texture_matches(core, ctex, name):
    i = list(TEXTURES).index(name)
    zero = torch.zeros(N)
    rgb, alpha = ttex.eval_texture_def(ctex, i, _t3(_points(2)), (zero, zero))
    got = np.concatenate([_np3(rgb), alpha.numpy()[:, None]], -1)
    want = core[f"tex:{name}"]
    np.testing.assert_allclose(got, want, **TEX_TOL.get(name, EXACT))
    assert want[:, :3].std() > 0.01, want[:, :3].std()


def test_eval_texture_selects_per_lane(ctex):
    """eval_texture over the static ids a lane can hold: each lane gets its
    def's value, -1 lanes white, ids outside `ids` white too."""
    p = _t3(_points(3))
    zero = torch.zeros(N)
    tex_id = torch.from_numpy(np.random.default_rng(4).integers(
        -1, 3, N).astype(np.int32))
    rgb, alpha = ttex.eval_texture(ctex, tex_id, p, (zero, zero), ids=(0, 2))
    for i in (0, 2):
        c, a = ttex.eval_texture_def(ctex, i, p, (zero, zero))
        m = (tex_id == i).numpy()
        np.testing.assert_array_equal(_np3(rgb)[m], _np3(c)[m])
        np.testing.assert_array_equal(alpha.numpy()[m], a.numpy()[m])
    white = ((tex_id == -1) | (tex_id == 1)).numpy()
    assert (_np3(rgb)[white] == 1.0).all()
    assert (alpha.numpy()[white] == 1.0).all()


# ---- shader nodes ----

@pytest.mark.parametrize("name", list(GRAPHS))
def test_eval_graph_matches(core, ctex, name):
    graph, outn = GRAPHS[name]
    g = _graph_inputs()
    ctx = {"p": _t3(g["p"]), "uv": (torch.from_numpy(g["uv"][:, 0].copy()),
                                    torch.from_numpy(g["uv"][:, 1].copy())),
           "n": _t3(g["n"]), "wo": _t3(g["wo"]), "texture_names": TEX_NAMES}
    rgb, alpha, sval = eval_graph(_nodes(NodeDef, graph), outn, ctx, ctex)
    got = np.concatenate([_np3(rgb), alpha.numpy()[:, None],
                          sval.numpy()[:, None]], -1)
    want = core[f"graph:{name}"]
    np.testing.assert_allclose(got, want, **EXACT)
    if name != "mix_constants":
        assert want[:, :3].std() > 0.01


def test_mix_mode_5_is_the_lerp(core):
    """core_tpu's _mix_combine has no "divide" branch: mode 5 equals mode 0
    there, and here."""
    np.testing.assert_array_equal(core["graph:mix_mode5"],
                                  core["graph:mix_mode0"])


def test_node_input_naming_no_node_raises(ctex):
    one = torch.ones(4)
    ctx = {"p": tvec.V3(one, one, one), "uv": (one, one),
           "n": tvec.V3(one, one, one), "texture_names": TEX_NAMES}
    for ntype, key in (("mix", "input1"), ("layer", "upper_layer"),
                       ("add", "factor")):
        with pytest.raises(ValueError, match=f"{key} names no shader node"):
            eval_graph([NodeDef("m", ntype, ((key, "nope"),))], "m", ctx,
                       ctex)


# ---- bump mapping ----

def test_apply_bump_matches_core_tpu(core, ctex):
    b = _bump_inputs()
    ids = torch.from_numpy(b["mat"])
    sps = tvec.SPS(p=_t3(b["p"]), **{k: _t3(b[k]) for k in ("n", "ng", "nu",
                                                           "nv")},
                   u=torch.from_numpy(b["uv"][:, 0].copy()),
                   v=torch.from_numpy(b["uv"][:, 1].copy()), mat=ids,
                   light=ids, prim=ids, obj=ids)
    out = tscene.apply_bump_s(_bump_scene(NodeDef, ctex), sps)
    on = b["mat"] == 0
    for f in ("n", "nu", "nv"):
        got, want = _np3(getattr(out, f)), core[f"bump:{f}"]
        np.testing.assert_allclose(got, want, err_msg=f, **TOL_ULP)
        # the other material keeps its frame; the program's tilts where
        # the texture's clipped ramp is not flat
        np.testing.assert_array_equal(got[~on], b[f][~on])
        assert (np.abs(got[on] - b[f][on]).max(-1) > 1e-3).mean() > 0.3


# ---- glossy: anisotropic and coated ----

@pytest.mark.parametrize("row", list(GLOSSY))
def test_glossy_rows_match(core, row):
    table = build_material_table(_glossy_defs(MaterialDef, MatType), "cpu")
    i = list(GLOSSY).index(row)
    tp = gather_params_s(table, torch.full((N,), i))
    s = _surface()
    ids = torch.zeros(N, dtype=torch.int32)
    zeros = torch.zeros(N)
    sp = tvec.SPS(p=_t3(np.zeros((N, 3), np.float32)),
                  **{k: _t3(s[k]) for k in ("n", "ng", "nu", "nv")},
                  u=zeros, v=zeros, mat=ids, light=ids, prim=ids, obj=ids)
    wo, wi = _t3(s["wo"]), _t3(s["wi"])
    key = f"glossy:{row}"
    k = GLOSSY[row]
    tol = TOL_ULP if k["exp_u"] != k["exp_v"] else dict(
        rtol=2.5e-7 * k["exp_u"], atol=1e-6)
    np.testing.assert_allclose(_np3(tglossy.eval_bsdf_s(tp, sp, wo, wi)),
                               core[f"{key}:eval"], **tol)
    np.testing.assert_allclose(tglossy.pdf_bsdf_s(tp, sp, wo, wi).numpy(),
                               core[f"{key}:pdf"], **tol)
    r = tglossy.sample_bsdf_s(tp, sp, wo, torch.from_numpy(s["s1"]),
                              torch.from_numpy(s["s2"]))
    for f in r._fields:
        v = getattr(r, f)
        got = _np3(v) if isinstance(v, tvec.V3) else v.numpy()
        want = core[f"{key}:sample:{f}"]
        if f == "flags":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, err_msg=f, **tol)
    spec = tglossy.get_specular_s(tp, sp, wo)
    np.testing.assert_array_equal(spec.refl_valid.numpy(),
                                  core[f"{key}:spec:refl_valid"])
    np.testing.assert_array_equal(spec.refr_valid.numpy(),
                                  core[f"{key}:spec:refr_valid"])
    for f in ("refl_dir", "refl_col", "refr_dir", "refr_col"):
        np.testing.assert_allclose(_np3(getattr(spec, f)),
                                   core[f"{key}:spec:{f}"], err_msg=f, **tol)
    assert (core[f"{key}:pdf"] > 0).mean() > 0.5
    assert core[f"{key}:eval"].max() > 0.1
    coated = row.startswith("coated")
    assert core[f"{key}:spec:refl_valid"].all() == coated
    if coated:
        assert (core[f"{key}:spec:refl_col"][:, 0] > 0.02).all()


def test_aniso_lobe_differs_from_iso(core):
    a, b = core["glossy:aniso:eval"], core["glossy:iso:eval"]
    assert np.abs(a - b).max() > 0.1


# ---- image readers ----

def _assert_same_read(path):
    """Both packages' read_image of path: the same dtype (float32, or
    float64 from the HDR reader, as core_tpu's), shape and bytes."""
    got, want = read_image(str(path)), jimage.read_image(str(path))
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return got


def _png_chunk(tag, payload):
    c = tag + payload
    return struct.pack(">I", len(payload)) + c + struct.pack(
        ">I", zlib.crc32(c) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_filtered_png(path, px: np.ndarray, ctype: int):
    """An 8-bit PNG of px [h, w, ch] whose rows cycle through the five
    scanline filters (none, sub, up, average, paeth)."""
    h, w, ch = px.shape
    rows, prev = [], np.zeros(w * ch, np.int64)
    for r in range(h):
        line = px[r].reshape(-1).astype(np.int64)
        ft = r % 5
        enc = np.zeros_like(line)
        for i in range(line.shape[0]):
            a = line[i - ch] if i >= ch else 0
            b = prev[i]
            c = prev[i - ch] if i >= ch else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
            enc[i] = (line[i] - pred) & 0xFF
        rows.append(bytes([ft]) + enc.astype(np.uint8).tobytes())
        prev = line
    png = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    png += _png_chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
    path.write_bytes(png + _png_chunk(b"IEND", b""))


def test_png_written_by_core_tpu_reads_bit_equal(tmp_path):
    rng = np.random.default_rng(41)
    img = rng.uniform(0, 1, (7, 11, 4)).astype(np.float32)
    for name, arr, alpha, ch in (("rgb", img[..., :3], False, 3),
                                 ("rgba", img, True, 4),
                                 ("grey", img[..., 0], False, 3)):
        path = tmp_path / f"{name}.png"
        jimage.write_png(str(path), arr, alpha=alpha)
        got = _assert_same_read(path)
        assert got.shape == (7, 11, ch)
        src = arr if arr.ndim == 3 else np.repeat(arr[..., None], 3, -1)
        np.testing.assert_array_equal(np.round(got * 255),
                                      jimage.to_uint8(src[..., :ch]))


@pytest.mark.parametrize("ctype,ch", [(0, 1), (4, 2), (2, 3), (6, 4)],
                         ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_png_filters_and_colour_types_read_bit_equal(tmp_path, ctype, ch):
    rng = np.random.default_rng(ctype)
    # smooth rows with noise, so the predictors see every case
    base = (np.linspace(0, 255, 13)[None, :, None]
            + rng.integers(0, 40, (10, 13, ch))) % 256
    px = base.astype(np.uint8)
    path = tmp_path / "f.png"
    _write_filtered_png(path, px, ctype)
    got = _assert_same_read(path)
    np.testing.assert_array_equal(got, px.astype(np.float32) / 255.0)


def _rle_hdr_row(rgbe_row: np.ndarray) -> bytes:
    """One new-style RLE scanline: per channel, runs (count > 128) of a
    repeated byte and literal stretches."""
    w = rgbe_row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        v, x = rgbe_row[:, c], 0
        while x < w:
            r = 1
            while x + r < w and r < 127 and v[x + r] == v[x]:
                r += 1
            if r >= 3:
                out += bytes([128 + r, v[x]])
                x += r
            else:
                n = min(w - x, 3)
                out += bytes([n]) + v[x:x + n].tobytes()
                x += n
    return bytes(out)


def test_hdr_and_pic_read_bit_equal(tmp_path):
    rng = np.random.default_rng(43)
    img = (rng.uniform(0, 4, (6, 9, 3)) ** 2).astype(np.float32)
    img[0, :4] = 0.0
    flat = tmp_path / "flat.hdr"
    jimage.write_hdr(str(flat), img)
    got = _assert_same_read(flat)
    # RGBE keeps 8 bits of mantissa under the pixel's largest channel
    assert (np.abs(got - img) <= img.max(-1, keepdims=True) / 128).all()
    # the same pixels as run-length scanlines, read as .pic
    data = flat.read_bytes()
    head_end = data.index(b"\n", data.index(b"\n\n") + 2) + 1
    rgbe = np.frombuffer(data[head_end:], np.uint8).reshape(6, 9, 4).copy()
    rgbe[2, 3:8] = rgbe[2, 3]                      # a run in every channel
    rle = tmp_path / "rle.pic"
    rle.write_bytes(data[:head_end] + b"".join(
        _rle_hdr_row(row) for row in rgbe))
    got = _assert_same_read(rle)
    np.testing.assert_array_equal(got[2, 3:8], np.repeat(got[2, 3:4], 5, 0))


@pytest.mark.parametrize("alpha", [False, True])
def test_exr_reads_bit_equal(tmp_path, alpha):
    img = np.random.default_rng(44).normal(0, 3, (5, 8, 4)).astype(np.float32)
    path = tmp_path / "t.exr"
    jimage.write_exr(str(path), img, alpha=alpha)
    got = _assert_same_read(path)
    np.testing.assert_array_equal(got, img if alpha else img[..., :3])
