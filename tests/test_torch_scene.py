"""core_tpu_torch's scene layer against core_tpu's on identical inputs:
the Cornell box leaf by leaf, the numpy round trip of convert.py, camera
rays, surface points and material rows (rtol 1e-6), and the
NotImplementedError boundary of the slice.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from core_tpu import scene as jscene
from core_tpu import vec as jvec
from core_tpu.cameras import shoot_ray as j_shoot_ray
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.types import Hits as JHits
from core_tpu_torch import convert
from core_tpu_torch import scene as tscene
from core_tpu_torch import vec as tvec
from core_tpu_torch.cameras import shoot_ray as t_shoot_ray
from core_tpu_torch.scenes import cornell_box as t_cornell_box
from core_tpu_torch.types import Hits as THits

torch.set_num_threads(1)
RES = 16


@pytest.fixture(scope="module")
def scenes():
    js = j_cornell_box(resx=RES, resy=RES, light_samples=3,
                       intersector="brute")
    ts = t_cornell_box(resx=RES, resy=RES, light_samples=3, device="cpu")
    return js, ts


def test_cornell_box_equals_core_tpu_leaf_by_leaf(scenes):
    js, ts = scenes
    jl, jst = convert.scene_to_numpy(js)
    tl, tst = convert.scene_to_numpy(ts)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)
    assert jst == tst
    assert ts.geom.n_tris == 36 and ts.intersector == "torch"


def test_convert_round_trip(scenes):
    js, ts = scenes
    leaves, static = convert.scene_to_numpy(js)
    back = convert.scene_from_numpy(leaves, static, device="cpu")
    bl, bst = convert.scene_to_numpy(back)
    for k in leaves:
        np.testing.assert_array_equal(leaves[k], bl[k], err_msg=k)
    assert bst == static
    assert back.intersector == "torch"
    assert convert.scene_from_numpy(leaves, static, device="cpu",
                                    intersector="cuda").intersector == "cuda"


def test_camera_rays_match(scenes):
    js, ts = scenes
    rng = np.random.default_rng(0)
    px = rng.uniform(0, RES, 512).astype(np.float32)
    py = rng.uniform(0, RES, 512).astype(np.float32)
    jr, jw = j_shoot_ray(js.camera, jnp.asarray(px), jnp.asarray(py))
    tr, tw = t_shoot_ray(ts.camera, torch.from_numpy(px),
                         torch.from_numpy(py))
    for f in ("o", "d", "tmin", "tmax"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def _hits_and_rays(js):
    """Camera rays and interior rays, with core_tpu's brute-force hits."""
    rng = np.random.default_rng(1)
    n = 1024
    o = np.concatenate([
        np.tile(np.array([[278.0, 273.0, -800.0]], np.float32), (n // 2, 1)),
        rng.uniform([10, 335, 10], [546, 538, 549], (n // 2, 3))
    ]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:n // 2] = rng.uniform([-0.35, -0.35, 1.0], [0.35, 0.35, 1.0],
                             (n // 2, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rs = jvec.RaysS(o=jvec.v3(jnp.asarray(o)), d=jvec.v3(jnp.asarray(d)),
                    tmin=jnp.zeros(n), tmax=jnp.full(n, -1.0))
    hits = jscene.closest_hit_s(js, rs)
    return o, d, hits


@pytest.mark.parametrize("grad", [False, True])
def test_surface_points_and_material_rows_match(scenes, grad):
    js, ts = scenes
    o, d, jh = _hits_and_rays(js)
    n = o.shape[0]
    assert (np.asarray(jh.prim) >= 0).mean() > 0.9
    jrs = jvec.RaysS(o=jvec.v3(jnp.asarray(o)), d=jvec.v3(jnp.asarray(d)),
                     tmin=jnp.zeros(n), tmax=jnp.full(n, -1.0))
    jsp = jscene.surface_points_s(js, jrs, JHits(*jh))
    jp = jscene.material_params_s(js, jsp)

    trs = tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                     d=tvec.v3(torch.from_numpy(d)),
                     tmin=torch.zeros(n), tmax=torch.full((n,), -1.0))
    th = THits(*[torch.from_numpy(np.array(a)) for a in jh])
    with torch.set_grad_enabled(grad):
        tsp = tscene.surface_points_s(ts, trs, th)
        tp = tscene.material_params_s(ts, tsp)

    def cmp(j, t, name):
        if isinstance(t, tvec.V3):
            for c in "xyz":
                cmp(getattr(j, c), getattr(t, c), f"{name}.{c}")
            return
        j = np.asarray(j)
        t = t.detach().numpy()
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)

    for f in tvec.SPS._fields:
        cmp(getattr(jsp, f), getattr(tsp, f), f"sp.{f}")
    for f in tp._fields:
        cmp(getattr(jp, f), getattr(tp, f), f"params.{f}")


def test_closest_hit_entry_point_matches(scenes):
    """The scene-level entry point (intersector 'torch' on the CPU) agrees
    with core_tpu's brute-force closest hit on camera and interior rays."""
    js, ts = scenes
    o, d, jh = _hits_and_rays(js)
    n = o.shape[0]
    trs = tvec.RaysS(o=tvec.v3(torch.from_numpy(o)),
                     d=tvec.v3(torch.from_numpy(d)),
                     tmin=torch.zeros(n), tmax=torch.full((n,), -1.0))
    th = tscene.closest_hit_s(ts, trs)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6)


def test_triangle_table_is_packed_once(scenes):
    from core_tpu_torch.geometry.intersect import pack_tris
    _, ts = scenes
    assert ts.tri is ts.tri
    assert torch.equal(ts.tri, pack_tris(ts.geom.verts, ts.geom.tri_vidx))


def test_port_imports_without_jax():
    """Every module of core_tpu_torch imports in a process where jax cannot
    be imported, and none of them pulls in core_tpu."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in [m for m in sys.modules if m == 'jax' or m.startswith(("
        "'jax.', 'core_tpu.'))]: del sys.modules[m]\n"
        "sys.modules['jax'] = None\n"
        "import core_tpu_torch\n"
        "for m in pkgutil.walk_packages(core_tpu_torch.__path__, "
        "'core_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'core_tpu' "
        "or m.startswith('core_tpu.')]\n"
        "assert not bad, bad\n"
        "print('imported', len([m for m in sys.modules "
        "if m.startswith('core_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1],
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_entry_points_default_to_the_card():
    """cornell_box, mesh_scene and scene_from_numpy build on the card unless
    told otherwise; without a card that raises instead of falling back."""
    from core_tpu_torch.scenes import mesh_scene
    builders = [lambda: t_cornell_box(resx=4, resy=4, light_samples=1),
                lambda: mesh_scene(resx=4, resy=4, n_grid=4, torus_u=4,
                                   torus_v=3, ibl_samples=1, sun_samples=1),
                lambda: convert.scene_from_numpy(*convert.scene_to_numpy(
                    t_cornell_box(resx=4, resy=4, light_samples=1,
                                  device="cpu")))]
    for build in builders:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_resolve_intersector():
    assert tscene.resolve_intersector("auto", "cpu") == "torch"
    assert tscene.resolve_intersector("auto", torch.device("cuda", 0)) \
        == "cuda"
    assert tscene.resolve_intersector("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError):
        tscene.resolve_intersector("pallas", "cpu")


def test_unported_features_raise_by_name(scenes):
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.materials import dispatch
    from core_tpu_torch.materials.base import MatType
    from core_tpu_torch.render import RenderOptions, render_image
    js, ts = scenes
    # blend and mask rows never reach dispatch (material_params_s resolves
    # them); coated glossy and translucent share the glossy family's module
    with pytest.raises(NotImplementedError, match="BLEND"):
        dispatch._modules((int(MatType.SHINY_DIFFUSE), int(MatType.BLEND)))
    assert len(dispatch._modules((int(MatType.GLOSSY),
                                  int(MatType.COATED_GLOSSY),
                                  int(MatType.TRANSLUCENT)))) == 1
    # the bidirectional and debug integrators and SSS are ported: each
    # integrator takes its own options; an integrator core_tpu renders
    # volumes with is not a surface integrator of the port
    with pytest.raises(TypeError, match="BidirOptions"):
        render_image(ts, RenderOptions(
            integrator="bidirectional", integrator_opts=PathOptions()))
    with pytest.raises(TypeError, match="DebugOptions"):
        render_image(ts, RenderOptions(integrator="debug"))
    with pytest.raises(NotImplementedError, match="SkyIntegrator"):
        render_image(ts, RenderOptions(integrator="SkyIntegrator",
                                       integrator_opts=DirectOptions()))
    # mix and layer nodes and bump mapping are ported: each is recorded as
    # its material's program; a node type core_tpu does not know raises
    from core_tpu_torch.environment import SceneBuilder
    from core_tpu_torch.params import ParamMap
    for ntype, slot in (("mix", "diffuse_shader"),
                        ("layer", "diffuse_shader"),
                        ("texture_mapper", "bump_shader"),
                        ("curve", "diffuse_shader")):
        b = SceneBuilder("cpu")
        b.create("texture", "tex", ParamMap({"type": "clouds"}))
        b.create("material", "m0", ParamMap({"type": "shinydiffusemat"}))

        def make():
            b.create("material", "m", ParamMap({
                "type": "shinydiffusemat", slot: "node"}),
                extra=[ParamMap({"name": "node", "type": ntype,
                                 "texture": "tex"})])
        if ntype == "curve":
            with pytest.raises(NotImplementedError, match="curve"):
                make()
        else:
            make()
            assert [(m, s) for m, s, _, _ in b.node_programs] == [(1, slot)]
