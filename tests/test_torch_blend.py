"""Blend and mask materials of the port against core_tpu's, on the same
numpy inputs: scene.material_params_s resolves each BLEND / MASK row to a
sub-material's row (core_tpu/scene.py:456-516).

- The blend Cornell box (block_materials=("blend_diff", "blend_cross"):
  white (+) red shiny-diffuse at 0.35 on the short block, glossy (+) glass
  at 0.5 on the tall one), 256 rays aimed at random points of the two
  blocks, each hit given a random uv in [-2, 2)^2 (negative uvs exercise
  the float -> int32 -> uint32 wrap of the pick's uv quantization): the
  resolved rows of both packages at three pick seeds (none, a render's
  9781 * pixel_sample + sampling_offs, and full-range uint32 seeds, whose
  products exceed int64 unless masked) must agree column by column and
  lane for lane, exactly; the cross-family lanes' picked family (the
  resolved mtype) among them, with both sub-materials picked.
- A mask row and a textured blend row built through MaterialDef (the
  port's MaterialDef gives the rows core_tpu's gives, flags included),
  with a clouds noise texture as blend_tex: the mask picks its sub-material by
  the texture's mean against blend_val, the blend takes the texture's mean
  as its factor; the resolved rows, the diffuse texture mapped after the
  resolve, agree with core_tpu's within rtol 1e-5 / atol 1e-6 (the noise
  is evaluated by each package), the picked sub-material lane for lane.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from core_tpu import scene as jscene
from core_tpu import vec as jvec
from core_tpu.materials.base import MaterialDef as JMaterialDef
from core_tpu.materials.base import build_material_table as j_table
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu.textures.base import TextureDef as JTextureDef
from core_tpu.textures.base import build_texture_set as j_textures
from core_tpu_torch import convert
from core_tpu_torch import scene as tscene
from core_tpu_torch.materials.base import MaterialDef as TMaterialDef
from core_tpu_torch.materials.base import MatType
from core_tpu_torch.materials.base import build_material_table as t_table
from core_tpu_torch.vec import V3, RaysS, v3

torch.set_num_threads(1)
N = 256
RES = 16


def _block_lanes(ts, seed):
    """SoA surface points of N rays from the camera aimed at random points
    of the two blocks (materials >= 4), with random uvs."""
    rng = np.random.default_rng(seed)
    g = ts.geom
    tri = rng.choice(np.nonzero(g.tri_mat.numpy() >= 4)[0], N)
    bary = rng.dirichlet([1.0, 1.0, 1.0], N).astype(np.float32)
    target = (bary[:, :, None]
              * g.verts.numpy()[g.tri_vidx.numpy()[tri]]).sum(1)
    o = np.broadcast_to(ts.camera.pos.numpy(), (N, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rs = RaysS(o=v3(torch.from_numpy(o)), d=v3(torch.from_numpy(d)),
               tmin=torch.full((N,), 5e-4), tmax=torch.full((N,), -1.0))
    hits = tscene.closest_hit_s(ts, rs)
    assert bool(hits.valid.all())
    sp = tscene.surface_points_s(ts, rs, hits)
    uv = rng.uniform(-2.0, 2.0, (2, N)).astype(np.float32)
    return sp._replace(u=torch.from_numpy(uv[0]), v=torch.from_numpy(uv[1]))


def _j_sps(sp):
    """The same surface points as core_tpu's SPS."""
    def j3(a):
        return jvec.V3(*(jnp.asarray(c.numpy()) for c in a))
    return jvec.SPS(p=j3(sp.p), n=j3(sp.n), ng=j3(sp.ng), nu=j3(sp.nu),
                    nv=j3(sp.nv), u=jnp.asarray(sp.u.numpy()),
                    v=jnp.asarray(sp.v.numpy()),
                    mat=jnp.asarray(sp.mat.numpy()),
                    light=jnp.asarray(sp.light.numpy()),
                    prim=jnp.asarray(sp.prim.numpy()),
                    obj=jnp.asarray(sp.obj.numpy()))


def _compare(tp, jp, exact):
    for f in tp._fields:
        got, want = getattr(tp, f), getattr(jp, f)
        if isinstance(got, V3):
            got, want = torch.stack(tuple(got), -1), np.stack(
                [np.asarray(c) for c in want], -1)
        got, want = got.numpy(), np.asarray(want)
        if exact or want.dtype.kind != "f":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f)


@pytest.fixture(scope="module")
def blend_box():
    js = j_cornell_box(resx=RES, resy=RES, light_samples=1,
                       block_materials=("blend_diff", "blend_cross"),
                       intersector="brute")
    ts = convert.scene_from_numpy(*convert.scene_to_numpy(js), device="cpu")
    return js, ts, _block_lanes(ts, 0)


@pytest.mark.parametrize("seed", ["none", "render", "full"])
def test_blend_rows_match_core_tpu(blend_box, seed):
    js, ts, sp = blend_box
    rng = np.random.default_rng(1)
    if seed == "none":
        pick = None
    elif seed == "render":
        ps = rng.integers(0, 64, N)
        so = rng.integers(0, 2**32, N)
        pick = (9781 * ps + so) & 0xFFFFFFFF
    else:
        pick = rng.integers(2**31, 2**32, N)
    got = tscene.material_params_s(
        ts, sp, pick_seed=None if pick is None else torch.from_numpy(pick))
    with jax.disable_jit():
        want = jscene.material_params_s(
            js, _j_sps(sp), pick_seed=None if pick is None
            else jnp.asarray(pick.astype(np.uint32)))
    _compare(got, want, exact=True)
    # the tall block's cross-family lanes take both sub-materials
    cross = sp.mat.numpy() == int(np.asarray(js.materials.mtype).size - 1)
    fam = got.mtype.numpy()[cross]
    assert cross.sum() > 50
    assert set(fam.tolist()) == {int(MatType.GLOSSY), int(MatType.GLASS)}
    assert 0.25 < (fam == int(MatType.GLASS)).mean() < 0.75
    # the short block's same-family lanes are the 0.35 lerp of white, red
    short = sp.mat.numpy() == 4
    np.testing.assert_allclose(got.diffuse_color.y.numpy()[short],
                               0.75 * 0.65 + 0.065 * 0.35, rtol=1e-6)


def test_mask_and_textured_blend_match_core_tpu(blend_box):
    js0, _, _ = blend_box
    white, red, green = 0, 1, 2
    defs = [JMaterialDef(name="white", diffuse_color=(0.75, 0.75, 0.75)),
            JMaterialDef(name="red", diffuse_color=(0.63, 0.065, 0.05)),
            JMaterialDef(name="green", diffuse_color=(0.14, 0.45, 0.091),
                         diffuse_tex=0),
            JMaterialDef(name="light", diffuse_color=(1.0, 1.0, 1.0),
                         diffuse_strength=0.0, emit_strength=30.0),
            JMaterialDef(name="mask", mtype=MatType.MASK, sub_mat0=white,
                         sub_mat1=red, blend_val=0.5, blend_tex=0),
            JMaterialDef(name="tblend", mtype=MatType.BLEND,
                         sub_mat0=white, sub_mat1=green, blend_val=0.5,
                         blend_tex=0)]
    tex = j_textures([JTextureDef(size=80.0, depth=2, name="clouds")])
    js = dataclasses.replace(
        js0, materials=j_table(defs), textures=tex,
        mat_types=tuple(sorted({int(d.mtype) for d in defs})))
    ts = convert.scene_from_numpy(*convert.scene_to_numpy(js), device="cpu")
    assert ts.textures is not None and MatType.MASK in ts.mat_types
    # the port's MaterialDef builds the same rows, flags included
    own = t_table([TMaterialDef(**dataclasses.asdict(d)) for d in defs],
                  "cpu")
    for f in own._fields:
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      getattr(ts.materials, f).numpy(),
                                      err_msg=f)
    sp = _block_lanes(ts, 2)
    got = tscene.material_params_s(ts, sp)
    with jax.disable_jit():
        want = jscene.material_params_s(js, _j_sps(sp))
    _compare(got, want, exact=False)
    # the mask picks both sub-materials on the short block (material 4)
    mask = sp.mat.numpy() == 4
    red_pick = got.diffuse_color.y.numpy()[mask] < 0.1
    assert mask.sum() > 50 and 0.1 < red_pick.mean() < 0.9
