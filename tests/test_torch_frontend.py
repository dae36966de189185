"""The port's front ends against core_tpu on the CPU: the XML loader and
writer, the geometry state machine (curves, instances, uv faces), the
image writers, the settings badge, the CLI, the embedding Interface with
its outputs and progress bars, and the live view.

Only core_tpu's parser, builders and writers run here, never a core_tpu
render.  Tolerances:
- a scene parsed by both packages: convert.scene_to_numpy's leaves, ints
  exact and floats within rtol 1e-6 (atol 1e-6); RenderOptions field by
  field; the port's 8^2 1-spp render of its own parse bit-identical to its
  render of scene_from_numpy(core_tpu's parse);
- add_curve / add_instance geometry, the XmlInterface text, the image
  writers' bytes and the badge's pixels: identical;
- the CLI's PNG equals the in-process render written by write_png, apart
  from the badge's render-time line (the two processes time differently);
- the Interface: as many flushes and progress ticks as chunks, the image
  equal to what its MemoryOutput holds, its compiled scene as above.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import urllib.request

import numpy as np
import pytest
import torch

from core_tpu.environment import SceneBuilder as JSceneBuilder
from core_tpu.geometry.mesh import MeshAssembler as JMeshAssembler
from core_tpu.interface import Interface as JInterface
from core_tpu.io import badge as jbadge
from core_tpu.io import image as jimage
from core_tpu.io.xml_loader import parse_xml_scene as j_parse
from core_tpu.io.xml_writer import XmlInterface as JXmlInterface
from core_tpu.params import ParamMap as JParamMap
from core_tpu_torch import __version__, cli, convert
from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.geometry.mesh import MeshAssembler
from core_tpu_torch.gui import CallbackOutput, LiveView, MemoryOutput
from core_tpu_torch.interface import Interface
from core_tpu_torch.io import badge
from core_tpu_torch.io import image as timage
from core_tpu_torch.io.xml_loader import parse_xml_scene
from core_tpu_torch.io.xml_writer import XmlInterface
from core_tpu_torch.params import ParamMap
from core_tpu_torch.render import render_image
from core_tpu_torch.utils.monitor import CallbackProgressBar

from test_frontend import CORNELL_XML
from test_torch_render_passes import _fields

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_frontend's Cornell scene at 8^2 with every state of the loader: a
# uv mesh with <n> and uv faces wearing a shader-node material over a
# texture, <smooth>, an <instance> of it with a <transform>, a <curve>, a
# sphere <object>, a volume region and a volume integrator
ALL_STATES_XML = CORNELL_XML.replace(
    '<resx ival="16"/>', '<resx ival="8"/>').replace(
    '<resy ival="16"/>', '<resy ival="8"/>').replace(
    '<raydepth ival="0"/>', '<raydepth ival="2"/>').replace(
    '<AA_minsamples ival="2"/>', '<AA_minsamples ival="1"/>').replace(
    "</scene>\n", textwrap.dedent("""\
    <texture name="cl">
        <type sval="clouds"/>
        <color1 r="0.1" g="0.2" b="0.6"/>
        <color2 r="0.9" g="0.8" b="0.3"/>
        <size fval="0.3"/>
        <depth ival="2"/>
    </texture>
    <material name="tex">
        <type sval="shinydiffusemat"/>
        <color r="0.8" g="0.8" b="0.8"/>
        <diffuse_shader sval="tmap"/>
        <list_element>
            <element sval="shader_node"/>
            <name sval="tmap"/>
            <type sval="texture_mapper"/>
            <texture sval="cl"/>
            <texco sval="uv"/>
        </list_element>
    </material>
    <mesh id="1" vertices="4" faces="2" has_uv="true">
        <p x="400" y="100" z="500"/>
        <p x="150" y="100" z="500"/>
        <p x="150" y="350" z="500"/>
        <p x="400" y="350" z="500"/>
        <n x="0" y="0" z="-1"/>
        <uv u="0" v="0"/>
        <uv u="1" v="0"/>
        <uv u="1" v="1"/>
        <uv u="0" v="1"/>
        <set_material sval="tex"/>
        <f a="0" b="1" c="2" uv_a="0" uv_b="1" uv_c="2"/>
        <f a="0" b="2" c="3" uv_a="0" uv_b="2" uv_c="3"/>
    </mesh>
    <smooth ID="1" angle="30"/>
    <instance base_object_id="1">
        <transform m00="0.5" m01="0" m02="0" m03="150"
                   m10="0" m11="0.5" m12="0" m13="40"
                   m20="0" m21="0" m22="1" m23="-150"
                   m30="0" m31="0" m32="0" m33="1"/>
    </instance>
    <curve>
        <p x="300" y="100" z="300"/>
        <p x="300" y="200" z="310"/>
        <p x="320" y="300" z="330"/>
        <strand_start fval="8"/>
        <strand_end fval="2"/>
        <strand_shape fval="0.3"/>
        <set_material sval="red"/>
    </curve>
    <object name="ball">
        <type sval="sphere"/>
        <center x="400" y="80" z="150"/>
        <radius fval="60"/>
        <material sval="white"/>
        <tess_u ival="8"/>
        <tess_v ival="4"/>
    </object>
    <volumeregion name="fog">
        <type sval="UniformVolume"/>
        <sigma_a fval="0.0005"/>
        <sigma_s fval="0.001"/>
        <minX fval="100"/><maxX fval="450"/>
        <minY fval="0"/><maxY fval="300"/>
        <minZ fval="100"/><maxZ fval="450"/>
    </volumeregion>
    <integrator name="volintegr">
        <type sval="SingleScatterIntegrator"/>
        <stepSize fval="100"/>
    </integrator>
    </scene>
    """))


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _assert_same_leaves(got_scene, want_scene):
    got, _ = convert.scene_to_numpy(got_scene)
    want, _ = convert.scene_to_numpy(want_scene)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_xml_loader_matches_core_tpu_in_every_state(tmp_path):
    path = _write(tmp_path, "all.xml", ALL_STATES_XML)
    scene, opts = parse_xml_scene(path, device="cpu")
    jscene, jopts = j_parse(path)
    assert scene.geom.n_tris == jscene.geom.n_tris == 4 + 2 + 2 + 14 + 48
    assert len(scene.volumes) == 1 and scene.node_programs
    _assert_same_leaves(scene, jscene)
    assert _fields(opts) == _fields(jopts)
    assert opts.volume_opts.integrator == "singlescatter"
    leaves, static = convert.scene_to_numpy(jscene)
    carried = convert.scene_from_numpy(leaves, static, device="cpu")
    got = render_image(scene, opts)[0]
    want = render_image(carried, opts)[0]
    assert torch.isfinite(got).all() and float(got[..., :3].max()) > 0
    assert torch.equal(got, want)


def test_curve_and_instance_geometry_match_core_tpu():
    """tests/test_parity_extras.py's strands, and a uv quad instanced twice
    (core_tpu emits instances under the object ids its counter holds at
    build time, mesh.py:219-225)."""
    curves = (([(0, 0, 0), (0, 0, 1), (0.1, 0, 2), (0.3, 0, 3)],
               dict(strand_start=0.05, strand_end=0.01)),
              ([(0, 0, 0), (0, 0, 1), (0, 0, 2)],
               dict(strand_start=0.2, strand_end=0.02, strand_shape=0.0)),
              ([(0, 0, 0), (0, 0, -1), (0.5, 0.2, -2)],
               dict(strand_start=0.1, strand_end=0.3, strand_shape=-0.4)))
    mat4 = np.array([[0.5, 0, 0, 1.0], [0, 2.0, 0, 0], [0, 0, 1, -3.0],
                     [0, 0, 0, 1]])
    out = []
    for a, extra in ((MeshAssembler(), dict(device="cpu")),
                     (JMeshAssembler(), {})):
        ids = []
        for pts, kw in curves:
            a.add_curve(a.start_mesh(), pts, mat=1, **kw)
        q = a.start_mesh()
        for p, uv in (((0, 0, 0), (0, 0)), ((1, 0, 0), (1, 0)),
                      ((1, 1, 0), (1, 1)), ((0, 1, 0), (0, 1))):
            a.add_vertex(q, *p)
            a.add_uv(q, *uv)
        a.add_triangle(q, 0, 1, 2, 2, uv_ids=(0, 1, 2))
        a.add_triangle(q, 0, 2, 3, 0)
        a.smooth_mesh(q, 181.0)
        ids.append(a.add_instance(q.obj_id, mat4))
        ids.append(a.add_instance(0, np.eye(4)))
        g = a.build(**extra)
        out.append((ids, {f: np.asarray(getattr(g, f)) for f in g._fields}))
    (ids, got), (jids, want) = out
    assert ids == jids == [4, 5]
    for f, w in want.items():
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    assert sorted(set(want["tri_obj"].tolist())) == [0, 1, 2, 3, 6, 7]


def _writer_calls(xi):
    """One call of every XmlInterface method, a whole scene."""
    xi.params_set_string("type", "shinydiffusemat")
    xi.params_set_color("color", 0.7, 0.25, 0.125)
    xi.params_set_float("IOR", 1.3333333333)
    xi.params_set_bool("fresnel_effect", True)
    xi.create_material("m & <x>")
    xi.params_set_string("type", "clouds")
    xi.params_set_int("depth", 3)
    xi.create_texture("tx")
    xi.params_set_string("type", "pointlight")
    xi.params_set_point("from", 0.1, 3.0, -1.0 / 3.0)
    xi.params_set_color("color", 1, 1, 1)
    xi.params_set_float("power", 20.0)
    xi.create_light("lamp")
    xi.params_set_string("type", "constant")
    xi.params_set_color("color", 0.05, 0.05, 0.1)
    xi.create_background("bg")
    xi.params_set_string("type", "UniformVolume")
    xi.params_set_float("maxX", 1.0)
    xi.create_volume_region("fog")
    xi.params_set_string("type", "perspective")
    xi.params_set_point("from", 0, 3, -6)
    xi.params_set_point("to", 0, 0, 0)
    xi.params_set_point("up", 0, 4, -6)
    xi.params_set_int("resx", 12)
    xi.params_set_int("resy", 10)
    xi.create_camera("cam")
    mid = xi.start_tri_mesh(has_uv=True)
    xi.set_current_material("m & <x>")
    for i, (x, z) in enumerate(((-2, -2), (2, -2), (2, 2), (-2, 2))):
        xi.add_vertex(x + 1e-7 * i, np.float32(0.1) * i, z)
        xi.add_normal(0.0, 1.0, 0.0)
        xi.add_uv(x / 4 + 0.5, z / 4 + 0.5)
    xi.add_triangle(0, 1, 2, uv=(0, 1, 2))
    xi.add_triangle(0, 2, 3)
    xi.end_tri_mesh()
    xi.smooth_mesh(mid, 60.0)
    xi.start_curve_mesh()
    for p in ((0, 0, 0), (0, 1, 0.1), (0.2, 2, 0.3)):
        xi.add_vertex(*p)
    xi.end_curve_mesh("m & <x>", 0.05, 0.01, 0.25)
    xi.add_instance(mid, np.diag([1.0, 2.0, 1.0, 1.0]))
    xi.params_set_string("type", "directlighting")
    xi.create_integrator("default")
    xi.params_set_int("AA_minsamples", 2)
    xi.params_set_float("gamma", 2.2)
    return xi


def test_xml_writer_text_matches_core_tpu(tmp_path):
    path = str(tmp_path / "w.xml")
    text = _writer_calls(XmlInterface()).render(path)
    assert text == _writer_calls(JXmlInterface()).render(
        str(tmp_path / "j.xml"))
    scene, opts = parse_xml_scene(path, device="cpu")
    jscene, jopts = j_parse(path)
    assert scene.geom.n_tris == 2 + 14 + 2 and len(scene.volumes) == 1
    _assert_same_leaves(scene, jscene)
    assert _fields(opts) == _fields(jopts)


def test_image_writers_write_core_tpu_bytes(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.uniform(-0.2, 1.3, (5, 7, 4)).astype(np.float32)
    img[0, 0] = (0.0, 0.0, 0.0, 1.0)
    img[1, 1] = (3.0e4, 2.0, 1e-40, 0.5)
    cases = [("png", False), ("png", True), ("hdr", False), ("tga", False),
             ("tga", True), ("exr", False), ("exr", True), ("npy", False)]
    for ext, alpha in cases:
        got, want = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
        timage.write_image(str(got), img, alpha)
        jimage.write_image(str(want), img, alpha)
        assert got.read_bytes() == want.read_bytes(), (ext, alpha)
    np.testing.assert_array_equal(timage.to_uint8(img), jimage.to_uint8(img))
    grey = img[..., 0]
    timage.write_png(str(tmp_path / "g.png"), grey)
    jimage.write_png(str(tmp_path / "h.png"), grey)
    assert (tmp_path / "g.png").read_bytes() == \
        (tmp_path / "h.png").read_bytes()
    # .jpg and .tif: tests/test_torch_image_codecs.py; BMP is not ported
    with pytest.raises(NotImplementedError, match=r"\.bmp"):
        timage.write_image(str(tmp_path / "x.bmp"), img)


def test_badge_matches_core_tpu():
    img = np.random.default_rng(3).uniform(0, 1, (40, 90, 4)).astype(
        np.float32)
    lines = jbadge.badge_lines("0.1.0", "pathtracing", "AA 1;4;1", 1.25,
                               "custom: all glyphs @#%[]_")
    np.testing.assert_array_equal(badge.draw_badge(img, lines),
                                  jbadge.draw_badge(img, lines))
    np.testing.assert_array_equal(badge.text_mask("Az09 |.;"),
                                  jbadge.text_mask("Az09 |.;"))
    got = badge.badge_lines("0.1.0", "pathtracing", "AA 1;4;1", 1.25)
    assert got[0] == "core_tpu_torch 0.1.0 | pathtracing"
    assert got[1:] == lines[1:2]


def test_cli_subprocess_equals_in_process_render(tmp_path):
    """python -m core_tpu_torch on the CPU (the kernels are never built):
    its PNG is the in-process render with the badge, written by
    write_png, except the badge's render-time line; --profile writes a
    Chrome trace."""
    path = _write(tmp_path, "c.xml", CORNELL_XML.replace(
        'ival="16"', 'ival="32"'))
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "core_tpu_torch", path, out, "-f", "png",
         "--device", "cpu", "--spp", "1", "-z", "-dp", "--profile",
         str(tmp_path / "prof")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "render" in r.stderr and "compile" in r.stderr
    assert os.path.isfile(out + "_zbuffer.png")
    assert "traceEvents" in (tmp_path / "prof" / "trace.json").read_text()
    scene, opts = parse_xml_scene(path, device="cpu")
    opts = dataclasses.replace(opts, aa_samples=1)
    img = render_image(scene, opts)[0].numpy()
    lines = badge.badge_lines(__version__, opts.integrator, "AA 1;1;1", 0.0)
    timage.write_png(str(tmp_path / "want.png"), badge.draw_badge(img, lines))
    got = timage.read_png(out + ".png")
    want = timage.read_png(str(tmp_path / "want.png"))
    h = img.shape[0]
    bar_h = min(2 * 3 + badge.CHAR_H * len(lines), h)
    t0 = h - bar_h + 3 + badge.CHAR_H        # the render-time line's rows
    keep = np.ones(h, bool)
    keep[t0:t0 + badge.CHAR_H] = False
    assert got.shape == (32, 32, 3) and keep.sum() == 24
    np.testing.assert_array_equal(got[keep], want[keep])


def _interface_calls(yi):
    """tests/test_frontend.py's embedding sequence (a grey floor under a
    point light), at 8 samples a pixel: two chunks of 4."""
    yi.params_set_string("type", "shinydiffusemat")
    yi.params_set_color("color", 0.7, 0.7, 0.7)
    yi.create_material("grey")
    yi.params_set_string("type", "pointlight")
    yi.params_set_point("from", 0.0, 2.0, 0.0)
    yi.params_set_color("color", 1, 1, 1)
    yi.params_set_float("power", 20.0)
    yi.create_light("lamp")
    yi.start_tri_mesh()
    yi.set_current_material("grey")
    a = yi.add_vertex(-2, 0, -2)
    b = yi.add_vertex(2, 0, -2)
    c = yi.add_vertex(2, 0, 2)
    d = yi.add_vertex(-2, 0, 2)
    yi.add_triangle(a, b, c)
    yi.add_triangle(a, c, d)
    yi.end_tri_mesh()
    yi.params_set_string("type", "perspective")
    yi.params_set_point("from", 0, 3, -6)
    yi.params_set_point("to", 0, 0, 0)
    yi.params_set_point("up", 0, 4, -6)
    yi.params_set_int("resx", 12)
    yi.params_set_int("resy", 12)
    yi.create_camera("cam")
    yi.setup_render(AA_minsamples=8)
    return yi


def test_interface_outputs_and_progress_match_core_tpu():
    yi = _interface_calls(Interface(device="cpu"))
    scene, opts = yi.compile()
    jscene, jopts = _interface_calls(JInterface()).compile()
    _assert_same_leaves(scene, jscene)
    assert _fields(opts) == _fields(jopts)
    ticks, flushes = [], []
    mem = MemoryOutput(12, 12)

    def output(img, pass_idx, chunk_idx):
        flushes.append(chunk_idx)
        mem(img, pass_idx, chunk_idx)

    img = yi.render(output=output, progress=CallbackProgressBar(
        lambda done, total, tag: ticks.append((done, total))))
    assert flushes == [1, 2]
    assert ticks == [(1, 2), (2, 2), (2, 2)]        # two updates, done()
    np.testing.assert_array_equal(mem.image, img)
    assert img.shape == (12, 12, 4) and float(img[..., :3].max()) > 1e-3
    areas, finished = [], []
    out = CallbackOutput(draw_area=lambda x0, y0, w, h, tile:
                         areas.append((x0, y0, w, h)),
                         flush=finished.append)
    np.testing.assert_array_equal(yi.render(output=out), img)
    assert areas == [(0, 0, 12, 12)] * 2 and len(finished) == 1
    assert mem.view(2, 3, 10, 9).base is mem.image


def test_liveview_serves_png_and_abort():
    view = LiveView(port=0)
    port = view.start()
    try:
        view(np.full((8, 8, 4), 0.5, np.float32), 0, 1)
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame.png", timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"frame.png" in urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read()
        urllib.request.urlopen(f"http://127.0.0.1:{port}/pause",
                               timeout=10).read()
        assert view.paused
        urllib.request.urlopen(f"http://127.0.0.1:{port}/abort",
                               timeout=10).read()
        assert view.aborted and not view.paused
        with pytest.raises(KeyboardInterrupt):
            view(np.zeros((8, 8, 4), np.float32), 0, 2)
    finally:
        view.stop()


def test_default_camera_and_refusals(tmp_path, monkeypatch):
    """Without a camera compile_scene gives core_tpu's default one; the
    CLI refuses, by name and before reading the file, more devices than
    there are cards (--devices / -t N on cuda; this CPU has none) and
    --multihost without a process group in the env."""
    scenes = []
    for b, pm in ((SceneBuilder("cpu"), ParamMap),
                  (JSceneBuilder(), JParamMap)):
        b.create("material", "m", pm({"type": "shinydiffusemat"}))
        b.start_mesh()
        b.set_material("no such material")
        for p in ((0, 0, 0), (1, 0, 0), (0, 1, 0)):
            b.add_vertex(*p)
        b.add_triangle(0, 1, 2)
        b.end_mesh()
        scenes.append(b.compile_scene())
    _assert_same_leaves(*scenes)
    cam = scenes[0].camera
    assert (cam.resx, cam.resy) == (320, 240)
    for k in ("CORE_TPU_COORDINATOR", "CORE_TPU_NUM_PROCESSES",
              "CORE_TPU_PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    more = str(max(2, torch.cuda.device_count() + 1))
    for flags, match in (
            (["--devices", more], "CUDA devices"),
            (["-t", more], "CUDA devices"),
            (["--multihost", "--device", "cpu"], "CORE_TPU_COORDINATOR")):
        with pytest.raises(RuntimeError, match=match):
            cli.main([str(tmp_path / "none.xml"), str(tmp_path / "o"),
                      *flags])
