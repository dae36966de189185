"""Rendering over several devices: core_tpu_torch's parallel/ against the
port's single-process renders and against core_tpu's parallel/.

One spawn of 4 gloo ranks on the CPU (joined through init_distributed
from the CORE_TPU_* env, as tests/test_multihost.py joins core_tpu's two
processes) runs every case of core_tpu's tests/test_sharding.py: the
full-frame sums on 2x2 and 4x1 meshes, the row-sharded film (a 2x2 box
filter, a ragged 30-row image on 4 tiles with the Mitchell halo, the
Mitchell halo at 16 rows), the bidirectional and photonmapping integrators
and the adaptive passes under render_image_rowsharded, row-sharded SPPM
(whose merged photon population must equal the single shoot bit for bit),
and both train steps (loss and lr * grad against diff.make_loss_fn's).  The
ranks wrap torch.distributed's collectives and count each call and its
bytes per case; a collective that core_tpu's design does not have fails.
The spawn and the port's single-process references run once per test run
(once_per_run), and so does core_tpu's render_rowsharded on the 8 virtual
CPU devices of tests/conftest.py.

Tolerance (tests/test_sharding.py's _assert_images_match): more than
99.5% of elements within rel 1e-3 and a mean rel below 2e-3.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from core_tpu.film import FilterType as JFilterType
from core_tpu.integrators.direct import DirectOptions as JDirectOptions
from core_tpu.parallel.sharding import make_mesh as j_make_mesh
from core_tpu.parallel.sharding import render_rowsharded as j_rowsharded
from core_tpu.render import RenderOptions as JRenderOptions
from core_tpu.scenes import cornell_box as j_cornell_box
from core_tpu_torch import cli
from core_tpu_torch import film as tfilm
from core_tpu_torch.film import FilterType
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.parallel import distributed as pd
from core_tpu_torch.parallel import sharding
from core_tpu_torch.render import (RenderOptions, render_chunk,
                                   scene_material_types)
from core_tpu_torch.scenes import cornell_box
from test_torch_diff import once_per_run

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cases, built the same way by the ranks and by the references here
CASES = textwrap.dedent("""\
    import torch
    from core_tpu_torch import diff
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.integrators.bidir import BidirOptions
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.photonmap import PhotonOptions
    from core_tpu_torch.integrators.sppm import SPPMOptions
    from core_tpu_torch.render import RenderOptions
    from core_tpu_torch.scenes import cornell_box

    BOX = RenderOptions(integrator="directlight",
                        integrator_opts=DirectOptions(raydepth=0))
    MITCHELL = dataclasses.replace(BOX, filter_type=FilterType.MITCHELL,
                                   filter_size=1.5)
    BIDIR = RenderOptions(integrator="bidirectional",
                          integrator_opts=BidirOptions(eye_depth=2,
                                                       light_depth=2),
                          aa_samples=2, spp_chunk=2)
    PM = RenderOptions(integrator="photonmapping", integrator_opts=
                       PhotonOptions(photons=8192, c_photons=1, bounces=3,
                                     diffuse_radius=60.0, final_gather=True,
                                     fg_samples=2, use_caustics=False,
                                     raydepth=0),
                       aa_samples=2, spp_chunk=2)
    ADAPTIVE = dataclasses.replace(BOX, aa_passes=2, aa_samples=2,
                                   aa_inc_samples=2, aa_threshold=0.03,
                                   spp_chunk=2)
    SPPM = SPPMOptions(passes=2, photons=4096, bounces=3,
                       search_radius=60.0, raydepth=1)
    SC = cornell_box(resx=16, resy=16, light_samples=1, device="cpu")
    SC30 = cornell_box(resx=16, resy=30, light_samples=1, device="cpu")
    TARGET = (diff.render_flat(SC, BOX, 2) * 0.8).detach()
    PARAMS = diff.extract_params(SC, geometry=False)
    LR = 0.5


    def population(photon_shard=None, gather=None):
        # pass 0's SPPM photons, packed [P, 10]: pos, power, dirn, valid
        from core_tpu_torch.integrators import sppm
        from core_tpu_torch.integrators.photonmap import (scene_bound,
                                                          world_sphere)
        from core_tpu_torch.photon.map import shoot_photons
        from core_tpu_torch.render import scene_material_types
        types = scene_material_types(SC)
        center, world_r = world_sphere(SC, *scene_bound(SC))
        if photon_shard is None:
            deps = shoot_photons(SC, types, SPPM.photons, SPPM.bounces,
                                 seed=7, mode="sppm", scene_center=center,
                                 scene_radius=world_r)
        else:
            deps = sppm.shoot_sharded(SC, types, SPPM, 7, center, world_r,
                                      photon_shard, gather)
        return torch.cat([deps[0], deps[1], deps[2],
                          deps[3][:, None].float()], dim=1)
""")

RANK = textwrap.dedent("""\
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from core_tpu_torch.parallel import distributed as pd
    from core_tpu_torch.parallel import sharding as sh
    assert pd.init_distributed(device="cpu")
    rank = dist.get_rank()
    out = sys.argv[1]

    # count every collective of torch.distributed by case: calls, bytes of
    # the tensor this rank sends
    COUNTS, CASE = {}, [None]

    def wrap(name):
        f = getattr(dist, name)

        def counted(*args, **kw):
            if CASE[0] is not None:
                t = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
                c = COUNTS.setdefault(CASE[0], {}).setdefault(name, [0, 0])
                c[0] += 1
                c[1] += 0 if t is None else t.numel() * t.element_size()
            return f(*args, **kw)
        setattr(dist, name, counted)

    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "all_gather_object", "broadcast", "broadcast_object_list",
                 "reduce", "reduce_scatter", "reduce_scatter_tensor",
                 "all_to_all", "all_to_all_single", "gather", "scatter",
                 "send", "recv", "isend", "irecv", "batch_isend_irecv",
                 "barrier"):
        if hasattr(dist, name):
            wrap(name)
""") + CASES + textwrap.dedent("""\
    M22 = sh.make_mesh(4, spp_parallel=2)
    M41 = sh.make_mesh(4)
    RESULTS = {}


    def case(name, fn):
        CASE[0] = name
        RESULTS[name] = fn().detach().numpy()
        CASE[0] = None


    def train(make, mesh):
        loss, moved = make(SC, BOX, mesh, 2, lr=LR)(PARAMS, TARGET)
        delta = PARAMS["mat.diffuse_color"] - moved["mat.diffuse_color"]
        return torch.cat([loss.reshape(1), delta.reshape(-1)])


    case("sharded_2x2", lambda: sh.render_sharded(SC, BOX, M22, 2))
    case("sharded_4x1", lambda: sh.render_sharded(SC, BOX, M41, 2))
    case("rowsharded_2x2", lambda: sh.render_rowsharded(SC, BOX, M22, 2))
    case("rowsharded_mitchell_4x1",
         lambda: sh.render_rowsharded(SC, MITCHELL, M41, 2))
    case("rowsharded_ragged30_4x1",
         lambda: sh.render_rowsharded(SC30, MITCHELL, M41, 2))
    case("core_tpu_2x2", lambda: sh.render_rowsharded(SC, MITCHELL, M22, 2))
    case("bidir_2x2", lambda: sh.render_image_rowsharded(SC, BIDIR, M22))
    case("photonmapping_4x1",
         lambda: sh.render_image_rowsharded(SC, PM, M41))
    case("adaptive_4x1",
         lambda: sh.render_image_rowsharded(SC, ADAPTIVE, M41))
    case("sppm_4x1", lambda: sh.render_sppm_rowsharded(SC, SPPM, M41))
    case("population_4x1", lambda: population(
        (M41.tile, 4), lambda t: pd.all_gather(t, M41.tiles)))
    case("train_rowsharded_2x2",
         lambda: train(sh.make_train_step_rowsharded, M22))
    case("train_2x2", lambda: train(sh.make_train_step, M22))
    with open(f"{out}/counts{rank}.json", "w") as f:
        json.dump(COUNTS, f)
    if rank == 0:
        np.savez(f"{out}/ranks.npz", **RESULTS)
    pd.shutdown()
""")

# each case's collectives per rank, from core_tpu's design
# (core_tpu/parallel/sharding.py): a psum of the film (an all_reduce
# here), the halo ppermute pair along the tiles (one all_gather of the
# edge rows), the all_gather of the owned rows at flush (also of the
# film for the adaptive flags), the light image's psum over the tiles,
# SPPM's all_gather of the photon deposits a pass (one packed block), and
# in a train step the transposes of the forward's collectives, the loss's
# psum and the gradient sum
EXPECTED = {
    "sharded_2x2": {"all_reduce": 1},
    "sharded_4x1": {"all_reduce": 1},
    "rowsharded_2x2": {"all_reduce": 1, "all_gather": 2},
    "rowsharded_mitchell_4x1": {"all_gather": 2},
    "rowsharded_ragged30_4x1": {"all_gather": 2},
    "core_tpu_2x2": {"all_reduce": 1, "all_gather": 2},
    "bidir_2x2": {"all_reduce": 2, "all_gather": 2},
    "photonmapping_4x1": {"all_gather": 2},
    "adaptive_4x1": {"all_gather": 4},
    "sppm_4x1": {"all_gather": 3},
    "population_4x1": {"all_gather": 1},
    "train_rowsharded_2x2": {"all_reduce": 5, "all_gather": 2},
    "train_2x2": {"all_reduce": 3},
}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _references():
    """The port's single-process results of every case."""
    from core_tpu_torch import diff
    from core_tpu_torch.integrators.sppm import render_sppm
    from core_tpu_torch.render import render_image
    ns = {"dataclasses": dataclasses}
    exec(CASES, ns)
    g = ns.__getitem__
    flat = diff.render_flat(g("SC"), g("BOX"), 2)
    mitchell = diff.render_flat(g("SC"), g("MITCHELL"), 2)
    loss, grads = diff.value_and_grad(diff.make_loss_fn(
        g("SC"), g("BOX"), 2, g("TARGET")))(g("PARAMS"))
    train = torch.cat([loss.reshape(1),
                       g("LR") * grads["mat.diffuse_color"].reshape(-1)])
    refs = {"sharded_2x2": flat, "sharded_4x1": flat,
            "rowsharded_2x2": flat, "rowsharded_mitchell_4x1": mitchell,
            "rowsharded_ragged30_4x1": diff.render_flat(
                g("SC30"), g("MITCHELL"), 2),
            "bidir_2x2": render_image(g("SC"), g("BIDIR"))[0],
            "photonmapping_4x1": render_image(g("SC"), g("PM"))[0],
            "adaptive_4x1": render_image(g("SC"), g("ADAPTIVE"))[0],
            "sppm_4x1": render_sppm(g("SC"), g("SPPM")),
            "population_4x1": g("population")(),
            "train_rowsharded_2x2": train, "train_2x2": train}
    return {k: v.detach().numpy() for k, v in refs.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"rank.<case>", "ref.<case>", "coll.<rank>.<case>.<name>"}: the 4
    ranks' results, the port's single-process references, and each rank's
    collectives ([calls, bytes]) by case."""

    def compute():
        out = tmp_path_factory.mktemp("ranks")
        script = out / "rank.py"
        script.write_text(RANK)
        port = _free_port()
        procs, logs = [], []
        for rank in range(4):
            env = dict(os.environ, CORE_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       CORE_TPU_NUM_PROCESSES="4",
                       CORE_TPU_PROCESS_ID=str(rank),
                       PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            logs.append(open(out / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(out)], env=env, cwd=ROOT,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        try:
            refs = _references()
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        for rank, p in enumerate(procs):
            assert p.returncode == 0, \
                (out / f"rank{rank}.log").read_text()[-3000:]
        res = {}
        with np.load(out / "ranks.npz") as f:
            res.update({f"rank.{k}": f[k] for k in f.files})
        res.update({f"ref.{k}": v for k, v in refs.items()})
        for rank in range(4):
            counts = json.loads((out / f"counts{rank}.json").read_text())
            for c, names in counts.items():
                for name, v in names.items():
                    res[f"coll.{rank}.{c}.{name}"] = np.asarray(v)
        return res

    return once_per_run(tmp_path_factory, "torch_parallel_ranks", compute)[0]


def _mismatch(img, ref):
    """None when img matches ref at test_sharding.py's tolerance, else
    what is off."""
    rel = np.abs(img - ref) / np.maximum(np.abs(ref), 1.0)
    if img.shape != ref.shape:
        return f"shape {img.shape} != {ref.shape}"
    if (rel < 1e-3).mean() > 0.995 and rel.mean() < 2e-3:
        return None
    return f"share within 1e-3 {(rel < 1e-3).mean()}, mean rel {rel.mean()}"


def _check_cases(ranks, names):
    bad = {c: m for c in names
           if (m := _mismatch(ranks[f"rank.{c}"], ranks[f"ref.{c}"]))}
    assert not bad, bad


def test_render_sharded_matches_single(ranks):
    """The full-frame film summed over the ranks, meshes 2x2 and 4x1."""
    _check_cases(ranks, ["sharded_2x2", "sharded_4x1"])


def test_rowsharded_matches_single(ranks):
    """The row-sharded film: a 2x2 mesh with the box filter, the Mitchell
    halo on 4 tiles of 4 rows, and a ragged 30-row image on 4 tiles of 8
    rows (the last block padded by 2 and cropped at flush)."""
    _check_cases(ranks, ["rowsharded_2x2", "rowsharded_mitchell_4x1",
                         "rowsharded_ragged30_4x1"])
    assert ranks["rank.rowsharded_ragged30_4x1"].shape == (30, 16, 4)


def test_image_rowsharded_integrators_and_passes(ranks):
    """render_image_rowsharded: bidirectional on 2x2 (the light image
    carries energy), photonmapping on 4x1 (the maps built on every rank),
    two adaptive passes on 4x1 (flags from the gathered film)."""
    _check_cases(ranks, ["bidir_2x2", "photonmapping_4x1", "adaptive_4x1"])
    assert ranks["rank.bidir_2x2"][..., :3].mean() > 0.01


def test_sppm_rowsharded_and_photon_population(ranks):
    """Row-sharded SPPM matches the single-device loop, and the merged
    population of four photon shards is the single shoot, bit for bit."""
    _check_cases(ranks, ["sppm_4x1"])
    got, want = ranks["rank.population_4x1"], ranks["ref.population_4x1"]
    assert got.shape == want.shape == (4 * 4096, 10)
    np.testing.assert_array_equal(got, want)


def test_train_steps_match_single_gradient(ranks):
    """make_train_step_rowsharded and make_train_step on 2x2: the loss at
    rtol 1e-3 and lr * grad of mat.diffuse_color at rtol 1e-3 / atol 1e-4
    against diff.make_loss_fn's value_and_grad."""
    for c in ("train_rowsharded_2x2", "train_2x2"):
        got, want = ranks[f"rank.{c}"], ranks[f"ref.{c}"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-7,
                                   err_msg=c)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3, atol=1e-4,
                                   err_msg=c)
        assert np.abs(want[1:]).max() > 1e-3


def test_collectives_are_core_tpus(ranks):
    """Every rank makes, in each case, exactly the collectives of core_tpu's
    design (EXPECTED); the row-sharded film sends fewer bytes a rank than
    the full-frame sum."""
    for rank in range(4):
        got = {}
        for k, v in ranks.items():
            parts = k.split(".")
            if parts[0] == "coll" and parts[1] == str(rank):
                got.setdefault(parts[2], {})[parts[3]] = int(v[0])
        assert got == EXPECTED, (rank, got)

    def sent(case):
        return sum(int(v[1]) for k, v in ranks.items()
                   if k.startswith(f"coll.0.{case}."))

    assert 0 < sent("rowsharded_mitchell_4x1") < sent("sharded_4x1")


def test_rowsharded_matches_core_tpu(ranks, tmp_path_factory):
    """The port's render_rowsharded over 4 gloo ranks (2 tiles x 2 spp)
    against core_tpu's over make_mesh(4, spp_parallel=2) on the virtual
    CPU devices: a 16x16 Cornell box, light_samples=1, directlight
    raydepth 0, Mitchell 1.5, 2 spp."""

    def compute():
        scene = j_cornell_box(resx=16, resy=16, light_samples=1,
                              intersector="brute")
        opts = JRenderOptions(integrator="directlight",
                              integrator_opts=JDirectOptions(raydepth=0),
                              filter_type=JFilterType.MITCHELL,
                              filter_size=1.5)
        return {"img": np.asarray(j_rowsharded(
            scene, opts, j_make_mesh(4, spp_parallel=2), spp=2))}

    want = once_per_run(tmp_path_factory, "torch_parallel_core_tpu",
                        compute)[0]["img"]
    m = _mismatch(ranks["rank.core_tpu_2x2"], want)
    assert m is None, m


def test_row_blocks_compose_the_image():
    """render_chunk's row blocks (y0 / rows / splat_y0) splatted into
    halo'd frames sum to the whole image (the Mitchell filter's footprints
    cross the blocks), resample_mask is read by global pixel, and the
    scatter splat add_samples equals the grid splat and core_tpu's
    add_samples."""
    from core_tpu import film as jfilm
    sc = cornell_box(resx=16, resy=12, light_samples=1, device="cpu")
    opts = RenderOptions(integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=0),
                         filter_type=FilterType.MITCHELL, filter_size=1.5,
                         aa_samples=2)
    types = scene_material_types(sc)
    mask = torch.rand(12, 16, generator=torch.Generator().manual_seed(3)) \
        < 0.7
    with torch.no_grad():
        whole = render_chunk(sc, types, opts,
                             tfilm.make_film(12, 16, device="cpu"), 0, 2, 0,
                             resample_mask=mask)
        acc = torch.zeros(16, 16, 5)
        for y0, rows in ((0, 5), (5, 4), (9, 3)):
            f = render_chunk(sc, types, opts,
                             tfilm.make_film(rows + 4, 16, device="cpu"), 0,
                             2, 0, resample_mask=mask, y0=y0, rows=rows,
                             splat_y0=y0 - 2)
            acc[y0:y0 + rows + 4] += torch.cat(
                [f.rgba, f.weight[..., None]], dim=-1)
    np.testing.assert_allclose(acc[2:14].numpy(), torch.cat(
        [whole.rgba, whole.weight[..., None]], dim=-1).numpy(),
        rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(5)
    n, h, w = 300, 9, 11
    x = rng.integers(-1, w + 1, n)
    y = rng.integers(-1, h + 1, n)
    dx, dy = rng.random(n), rng.random(n)
    col = rng.random((n, 4)) * 2
    smask = rng.random(n) < 0.8
    for ftype in (FilterType.BOX, FilterType.MITCHELL, FilterType.GAUSS):
        fw = tfilm.effective_filterw(1.5, ftype)
        got = tfilm.add_samples(
            tfilm.make_film(h, w, device="cpu"), torch.tensor(x),
            torch.tensor(y), torch.tensor(dx, dtype=torch.float32),
            torch.tensor(dy, dtype=torch.float32),
            torch.tensor(col, dtype=torch.float32), fw, ftype,
            sample_mask=torch.tensor(smask), clamp_rgb=True)
        want = jfilm.add_samples(
            jfilm.make_film(h, w), x.astype(np.int32), y.astype(np.int32),
            dx.astype(np.float32), dy.astype(np.float32),
            col.astype(np.float32), fw, JFilterType(int(ftype)),
            sample_mask=smask, clamp_rgb=True)
        np.testing.assert_allclose(got.rgba.numpy(), np.asarray(want.rgba),
                                   rtol=1e-5, atol=1e-6, err_msg=str(ftype))
        np.testing.assert_allclose(got.weight.numpy(),
                                   np.asarray(want.weight), rtol=1e-5,
                                   atol=1e-6, err_msg=str(ftype))
    # a full grid of samples: the scatter splat equals the grid splat
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    gdx = torch.tensor(rng.random(h * w), dtype=torch.float32)
    gdy = torch.tensor(rng.random(h * w), dtype=torch.float32)
    gcol = torch.tensor(rng.random((h * w, 4)), dtype=torch.float32)
    fw = tfilm.effective_filterw(1.5, FilterType.MITCHELL)
    a = tfilm.add_samples(tfilm.make_film(h, w, device="cpu"),
                          torch.tensor(gx.reshape(-1)),
                          torch.tensor(gy.reshape(-1)), gdx, gdy, gcol, fw,
                          FilterType.MITCHELL)
    b = tfilm.add_samples_grid(tfilm.make_film(h, w, device="cpu"), gdx,
                               gdy, gcol, 1, fw, FilterType.MITCHELL)
    np.testing.assert_allclose(a.rgba.numpy(), b.rgba.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cli_devices_and_refusals(tmp_path, monkeypatch):
    """python -m core_tpu_torch --device cpu --devices 2 (two gloo ranks)
    writes the single-rank CLI's image within 1 LSB; outside a process
    group make_mesh and global_mesh raise naming init_distributed, and
    init_distributed with nothing configured returns False."""
    from core_tpu_torch.io import image as timage
    from test_frontend import CORNELL_XML
    path = tmp_path / "c.xml"
    path.write_text(CORNELL_XML)
    # one thread a rank (torch reads OMP_NUM_THREADS at start)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("CORE_TPU_COORDINATOR", "CORE_TPU_NUM_PROCESSES",
              "CORE_TPU_PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "core_tpu_torch", str(path),
         str(tmp_path / "two"), "--device", "cpu", "--devices", "2",
         "-v", "1"], capture_output=True, text=True, env=env, timeout=600,
        cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert cli.main([str(path), str(tmp_path / "one"), "--device", "cpu",
                     "-v", "1"]) == 0
    two = timage.read_png(str(tmp_path / "two.png"))
    one = timage.read_png(str(tmp_path / "one.png"))
    assert two.shape == one.shape == (16, 16, 3)
    assert np.abs(two - one).max() <= 1.0 / 255 + 1e-6

    for k in ("CORE_TPU_COORDINATOR", "CORE_TPU_NUM_PROCESSES",
              "CORE_TPU_PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not pd.init_distributed()
    with pytest.raises(RuntimeError, match="init_distributed"):
        sharding.make_mesh(2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        pd.global_mesh()
