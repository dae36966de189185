"""CLI front end (counterpart of core_tpu/cli.py): the reference's
thebounty-xml loader (src/xml_loader/xml-loader.cc:39-287), flag for flag:
output format and path, z-buffer, verbosity, the settings badge, and
overrides layered over the file's render parameters.

    python -m core_tpu_torch scene.xml [output] [-f png|hdr|tga] [-z]
        [-v N] [--device cuda|cpu] [--devices N | -t N | --multihost]

It renders on the card unless --device says otherwise.  --devices N (or
-t N, N > 1) starts N ranks, one per card (cuda:0 .. N-1; with --device
cpu, N gloo ranks on the CPU), which render the file row-sharded
(parallel/sharding.py render_image_rowsharded); rank 0 writes the image.
Asking for more cards than there are raises, and a rank that fails makes
the command fail.  --multihost joins the process group the CORE_TPU_*
(or torchrun's) env describes and renders over every rank of it
(parallel/distributed.py).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys


def build_argparser() -> argparse.ArgumentParser:
    from core_tpu_torch import __version__
    ap = argparse.ArgumentParser(
        prog="core_tpu_torch",
        description="PyTorch/CUDA renderer: render a scene XML file")
    ap.add_argument("input", help="scene XML file (reference schema)")
    ap.add_argument("output", nargs="?", default="rendered",
                    help="output file base name")
    ap.add_argument("-f", "--format", default="png",
                    choices=["png", "hdr", "tga"], help="output format")
    ap.add_argument("-z", "--z-buffer", action="store_true",
                    help="also write a z-buffer image")
    ap.add_argument("-a", "--alpha", action="store_true",
                    help="write alpha channel")
    ap.add_argument("-v", "--verbosity", type=int, default=2,
                    help="0 mute, 1 errors, 2 info, 3 debug")
    ap.add_argument("--spp", type=int, default=None,
                    help="override AA_minsamples")
    ap.add_argument("--passes", type=int, default=None,
                    help="override AA_passes")
    ap.add_argument("--resx", type=int, default=None)
    ap.add_argument("--resy", type=int, default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the render over N devices, one rank each "
                         "(0 = single)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-t", "--threads", type=int, default=-1,
                    help="reference -t flag; N > 1 means --devices N "
                         "(-1 = auto, one device)")
    ap.add_argument("--version", action="version",
                    version=f"core_tpu_torch {__version__}")
    ap.add_argument("-dp", "--draw-params", action="store_true",
                    help="burn render-settings badge into the image "
                         "(reference xml-loader.cc -dp)")
    ap.add_argument("--custom-string", default="",
                    help="extra badge text (reference customString)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the render "
                         "into DIR/trace.json (Chrome trace format)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group of the CORE_TPU_"
                         "COORDINATOR / NUM_PROCESSES / PROCESS_ID env (or "
                         "torchrun's) and shard the film rows over every "
                         "rank")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.devices == 0 and args.threads > 1:
        args.devices = args.threads   # -t N == shard over N devices
    if args.multihost:
        from core_tpu_torch.parallel import distributed as pd
        if not pd.init_distributed(device=args.device):
            raise RuntimeError(
                "--multihost: no process group configured; set "
                "CORE_TPU_COORDINATOR, CORE_TPU_NUM_PROCESSES and "
                "CORE_TPU_PROCESS_ID (or torchrun's MASTER_ADDR, WORLD_SIZE "
                "and RANK) in every process")
        try:
            return _render(args, pd.rank_device(), pd.global_mesh())
        finally:
            pd.shutdown()
    if args.devices > 1:
        return _spawn_ranks(args)
    return _render(args, args.device)


def _spawn_ranks(args) -> int:
    """Start args.devices ranks, one per card (or on the CPU), and wait for
    them; a rank that fails raises here."""
    import socket

    import torch
    import torch.multiprocessing as mp
    n = args.devices
    if torch.device(args.device).type == "cuda" \
            and n > torch.cuda.device_count():
        raise RuntimeError(f"--devices {n}: only "
                           f"{torch.cuda.device_count()} CUDA devices here")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank_main, args=(vars(args), port), nprocs=n, join=True)
    return 0


def _rank_main(rank: int, args: dict, port: int):
    """One rank of --devices N: cuda:rank (or the CPU, with its share of
    torch's threads), the row-sharded render, rank 0 writes."""
    import torch

    from core_tpu_torch.parallel import distributed as pd
    args = argparse.Namespace(**args)
    n = args.devices
    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{rank}"
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    pd.init_distributed(f"127.0.0.1:{port}", n, rank, device=device)
    try:
        _render(args, device, pd.global_mesh())
    finally:
        pd.shutdown()


def _render(args, device, mesh=None) -> int:
    """Parse, render (row-sharded over `mesh` when given) and, on rank 0,
    write."""
    import numpy as np

    from core_tpu_torch.io import image as img_io
    from core_tpu_torch.io.xml_loader import parse_xml_scene
    from core_tpu_torch.render import render_image, render_zbuffer
    from core_tpu_torch.utils.logger import logger, set_verbosity
    from core_tpu_torch.utils.timer import timer
    rank0 = mesh is None or (mesh.tile == 0 and mesh.spp_index == 0)
    set_verbosity(args.verbosity if rank0 else min(args.verbosity, 1))

    # parse_xml_scene records the "parse" and "compile" events
    scene, opts = parse_xml_scene(args.input, device=device)
    if args.spp:
        opts = dataclasses.replace(opts, aa_samples=args.spp)
    if args.passes:
        opts = dataclasses.replace(opts, aa_passes=args.passes)
    if args.resx or args.resy:
        cam = dataclasses.replace(
            scene.camera, resx=args.resx or scene.camera.resx,
            resy=args.resy or scene.camera.resy)
        scene = dataclasses.replace(scene, camera=cam)

    logger.info("scene: %d triangles, %d lights, %d materials on %s",
                scene.geom.n_tris, len(scene.lights),
                scene.materials.mtype.shape[0], scene.device)
    logger.info("render: %dx%d, integrator=%s, AA %d passes x %d samples",
                scene.camera.resx, scene.camera.resy, opts.integrator,
                opts.aa_passes, opts.aa_samples)

    prof = contextlib.nullcontext()
    if args.profile and rank0:
        from core_tpu_torch.utils.profiler import profile_trace
        prof = profile_trace(args.profile)
    with timer("render"), prof:
        if mesh is None:
            img, _ = render_image(scene, opts,
                                  verbose=args.verbosity >= 2)
        else:
            from core_tpu_torch.parallel.sharding import \
                render_image_rowsharded
            img = render_image_rowsharded(scene, opts, mesh,
                                          verbose=args.verbosity >= 2)
        img = img.cpu().numpy()
    if not rank0:
        return 0

    if args.draw_params:
        from core_tpu_torch import __version__
        from core_tpu_torch.io.badge import badge_lines, draw_badge
        rt = dict(timer.events()).get("render", 0.0)
        aa = f"AA {opts.aa_passes};{opts.aa_samples};{opts.aa_inc_samples}"
        img = draw_badge(img, badge_lines(__version__, opts.integrator, aa,
                                          rt, args.custom_string))
    out = args.output
    if not out.endswith("." + args.format):
        out = out + "." + args.format

    with timer("write"):
        if args.format == "hdr":
            img_io.write_hdr(out, img[..., :3])
        elif args.format == "tga":
            img_io.write_tga(out, img, alpha=args.alpha)
        else:
            img_io.write_png(out, img, alpha=args.alpha)
    logger.info("wrote %s", out)

    if args.z_buffer:
        z = render_zbuffer(scene).cpu().numpy()
        zimg = np.repeat(z[..., None], 3, axis=-1)
        zout = out.rsplit(".", 1)[0] + "_zbuffer." + args.format
        if args.format == "hdr":
            img_io.write_hdr(zout, zimg)
        elif args.format == "tga":
            img_io.write_tga(zout, zimg)
        else:
            img_io.write_png(zout, zimg)
        logger.info("wrote %s", zout)
    for name, secs in timer.events():
        logger.info("%-8s %.3fs", name, secs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
