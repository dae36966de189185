"""CLI front end (counterpart of core_tpu/cli.py): the reference's
thebounty-xml loader (src/xml_loader/xml-loader.cc:39-287), flag for flag:
output format and path, z-buffer, verbosity, the settings badge, and
overrides layered over the file's render parameters.

    python -m core_tpu_torch scene.xml [output] [-f png|hdr|tga] [-z]
        [-v N] [--device cuda|cpu]

It renders on the card unless --device says otherwise.  Rendering over
several devices (--devices N > 1, -t N > 1, --multihost) is not ported
(core_tpu's parallel/): those flags raise NotImplementedError before the
file is read.
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
                    help="shard the render over N devices (0 = single; "
                         "N > 1 is not ported)")
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
                    help="render over several hosts (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.devices == 0 and args.threads > 1:
        args.devices = args.threads   # -t N == shard over N devices
    if args.multihost or args.devices > 1:
        raise NotImplementedError(
            "rendering over several devices (--devices / -t N > 1, "
            "--multihost: core_tpu's parallel/sharding.py and "
            "parallel/distributed.py) is not ported to core_tpu_torch yet")
    import numpy as np

    from core_tpu_torch.io import image as img_io
    from core_tpu_torch.io.xml_loader import parse_xml_scene
    from core_tpu_torch.render import render_image, render_zbuffer
    from core_tpu_torch.utils.logger import logger, set_verbosity
    from core_tpu_torch.utils.timer import timer
    set_verbosity(args.verbosity)

    # parse_xml_scene records the "parse" and "compile" events
    scene, opts = parse_xml_scene(args.input, device=args.device)
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
    if args.profile:
        from core_tpu_torch.utils.profiler import profile_trace
        prof = profile_trace(args.profile)
    with timer("render"), prof:
        img, _ = render_image(scene, opts, verbose=args.verbosity >= 2)
        img = img.cpu().numpy()

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
