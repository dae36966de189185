"""core_tpu_torch: the PyTorch + CUDA port of core_tpu.

The package mirrors core_tpu's layout and module names, so each module here
has a counterpart of the same name there.  It is written in PyTorch, never
imports jax, and runs its intersection queries in hand-written CUDA kernels
(csrc/intersect.cu, csrc/cluster.cu) when the scene lives on a CUDA device.
On the CPU the same entry points run the kernels' plain PyTorch versions
(geometry/intersect.py, geometry/cluster_intersect.py).

Scope: every scene, material, texture, light, background, camera, film
filter, volume region and integrator of core_tpu, rendered through
render.render_image (adaptive passes, checkpoints, progress bars, flush
outputs) and differentiated through diff.py; and the front ends: scene
files through io.xml_loader.parse_xml_scene and io.xml_writer.XmlInterface,
the command line (python -m core_tpu_torch scene.xml out -f png
[--device cpu], cli.py), the embedding API (interface.Interface), the
outputs and live view of gui.py, and the image writers of io/image.py;
rendering and training over several devices, one rank each
(parallel/distributed.py, parallel/sharding.py: the row-sharded film,
photon-sharded SPPM, sharded train steps, the CLI's --devices, -t and
--multihost); and the BVH (geometry/bvh.py with its native builder,
native.py), which a scene takes only when asked.
Entry points run on the card (device="cuda") unless the caller asks for
the CPU.
"""

__version__ = "0.1.0"
