"""core_tpu_torch: the PyTorch + CUDA port of core_tpu.

The package mirrors core_tpu's layout and module names, so each module here
has a counterpart of the same name there.  It is written in PyTorch, never
imports jax, and runs its intersection queries in hand-written CUDA kernels
(csrc/intersect.cu, csrc/cluster.cu) when the scene lives on a CUDA device.
On the CPU the same entry points run the kernels' plain PyTorch versions
(geometry/intersect.py, geometry/cluster_intersect.py).

Scope so far, forward only: the path-traced default Cornell box
(scenes.cornell_box) and the directlight render of the textured mesh scene
with IBL and a sun (scenes.mesh_scene, scenes.big_scene at 1,017,202
triangles), through render.render_image.  Anything outside that slice
raises NotImplementedError by name.
"""
