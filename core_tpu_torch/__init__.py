"""core_tpu_torch: the PyTorch + CUDA port of core_tpu.

The package mirrors core_tpu's layout and module names, so each module here
has a counterpart of the same name there.  It is written in PyTorch, never
imports jax, and runs its intersection queries in hand-written CUDA kernels
(csrc/intersect.cu, csrc/cluster.cu) when the scene lives on a CUDA device.
On the CPU the same entry points run the kernels' plain PyTorch versions
(geometry/intersect.py, geometry/cluster_intersect.py).

Scope so far: the Cornell box, the textured mesh scenes (scenes.mesh_scene,
scenes.big_scene at 1,017,202 triangles), the golden mesh scene with image
textures and shader nodes (scenes.golden_mesh_scene) and the mesh zoo
(scenes.MESH_ZOO: every procedural texture, the mix and layer nodes, bump
mapping, anisotropic and coated glossy), direct-lit and path-traced
through render.render_image, and their gradients (diff.py); texture
images in TGA, PNG, HDR, EXR or .npy.  Anything outside that slice raises
NotImplementedError by name.
"""
