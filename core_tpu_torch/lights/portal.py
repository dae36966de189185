"""Background portal light (counterpart of core_tpu/lights/portal.py;
reference src/lights/bgportallight.cc).

A double-sided mesh light whose surface is sampled like an area light but
whose radiance is the scene background in the sampled direction, times
`power` (white without a background): portals concentrate environment
sampling through openings (windows, doors).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.lights import mesh as mesh_mod
from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.lights.mesh import MeshLight
from core_tpu_torch.vec import V3

DIRAC = False


@dataclass(frozen=True)
class BgPortalLight:
    """A MeshLight for the geometry and CDF; the colour comes from the
    background bound at scene compile (bgportallight.cc init)."""
    mesh: MeshLight
    background: Any = None
    power: torch.Tensor = None
    samples: int = 4


def make_bg_portal_light(verts, tri_vidx, background, power=1.0, samples=4,
                         obj_id=-1, *, device) -> BgPortalLight:
    m = mesh_mod.make_mesh_light(verts, tri_vidx, color=(1.0, 1.0, 1.0),
                                 power=1.0, samples=samples, obj_id=obj_id,
                                 double_sided=True, device=device)
    return BgPortalLight(mesh=m, background=background,
                         power=torch.as_tensor(np.float32(power),
                                               device=device),
                         samples=samples)


def can_intersect(light: BgPortalLight) -> bool:
    return True


def get_n_samples(light: BgPortalLight) -> int:
    return light.samples


def _bg_col(light: BgPortalLight, d: V3) -> V3:
    if light.background is None:
        one = torch.ones_like(d.x)
        return V3(one, one, one)
    return eval_background_s(light.background, d) * light.power


def illum_sample_s(light: BgPortalLight, sp, s1, s2) -> LightSampleS:
    ls = mesh_mod.illum_sample_s(light.mesh, sp, s1, s2)
    return ls._replace(col=_bg_col(light, ls.wi))


def intersect_light_s(light: BgPortalLight, rays) -> LightHitS:
    lh = mesh_mod.intersect_light_s(light.mesh, rays)
    return lh._replace(col=_bg_col(light, rays.d))


def illum_pdf_s(light: BgPortalLight, sp, p_light: V3):
    return mesh_mod.illum_pdf_s(light.mesh, sp, p_light)
