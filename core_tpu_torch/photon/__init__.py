"""Photon emission, shooting and the sorted-cell photon map (counterpart
of core_tpu/photon/)."""
from core_tpu_torch.photon.map import (  # noqa: F401
    PhotonMap, build_photon_grid, estimate_irradiance, gather_photons,
    shoot_photons,
)
