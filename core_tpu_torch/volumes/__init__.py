from core_tpu_torch.volumes.regions import (  # noqa: F401
    UniformVolume, ExpDensityVolume, NoiseVolume, GridVolume, SkyVolume,
    make_uniform_volume, make_expdensity_volume, make_noise_volume,
    make_grid_volume, make_sky_volume, sigma_a, sigma_s, sigma_t, emission,
    tau, phase_hg,
)
