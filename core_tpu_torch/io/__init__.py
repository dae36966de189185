"""Image input of core_tpu_torch (counterpart of core_tpu/io/)."""
