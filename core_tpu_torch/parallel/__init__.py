"""Rendering over several devices: process groups (distributed.py) and the
sharded renders and train steps (sharding.py)."""
from core_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, render_sharded, train_step_sharded,
)
