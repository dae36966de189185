"""Device profiling (counterpart of core_tpu/utils/profiler.py, which
wraps jax.profiler): a torch.profiler capture of a block, named regions,
and a CUDA memory snapshot.

    with profile_trace("trace_dir"):         # or the CLI's --profile DIR
        render_image(scene, opts)

    with annotate("photon_pass"):            # a named region in the trace
        ...

profile_trace records CPU activity, and CUDA activity when a card is
present, and writes the Chrome trace trace.json into the directory, where
each kernel is an event on the device's stream.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    log_dir/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region in the trace (torch.profiler.record_function); a
    context manager that costs little when no trace is active."""
    import torch
    return torch.profiler.record_function(name)


def save_device_memory_profile(path: str):
    """Write a snapshot of the card's allocator (torch.cuda.memory
    ._snapshot, a pickle that PyTorch's memory_viz reads) to path.  There
    is no device memory to snapshot without a card: raises."""
    import pickle

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile needs a CUDA device "
                           "(torch.cuda.is_available() is false)")
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
