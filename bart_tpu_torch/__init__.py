"""bart_tpu_torch — the PyTorch/CUDA port of bart_tpu for NVIDIA Hopper.

Mirrors bart_tpu's module paths and names and imports nothing of it:
the host-side helpers it needs (constants, molecules, line lists, grids,
convergence diagnostics) are its own copies.  Plain tensor code is
PyTorch; the four fused kernels of bart_tpu/rt/fused.py (eclipse and
transit, K = 1 and folded) are hand-written CUDA C++ kernels for sm_90a
(csrc/), built with nvcc at first use and bound with ctypes.  Entry
points that create tensors take ``device=`` (the card unless the caller
asks for the CPU) and ``dtype=``, randomness goes through an explicit
``torch.Generator``, and the chain axis is a written-out batch
dimension (a single sample is a batch of 1).

Public API entry points (lazily imported):

    bart_tpu_torch.ForwardModel / ForwardConfig   the forward model
    bart_tpu_torch.Likelihood / ParamSpace        likelihood wiring
    bart_tpu_torch.EnsembleSampler                the ensemble sampler
                                                  (snooker, demc, mrw, unif)
    bart_tpu_torch.run_mcmc                       the retrieval
    bart_tpu_torch.build_opacity_grid             the opacity table build
    bart_tpu_torch.Pipeline / load_config         the staged CLI pipeline
    bart_tpu_torch.load_tli / save_tli            line databases (TLI)
    bart_tpu_torch.make_mesh / shard_model        multi-device execution

The CLI is ``python -m bart_tpu_torch -c cfg`` or, installed, the
``bart-tpu-torch`` console script.
"""

__version__ = "0.1.0"

_LAZY = {
    "ForwardModel": ("bart_tpu_torch.rt.forward", "ForwardModel"),
    "ForwardConfig": ("bart_tpu_torch.rt.forward", "ForwardConfig"),
    "Likelihood": ("bart_tpu_torch.inference.likelihood", "Likelihood"),
    "ParamSpace": ("bart_tpu_torch.inference.likelihood", "ParamSpace"),
    "run_mcmc": ("bart_tpu_torch.inference.retrieval", "run_mcmc"),
    "EnsembleSampler": ("bart_tpu_torch.inference.samplers",
                        "EnsembleSampler"),
    "build_opacity_grid": ("bart_tpu_torch.opacity.grid",
                           "build_opacity_grid"),
    "resolve_device": ("bart_tpu_torch.device", "resolve_device"),
    "Pipeline": ("bart_tpu_torch.driver.pipeline", "Pipeline"),
    "load_config": ("bart_tpu_torch.driver.config", "load_config"),
    "load_tli": ("bart_tpu_torch.linelist.tli", "load_tli"),
    "save_tli": ("bart_tpu_torch.linelist.tli", "save_tli"),
    "make_mesh": ("bart_tpu_torch.parallel.mesh", "make_mesh"),
    "shard_model": ("bart_tpu_torch.parallel.mesh", "shard_model"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'bart_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
