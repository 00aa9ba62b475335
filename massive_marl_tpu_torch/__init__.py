"""massive_marl_tpu_torch: the PyTorch/CUDA port of massive_marl_tpu.

The JAX package stays the reference; this package mirrors its module names
(phys/, ops/, envs/, algos/, utils/, cli/) so each counterpart is easy to
find.  Its hot physics substep runs as a hand-written CUDA kernel
(ops/csrc/substep.cu); everything around it is plain PyTorch.

`make(task, algo)` is the library API: a ready vectorized env
(utils/registry.make_env).  Entry points take ``device=None``, which means
``"cuda"``.  They raise when CUDA is absent unless the caller passes
``device="cpu"`` explicitly (the CPU path is for tests: there the kernel
wrapper runs its plain PyTorch version).
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "massive_marl_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def make(task: str, algo: str = "ppo", num_envs: int | None = None, seed: int = 0,
         device=None, **overrides):
    """A ready vectorized env of `task` for `algo` (utils/registry.make_env)."""
    from massive_marl_tpu_torch.utils.registry import make_env
    return make_env(task, algo=algo, num_envs=num_envs, seed=seed, device=device, **overrides)
