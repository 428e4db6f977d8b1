"""Which implementation a kernel-impl config field selects.

The JAX package resolves "auto" by ``jax.default_backend() == "tpu"``
(``robust_e2e_gan_tpu/utils/impl.py``). The port resolves it by the device
of the tensors instead, inside each kernel's wrapper:

* the kernel values ("auto", and the JAX names of the kernel paths) go
  through the wrapper, which launches the kernel on CUDA tensors and runs
  the plain version on CPU tensors;
* the plain values ("scan", "xla", "twopass") call the plain PyTorch
  version directly, on any device.
"""

from __future__ import annotations

import torch

_KERNEL = ("auto", "fused", "tiled")
_PLAIN = ("xla", "scan", "twopass")


def kernel_enabled(impl: str) -> bool:
    """True when ``impl`` selects the kernel wrapper; False for the plain
    version. Unknown values raise, so a typo cannot measure the wrong
    path."""
    if impl in _KERNEL:
        return True
    if impl in _PLAIN:
        return False
    raise ValueError(
        f"unknown kernel impl {impl!r}; expected one of {_KERNEL + _PLAIN}"
    )


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")


def check(cond: bool, msg: str) -> None:
    """Raise ValueError(msg) unless ``cond`` (kernel argument checks)."""
    if not cond:
        raise ValueError(msg)
