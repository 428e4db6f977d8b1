"""Which implementation a kernel-impl config field selects.

The JAX package resolves "auto" by ``jax.default_backend() == "tpu"``
(``robust_e2e_gan_tpu/utils/impl.py``). The port resolves it by the device
of the tensors instead, inside each kernel's wrapper:

* the kernel values ("auto", and the JAX names of the kernel paths) go
  through the wrapper, which launches the kernel on CUDA tensors and runs
  the plain version on CPU tensors. Where a module has both, it takes the
  training kernels (``ops/blstm_train.py``, ``ops/ctc.py``, autograd
  functions) when autograd records, and the inference kernel otherwise;
  the inference-only wrappers refuse inputs autograd would record
  (``check_no_grad``), since their outputs carry no graph;
* the plain values ("scan", "xla", "twopass") call the plain PyTorch
  version directly, on any device.

``BeamSearchConfig.prefix_impl`` takes "pallas" as a kernel value: the
per-utterance prefix kernel (``ops/ctc_prefix.py::prefix_psi_utt``), where
"auto" and "tiled" take the tiled one. ``DecoderConfig.step_impl`` has a
rule of its own, the JAX package's: only "fused" selects the fused
decoder step (``ops/att_dec.py``), and only with one decoder layer, the
location attention and a kernel ``score_impl``; "auto" and "xla" select
the unfused step (the attention wrapper, then the plain cell and readout).
"""

from __future__ import annotations

import functools

import torch

_KERNEL = ("auto", "fused", "tiled", "pallas")
_PLAIN = ("xla", "scan", "twopass")
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (sm_90)


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


def check(cond: bool, msg: str, *args) -> None:
    """Raise ValueError(msg) unless ``cond`` (kernel argument checks);
    with ``args``, the message is ``msg % args``, formatted only then."""
    if not cond:
        raise ValueError(msg % args if args else msg)


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ValueError if autograd would record through an
    inference-only wrapper: its kernel writes a fresh tensor that carries
    no graph, so every parameter upstream would silently get no gradient.
    Checked on every device, so the CPU tests see what the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name} is inference-only and its output carries no graph; "
            "call it under torch.no_grad() or torch.inference_mode()")


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(SM count, shared memory a block may opt into) of CUDA device
    ``index``: what the kernels' launch plans are computed from."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin
