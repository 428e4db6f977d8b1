"""robust_e2e_gan_torch: the serving decode of robust_e2e_gan_tpu, in PyTorch.

The port runs waveform -> enhancer -> fbank -> VGG/BLSTMP encoder -> joint
CTC/attention beam search on an NVIDIA Hopper card, through four CUDA
kernels written by hand for ``sm_90a`` (``csrc/``). Every kernel has a plain
PyTorch version beside it; a wrapper given a CPU tensor runs that version,
so the whole path also runs on the CPU, where the tests hold it against the
JAX package.

Module names follow the JAX package so each counterpart is easy to find.
The package imports neither JAX nor the JAX package: its configuration
dataclasses (``config.py``) and synthetic data (``data/synthetic.py``) are
its own, with the JAX package's field names and draws.
"""

__version__ = "0.1.0"
