"""PyTorch/CUDA port of `solvingpapers_tpu`, written for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors a module of `solvingpapers_tpu` (same layout, same public names)
and the parity tests (`tests/test_torch_*.py`) hold the two against each
other on the same inputs and weights. This package imports `torch` and
never `jax`, `flax` or anything of `solvingpapers_tpu` — the JAX
package's `__init__`s import jax eagerly, so what the port needs from
host-only modules is copied, not imported.

Ported so far (the serving slice): ops (norms, activations, rope,
attention, sampling masks), the flash-attention forward kernel
(`kernels/csrc/flash_fwd.cu`, CUDA C++ for sm_90a), `infer` (KV cache +
one-shot `generate`), the LLaMA-3 decoder, the model registry entries
it serves, Flax->torch weight conversion, and the lane-pool serving
engine (`serve/`).

Entry points run on `cuda` unless the caller passes ``device="cpu"``;
with no device given and no CUDA available they raise
(`device.resolve_device`).
"""

from solvingpapers_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
