"""PyTorch/CUDA port of `solvingpapers_tpu`, written for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors a module of `solvingpapers_tpu` (same layout, same public names)
and the parity tests (`tests/test_torch_*.py`) hold the two against each
other on the same inputs and weights. This package imports `torch` and
never `jax`, `flax` or anything of `solvingpapers_tpu` — the JAX
package's `__init__`s import jax eagerly, so what the port needs from
host-only modules is copied, not imported.

Ported so far: the serving slice — ops (norms, activations, rope,
attention, sampling masks), `infer` (KV cache + one-shot `generate`),
the LLaMA-3 decoder, Flax->torch weight conversion and the lane-pool
serving engine (`serve/`) — and the training slice — the cross-entropy
loss, token-file data (`data/`), the optimizer, state and single-device
`Trainer` (`train/`), checkpoints, metrics writers and MFU, and the
`RunConfig` registry and factory (`configs/`) — and DeepSeek-V3's
training: MLA + MoE (`models/deepseekv3.py`, `ops/moe.py`), its
objective (`train/objectives.py`), remat and dropout. The flash-attention
kernels (`kernels/csrc/flash_fwd.cu`, `flash_bwd.cu`, CUDA C++ for
sm_90a, with in-kernel dropout) and the dropout mask kernel
(`dropout_mask.cu`) carry them.

Entry points (`Llama`, `DeepSeekV3`, `generate`, `ServeEngine`,
`Trainer`) run on
`cuda` unless the caller passes ``device="cpu"``;
with no device given and no CUDA available they raise
(`device.resolve_device`).
"""

from solvingpapers_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
