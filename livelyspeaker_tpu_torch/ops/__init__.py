"""Hand-written CUDA kernels, their wrappers and their plain versions.

- ``fused_mlp``: the fused TransMLP stack for sampling (``csrc/fused_transmlp.cu``);
- ``fused_mlp_train``: its training forward and backward (``csrc/fused_transmlp_train.cu``);
- ``fused_wav``: the WavEncoder conv stack, forward and backward, and the
  ``FusedWavEncoder`` drop-in (``csrc/fused_wav.cu``);
- ``grouped_swiglu``: the language-model text tower's feed-forward products,
  routed experts as groups of rows (``csrc/grouped_swiglu.cu``).
"""

__all__ = ["fused_mlp", "fused_mlp_train", "fused_wav", "grouped_swiglu"]
