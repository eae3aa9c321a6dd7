"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

  csrc/power_iter.cu — fused matrix-free power iteration (power_iter.py)
  csrc/ring.cu       — fused |A Bᵀ| row-sum, the similarity epilogue (ring.py)
  csrc/gram.cu       — batched slice covariance TᵢᵀTᵢ (gram.py)
  csrc/flash_attention.cu — online-softmax attention (flash_attention.py)

ops.py holds the dispatchers, ref.py the plain PyTorch versions, and
_build.py compiles csrc/ with nvcc at first use.  Nothing is compiled
or loaded at import.
"""
