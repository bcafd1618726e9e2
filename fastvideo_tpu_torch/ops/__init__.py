"""Hand-written Hopper kernels with their plain PyTorch versions.

K1 ``flash_attention`` (csrc/flash_fwd.cu), K2 ``block_sparse_attention_fast``
(csrc/vsa_sparse_fwd.cu), K3 ``conv3d_ndhwc`` (csrc/conv3d.cu). Launch and
plain-call counts live in ``_build.LAUNCHES`` / ``_build.PLAIN_CALLS``.
"""

from fastvideo_tpu_torch.ops._build import (KERNELS, LAUNCHES, PLAIN_CALLS,
                                            KernelError, reset_counts)

__all__ = ["KERNELS", "LAUNCHES", "PLAIN_CALLS", "KernelError", "reset_counts"]
