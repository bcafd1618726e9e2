"""Hand-written Hopper kernels with their plain PyTorch versions.

K1 ``flash_attention`` and K5 ``flash_attention_kv_mask``
(csrc/flash_fwd.cu), K2 ``block_sparse_attention_fast``
(csrc/vsa_sparse_fwd.cu), K7 forward / K8 ``block_sparse_attention``
(csrc/vsa_sparse_padded_fwd.cu, also under ``sta`` and ``sla``), K3
``conv3d_ndhwc`` (csrc/conv3d.cu), K4 ``conv3d_int8`` (csrc/conv3d_int8.cu,
the int8 modes of ``conv3d_ndhwc``), the backward kernels K6 and K7 bwd
(csrc/flash_bwd.cu, csrc/vsa_sparse_bwd.cu), K9a / K9b
``dyn_sparse_attention`` (csrc/dyn_sparse_fwd.cu, under ``nabla`` and
``bsa``). Launch and plain-call counts live in
``_build.LAUNCHES`` / ``_build.PLAIN_CALLS``.
"""

from fastvideo_tpu_torch.ops._build import (KERNELS, LAUNCHES, PLAIN_CALLS,
                                            KernelError, reset_counts)

__all__ = ["KERNELS", "LAUNCHES", "PLAIN_CALLS", "KernelError", "reset_counts"]
