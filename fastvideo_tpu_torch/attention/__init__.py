from fastvideo_tpu_torch.attention.layer import (DistributedAttention,
                                                 LocalAttention)
from fastvideo_tpu_torch.attention.selector import (get_attn_backend,
                                                    resolve_backend_name)

__all__ = ["DistributedAttention", "LocalAttention", "get_attn_backend",
           "resolve_backend_name"]
