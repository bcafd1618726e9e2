"""JAX module parameters -> the port's ``state_dict``.

``state_dict_from_jax`` takes the parameters of a ``fastvideo_tpu`` module,
flattened from ``nnx.state(model)`` into numpy arrays keyed by dotted path,
and applies the layout rules of ``fastvideo_tpu.models.loader.export``
(copied here, the port imports nothing of the JAX package):

* a Linear ``kernel`` [in, out] becomes ``weight`` [out, in], and an
  Int8Linear ``kernel_q`` [in, out] becomes ``weight_q`` [out, in] (its
  ``scale`` [out] keeps its path);
* a LoRA layer's ``lora_A`` [in, r] and ``lora_B`` [r, out] become the
  port's (torch / peft) ``lora_A`` [r, in] and ``lora_B`` [out, r];
* a 5-D conv ``weight`` in DHWIO becomes OIDHW;
* the PatchEmbed3D matmul kernel ``patch_embedding.proj.kernel``
  [C*pt*ph*pw, O] becomes the 5-D conv weight ``patch_embedding.weight``
  (a quantized one keeps its ``proj``, as the port's does);
* list indices and every other leaf keep their path and value.

The result's keys are the port module's ``state_dict()`` keys, and the
same keys ``export_torch_layout`` writes into a checkpoint. A JAX
``CausalWanTransformer3DModel`` has the Wan DiT's parameter tree, so its
parameters carry over by the same rules; so do the CLIP towers' (the
vision patch embedding is a Linear in both packages, its ``class_embedding``
and the position and token tables keep their paths).

The parameters may also come as the nested mapping of a JAX training
state (``TrainingPipeline.state.params`` from ``nnx.split``, as
``to_pure_dict()`` with numpy leaves): it is flattened to dotted paths
first. A gradient tree of the same structure maps the same way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

PATCH_EMBED = "patch_embedding.proj."


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested {name: {...: array}} mapping (integer keys for list items)
    as {dotted path: array}."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten_params(value, path + "."))
        else:
            out[path] = value
    return out


def state_dict_from_jax(flat: Mapping, *,
                        patch_size: tuple[int, int, int] = (1, 2, 2)
                        ) -> dict[str, torch.Tensor]:
    if any(isinstance(v, Mapping) for v in flat.values()):
        flat = flatten_params(flat)
    out: dict[str, torch.Tensor] = {}
    int8_patch = f"{PATCH_EMBED}kernel_q" in flat
    for path, value in flat.items():
        value = np.asarray(value)
        prefix, _, leaf = path.rpartition(".")
        if path.startswith(PATCH_EMBED) and not int8_patch:
            if leaf == "kernel":
                pt, ph, pw = patch_size
                cin = value.shape[0] // (pt * ph * pw)
                value = value.T.reshape(-1, cin, pt, ph, pw)
            path = f"patch_embedding.{'weight' if leaf == 'kernel' else leaf}"
        elif leaf in ("kernel", "kernel_q") and value.ndim == 2:
            path = f"{prefix}.{'weight' if leaf == 'kernel' else 'weight_q'}"
            value = value.T
        elif leaf in ("lora_A", "lora_B") and value.ndim == 2:
            value = value.T
        elif leaf == "weight" and value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        value = np.array(value, order="C")  # a writable copy
        if value.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret
            out[path] = torch.from_numpy(value.view(np.int16)).view(
                torch.bfloat16)
        else:
            out[path] = torch.from_numpy(value)
    return out
