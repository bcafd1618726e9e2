"""The CLIP dual tower (text + vision) that scores frames against prompts
(port of fastvideo_tpu/models/clip_scoring.py).

One local checkpoint directory with ``text/``, ``vision/`` and
``tokenizer/`` component subdirectories serves every CLIP-based scorer
(``training/rl/rewards.py``). The towers load through the port's
``load_model_component`` in bf16 (the JAX loader's default precision) on the
card unless ``device="cpu"``; the tokenizer through the port's reader (a
CLIP ``tokenizer.json``: :class:`BPETokenizer`).

The geometry is JAX's: a prompt's embedding is the text tower's pooled and
projected token; a frame's is the MEAN of the vision tower's tokens, with
no projection (the frames go through the PIL-free resize of
``models/encoders/clip.py:preprocess_image`` on the host). Both are
L2-normalized. So where the text projection's width differs from the
vision tower's (CLIP-L and PickScore's published pairs among them), the
scorers' dot product raises, as in JAX.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch


class ClipDualTower:
    """Text and vision CLIP embeddings over the port's CLIP towers."""

    def __init__(self, checkpoint: str, env_var: str = "",
                 device: str | torch.device | None = None):
        if not checkpoint or not os.path.exists(checkpoint):
            raise FileNotFoundError(
                "CLIP dual-tower scorer needs a local checkpoint dir "
                "(text/ + vision/ + tokenizer/ components)"
                + (f"; set {env_var}" if env_var else ""))
        from fastvideo_tpu_torch.models.loader.component_loader import (
            load_model_component)
        from fastvideo_tpu_torch.models.loader.tokenizer import load_tokenizer

        self.device = torch.device(device or "cuda")
        self.text = load_model_component(os.path.join(checkpoint, "text"),
                                         device=self.device)
        self.vision = load_model_component(
            os.path.join(checkpoint, "vision"), device=self.device)
        tok_dir = os.path.join(checkpoint, "tokenizer")
        self.tokenizer = (load_tokenizer(tok_dir) if os.path.exists(tok_dir)
                          else None)

    @torch.no_grad()
    def embed_text(self, prompts: Sequence[str]) -> np.ndarray:
        """[N] prompts -> [N, D] L2-normalized embeddings."""
        if self.tokenizer is None:
            raise RuntimeError("scorer checkpoint has no tokenizer/ dir")
        toks = self.tokenizer(list(prompts), padding="max_length",
                              truncation=True, max_length=77,
                              return_tensors="np")
        ids = torch.as_tensor(toks["input_ids"], device=self.device)
        emb = self.text(ids).pooler_output.float().cpu().numpy()
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    def embed_frames_chw(self, frames: np.ndarray) -> np.ndarray:
        """[T, C, H, W] float [0, 1] -> [T, D] L2-normalized embeddings."""
        return self.embed_frames_hwc(
            np.asarray(frames, np.float32).transpose(0, 2, 3, 1))

    @torch.no_grad()
    def embed_frames_hwc(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, C] float [0, 1] -> [T, D] L2-normalized embeddings."""
        from fastvideo_tpu_torch.models.encoders.clip import preprocess_image

        # JAX's uint8 conversion truncates; it does not round
        px = np.concatenate([
            preprocess_image((np.clip(f, 0, 1) * 255).astype(np.uint8),
                             self.vision.config)
            for f in np.asarray(frames, np.float32)])
        out = self.vision(torch.as_tensor(px, device=self.device))
        emb = out.last_hidden_state.mean(dim=1).float().cpu().numpy()
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)
