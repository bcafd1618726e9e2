"""Reward scorers for the RL training methods (port of
fastvideo_tpu/training/rl/rewards.py).

A scorer maps (media [B, C, T, H, W] or [B, C, H, W] in [0, 1], prompts)
to per-sample float scores [B]. The CLIP-family scorers run the port's
CLIP dual tower (``models/clip_scoring.py``) from a LOCAL checkpoint
directory named by their environment variable; tests and offline runs may
inject scorers through ``build_multi_reward_scorer(scorers=...)``.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Sequence

import numpy as np

RewardScorer = Callable[[np.ndarray, Sequence[str]], np.ndarray]


def select_first_frame(media: np.ndarray) -> np.ndarray:
    """The first frame as [B, C, H, W]."""
    media = np.asarray(media)
    if media.ndim == 5:
        return media[:, :, 0]
    if media.ndim == 4:
        return media
    raise ValueError("media must have shape [B, C, H, W] or [B, C, T, H, W],"
                     f" got {media.shape}")


class MultiRewardScorer:
    """The weighted sum of named scorers; the details hold each scorer's
    scores and ``avg``, the sum."""

    def __init__(self, reward_weights: Mapping[str, float], *,
                 scorers: Mapping[str, RewardScorer]):
        self.reward_weights = {str(k): float(v)
                               for k, v in reward_weights.items()}
        if not self.reward_weights:
            raise ValueError("reward_weights must contain at least one reward")
        self.scorers = dict(scorers)
        unsupported = sorted(set(self.reward_weights) - set(self.scorers))
        if unsupported:
            raise ValueError(f"Unsupported reward(s): {unsupported}. "
                             f"Available rewards: {sorted(self.scorers)}")

    def __call__(self, media: np.ndarray,
                 prompts: Sequence[str]) -> dict[str, np.ndarray]:
        n = len(prompts)
        if np.asarray(media).shape[0] != n:
            raise ValueError(f"media batch size ({media.shape[0]}) must "
                             f"match prompt count ({n})")
        total = None
        details: dict[str, np.ndarray] = {}
        for name, weight in self.reward_weights.items():
            scores = np.asarray(self.scorers[name](media, prompts),
                                np.float32)
            if scores.ndim != 1 or scores.shape[0] != n:
                raise ValueError(f"Reward {name!r} must return shape [{n}], "
                                 f"got {scores.shape}")
            details[name] = scores
            weighted = scores * weight
            total = weighted if total is None else total + weighted
        details["avg"] = total
        return details


class _ClipDualTowerScorer:
    """Text-to-first-frame CLIP similarity times ``scale``."""

    env_var = ""
    scale = 1.0

    def __init__(self, checkpoint: str | None = None, device=None):
        from fastvideo_tpu_torch.models.clip_scoring import ClipDualTower

        self.tower = ClipDualTower(checkpoint or os.getenv(self.env_var, ""),
                                   env_var=self.env_var, device=device)

    def __call__(self, media: np.ndarray,
                 prompts: Sequence[str]) -> np.ndarray:
        frames = select_first_frame(np.asarray(media, np.float32))
        te = self.tower.embed_text(prompts)
        fe = self.tower.embed_frames_chw(frames)
        return np.sum(te * fe, axis=-1).astype(np.float32) * self.scale


class ClipScoreScorer(_ClipDualTowerScorer):
    """CLIPScore: the raw cosine similarity (the CLIP logit scale of ~100
    over 100)."""

    env_var = "FASTVIDEO_CLIPSCORE_WEIGHTS"
    scale = 1.0


class PickScoreScorer(_ClipDualTowerScorer):
    """PickScore: the logit-scaled similarity over 26."""

    env_var = "FASTVIDEO_PICKSCORE_WEIGHTS"
    scale = 100.0 / 26.0


def build_multi_reward_scorer(
        reward_weights: Mapping[str, float], *,
        scorers: Mapping[str, RewardScorer] | None = None,
        device=None) -> MultiRewardScorer:
    """The weighted scorer of ``reward_weights``: the given ``scorers``, or
    else ONLY the built-in scorers the weights name (each loads its weights
    at once, and raises when its environment variable is unset)."""
    if not reward_weights:
        raise ValueError("reward_weights must contain at least one reward")
    available: dict[str, RewardScorer] = dict(scorers or {})
    if not available:
        factories = {"pickscore": PickScoreScorer,
                     "clipscore": ClipScoreScorer}
        for name in reward_weights:
            if name not in factories:
                raise ValueError(f"unknown reward {name!r}; "
                                 f"available: {sorted(factories)}")
            available[name] = factories[name](device=device)
    return MultiRewardScorer(reward_weights, scorers=available)
