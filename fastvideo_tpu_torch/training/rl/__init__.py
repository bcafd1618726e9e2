"""RL post-training methods (port of fastvideo_tpu/training/rl/)."""

from fastvideo_tpu_torch.training.rl.diffusion_nft import (
    DiffusionNFTConfig, DiffusionNFTPipeline, compute_group_advantages,
    return_decay)
from fastvideo_tpu_torch.training.rl.rewards import (ClipScoreScorer,
                                                     MultiRewardScorer,
                                                     PickScoreScorer,
                                                     build_multi_reward_scorer,
                                                     select_first_frame)
from fastvideo_tpu_torch.training.rl.sampling import (DiffusionSampler,
                                                      SamplingConfig,
                                                      SamplingResult)

__all__ = [
    "ClipScoreScorer",
    "DiffusionNFTConfig",
    "DiffusionNFTPipeline",
    "DiffusionSampler",
    "MultiRewardScorer",
    "PickScoreScorer",
    "SamplingConfig",
    "SamplingResult",
    "build_multi_reward_scorer",
    "compute_group_advantages",
    "return_decay",
    "select_first_frame",
]
