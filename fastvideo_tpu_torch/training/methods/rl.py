"""RL method plugins (port of fastvideo_tpu/training/methods/rl.py).

``diffusion_nft`` wraps :class:`DiffusionNFTPipeline` behind the plugin
protocol; its reward scorers come from ``method_config.reward_fn``. As in
JAX, ``from_config`` attaches no decoder (the rewards then score the raw
latents; set ``method.pipeline.decode_fn``), and ``train`` takes
(prompts, embeds, latent_shape) batches, not the Parquet loader's.
"""

from __future__ import annotations

from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.training_pipeline import resolve_device


@register_method
class DiffusionNFTMethod(PipelineMethod):
    """DiffusionNFT multi-reward policy optimization.

    ``method_config`` keys:
      - ``reward_fn``: a non-empty mapping, e.g. ``{pickscore: 1.0}``
      - ``sampling``: a SamplingConfig mapping (num_steps, trajectory, ...)
      - ``num_video_per_prompt``, ``adv_clip_max``, ``timestep_fraction``,
        ``kl_beta``, ``beta`` (the NFT beta), ``decay_type``, ``adv_mode``,
        ``ema_decay``
    """

    name = "diffusion_nft"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "DiffusionNFTMethod":
        from fastvideo_tpu_torch.training.rl import (DiffusionNFTConfig,
                                                     DiffusionNFTPipeline,
                                                     SamplingConfig,
                                                     build_multi_reward_scorer)

        mc = cfg.method_config
        reward_fn = mc.get("reward_fn")
        if not isinstance(reward_fn, dict) or not reward_fn:
            raise ValueError("method.reward_fn must be a non-empty mapping,"
                             " for example {pickscore: 1.0, clipscore: 1.0}")
        unsupported = sorted(set(map(str, reward_fn)) -
                             {"pickscore", "clipscore"})
        if unsupported:
            raise ValueError(
                f"Unsupported DiffusionNFT reward(s): {unsupported}. "
                "Only pickscore and clipscore are currently ported.")

        targs = build_training_args(cfg)
        device = resolve_device(targs)
        student = build_transformer(cfg.model, device=device)
        nft = DiffusionNFTConfig(
            num_video_per_prompt=int(mc.get("num_video_per_prompt", 4)),
            adv_clip_max=float(mc.get("adv_clip_max", 5.0)),
            timestep_fraction=float(mc.get("timestep_fraction", 0.99)),
            kl_beta=float(mc.get("kl_beta", 1e-4)),
            nft_beta=float(mc.get("beta", 0.1)),
            decay_type=int(mc.get("decay_type", 1)),
            adv_mode=str(mc.get("adv_mode", "all")).lower(),
            ema_decay=float(mc.get("ema_decay", 0.0)))
        return cls(DiffusionNFTPipeline(
            student, targs,
            reward_scorer=build_multi_reward_scorer(reward_fn, device=device),
            nft_config=nft,
            sampling=SamplingConfig.from_mapping(mc.get("sampling"))))
