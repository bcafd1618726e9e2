"""Wan video-to-video (port of
fastvideo_tpu/pipelines/basic/wan/wan_v2v_pipeline.py): the Wan stages with
a VideoVAEEncodingStage before denoising that turns the source clip into
the channel-concat control latent (a seeded posterior sample), and a CLIP
reference-image stage in front of it where the pipeline has an image
encoder. ``LucyEditPipeline`` (Lucy Edit, the Wan2.2 5B editing model)
takes the posterior's mode; its config feeds [noise | video_latent] and a
timestep per token to the DiT."""

from __future__ import annotations

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import WanPipeline
from fastvideo_tpu_torch.pipelines.stages.image_encoding import (
    ImageEncodingStage, VideoVAEEncodingStage)


class WanVideoToVideoPipeline(WanPipeline):
    _required_config_modules = [
        "text_encoder", "tokenizer", "vae", "transformer", "scheduler"
    ]

    _control_sample_mode = "sample"

    def create_pipeline_stages(self, fastvideo_args: FastVideoArgs) -> None:
        super().create_pipeline_stages(fastvideo_args)
        extra = []
        if self.get_module("image_encoder") is not None:
            extra.append(("ref_image_encoding_stage", ImageEncodingStage(
                self.get_module("image_encoder"), device=self.device)))
        extra.append(("video_vae_encoding_stage", VideoVAEEncodingStage(
            self.get_module("vae"), sample_mode=self._control_sample_mode,
            device=self.device)))
        pos = self._stages.index(self.denoising_stage)
        self._stages[pos:pos] = [stage for _, stage in extra]
        for name, stage in extra:
            setattr(self, name, stage)


class LucyEditPipeline(WanVideoToVideoPipeline):
    """Lucy Edit (decart-ai/Lucy-Edit-Dev): no CLIP components, the
    control clip's posterior mode ("argmax")."""

    _control_sample_mode = "argmax"


EntryClass = WanVideoToVideoPipeline
