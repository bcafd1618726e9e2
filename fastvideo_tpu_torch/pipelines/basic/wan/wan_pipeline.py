"""Wan pipelines (port of fastvideo_tpu/pipelines/basic/wan/wan_pipeline.py):
WanPipeline, the 3-step DMD WanDMDPipeline, the image-to-video
WanImageToVideoPipeline and the self-forcing WanCausalDMDPipeline.
WanPipeline also runs the Wan2.2 TI2V-5B (its DenoisingStage gets the VAE
for the first-frame encode) and, where ``transformer_2`` is loaded, the
T2V-A14B's two experts: WanPipeline's modules do not name
``transformer_2``, so ``from_pretrained`` loads one expert, as in JAX, and
a caller passes ``required_config_modules`` to load both. Wan uses
FlowUniPC timesteps and the causal Wan flow-match Euler, whatever scheduler
the checkpoint names. Each takes LoRA adapters (``LoRAPipelineMixin``)."""

from __future__ import annotations

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)
from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler)
from fastvideo_tpu_torch.pipelines.composed import ComposedPipelineBase
from fastvideo_tpu_torch.pipelines.lora_pipeline import LoRAPipelineMixin
from fastvideo_tpu_torch.pipelines.stages.causal_denoising import (
    CausalDenoisingStage)
from fastvideo_tpu_torch.pipelines.stages.decoding import DecodingStage
from fastvideo_tpu_torch.pipelines.stages.image_encoding import (
    ImageEncodingStage, WanImageVAEEncodingStage)
from fastvideo_tpu_torch.pipelines.stages.denoising import (DenoisingStage,
                                                            DmdDenoisingStage)
from fastvideo_tpu_torch.pipelines.stages.input_validation import (
    InputValidationStage)
from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
    LatentPreparationStage)
from fastvideo_tpu_torch.pipelines.stages.text_encoding import (
    TextEncodingStage)
from fastvideo_tpu_torch.pipelines.stages.timestep_preparation import (
    TimestepPreparationStage)


class WanPipeline(LoRAPipelineMixin, ComposedPipelineBase):
    _required_config_modules = [
        "text_encoder", "tokenizer", "vae", "transformer", "scheduler"
    ]

    def initialize_pipeline(self, fastvideo_args: FastVideoArgs) -> None:
        self.modules["scheduler"] = FlowUniPCMultistepScheduler(
            shift=self.pipeline_config.flow_shift or 1.0)

    def create_pipeline_stages(self, fastvideo_args: FastVideoArgs) -> None:
        cfg = self.pipeline_config
        dev = self.device
        self.add_stage("input_validation_stage", InputValidationStage(dev))
        self.add_stage("prompt_encoding_stage", TextEncodingStage(
            text_encoders=[self.get_module("text_encoder")],
            tokenizers=[self.get_module("tokenizer")],
            postprocess_funcs=cfg.postprocess_text_funcs, device=dev))
        self.add_stage("timestep_preparation_stage", TimestepPreparationStage(
            self.get_module("scheduler"), cfg, device=dev))
        self.add_stage("latent_preparation_stage", LatentPreparationStage(
            cfg.vae_config, device=dev))
        self.add_stage("denoising_stage", DenoisingStage(
            self.get_module("transformer"), self.get_module("scheduler"), cfg,
            device=dev, transformer_2=self.get_module("transformer_2"),
            vae=self.get_module("vae") if cfg.ti2v_task else None))
        self.add_stage("decoding_stage", DecodingStage(
            self.get_module("vae"), cfg, device=dev))


class WanDMDPipeline(WanPipeline):
    """3-step DMD distilled sampling."""

    def create_pipeline_stages(self, fastvideo_args: FastVideoArgs) -> None:
        super().create_pipeline_stages(fastvideo_args)
        dmd = DmdDenoisingStage(self.get_module("transformer"),
                                self.get_module("scheduler"),
                                self.pipeline_config, device=self.device)
        self._stages[self._stages.index(self.denoising_stage)] = dmd
        self.denoising_stage = dmd


class WanImageToVideoPipeline(WanPipeline):
    """I2V: the CLIP image embeds and the first-frame condition latent,
    made before timestep preparation, condition every DiT pass."""

    _required_config_modules = [
        "text_encoder", "tokenizer", "vae", "transformer", "scheduler",
        "image_encoder", "image_processor"
    ]

    def create_pipeline_stages(self, fastvideo_args: FastVideoArgs) -> None:
        super().create_pipeline_stages(fastvideo_args)
        img_clip = ImageEncodingStage(self.get_module("image_encoder"),
                                      device=self.device)
        img_vae = WanImageVAEEncodingStage(self.get_module("vae"),
                                           device=self.device)
        pos = self._stages.index(self.timestep_preparation_stage)
        self._stages[pos:pos] = [img_clip, img_vae]
        self.image_encoding_stage = img_clip
        self.image_vae_encoding_stage = img_vae


class WanCausalDMDPipeline(WanPipeline):
    """Self-forcing causal generation: the causal Wan denoises block by
    block over its rolling KV caches."""

    def initialize_pipeline(self, fastvideo_args: FastVideoArgs) -> None:
        self.modules["scheduler"] = FlowMatchEulerDiscreteScheduler(
            shift=self.pipeline_config.flow_shift or 5.0)

    def create_pipeline_stages(self, fastvideo_args: FastVideoArgs) -> None:
        super().create_pipeline_stages(fastvideo_args)
        causal = CausalDenoisingStage(self.get_module("transformer"),
                                      self.get_module("scheduler"),
                                      self.pipeline_config, device=self.device)
        self._stages[self._stages.index(self.denoising_stage)] = causal
        self.denoising_stage = causal
