"""Text encoding (port of fastvideo_tpu/pipelines/stages/text_encoding.py):
tokenize (pad and truncate to ``max_length``), encode, post-process."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage


class TextEncodingStage(PipelineStage):

    def __init__(self, text_encoders, tokenizers, postprocess_funcs=(),
                 max_length: int = 512, *, device):
        self.text_encoders = list(text_encoders)
        self.tokenizers = list(tokenizers)
        self.postprocess_funcs = list(postprocess_funcs)
        self.max_length = max_length
        self.device = device

    def _encode_one(self, prompts: list[str], idx: int):
        enc = self.tokenizers[idx](prompts, padding="max_length",
                                   max_length=self.max_length,
                                   truncation=True, return_tensors="np")
        ids = torch.as_tensor(enc["input_ids"], device=self.device)
        mask = torch.as_tensor(enc["attention_mask"], device=self.device)
        outputs = self.text_encoders[idx](ids, mask)
        if idx < len(self.postprocess_funcs):
            return self.postprocess_funcs[idx](outputs)
        return outputs.last_hidden_state

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        prompts = batch.prompt if isinstance(batch.prompt,
                                             list) else [batch.prompt]
        for i in range(len(self.text_encoders)):
            batch.prompt_embeds.append(
                self._encode_one([p or "" for p in prompts], i))
        if batch.do_classifier_free_guidance:
            negs = [batch.negative_prompt or ""] * len(prompts)
            for i in range(len(self.text_encoders)):
                batch.negative_prompt_embeds.append(self._encode_one(negs, i))
        return batch
