"""Tokenizer reader for ``tokenizer.json`` (no ``tokenizers`` package).

Reads the WordLevel model with the Whitespace pre-tokenizer, the layout
``fastvideo_tpu.models.loader.export.make_word_level_tokenizer`` writes,
and the special tokens of ``tokenizer_config.json``. Any other tokenizer
model (SentencePiece/Unigram, BPE) raises. Calling it mirrors a Hugging
Face fast tokenizer called with ``padding="max_length", truncation=True``:
right padding with the pad id, right truncation, attention mask 1 on
tokens.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

# the Whitespace pre-tokenizer's pattern
_WHITESPACE_SPLIT = re.compile(r"\w+|[^\w\s]+")


class WordLevelTokenizer:

    def __init__(self, vocab: dict[str, int], unk_token: str,
                 pad_token: str | None, special_tokens: list[str]):
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.pad_id = vocab.get(pad_token, 0) if pad_token else 0
        specials = sorted({t for t in special_tokens if t}, key=len,
                          reverse=True)
        self._special = set(specials)
        self._special_split = (re.compile("(" + "|".join(
            re.escape(t) for t in specials) + ")") if specials else None)

    @classmethod
    def from_pretrained(cls, directory: str) -> "WordLevelTokenizer":
        with open(os.path.join(directory, "tokenizer.json")) as fh:
            spec = json.load(fh)
        model = spec.get("model", {})
        pre = spec.get("pre_tokenizer") or {}
        if model.get("type") != "WordLevel" or pre.get("type") != "Whitespace":
            raise NotImplementedError(
                f"tokenizer model {model.get('type')!r} with pre-tokenizer "
                f"{pre.get('type')!r}: only WordLevel + Whitespace is ported "
                "(SentencePiece/Unigram comes later)")
        if spec.get("normalizer") or spec.get("post_processor"):
            raise NotImplementedError(
                "tokenizer.json normalizers and post-processors are not "
                "ported")
        config = {}
        cfg_path = os.path.join(directory, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as fh:
                config = json.load(fh)
        specials = [config.get(k) for k in ("pad_token", "eos_token",
                                            "unk_token")]
        specials += [t["content"] for t in spec.get("added_tokens", [])]
        return cls(model["vocab"], model["unk_token"],
                   config.get("pad_token"), specials)

    def encode(self, text: str) -> list[int]:
        pieces = (self._special_split.split(text)
                  if self._special_split is not None else [text])
        ids = []
        for piece in pieces:
            if piece in self._special:
                ids.append(self.vocab.get(piece, self.unk_id))
                continue
            ids.extend(self.vocab.get(w, self.unk_id)
                       for w in _WHITESPACE_SPLIT.findall(piece))
        return ids

    def __call__(self, prompts: str | list[str], *,
                 padding: str = "max_length", max_length: int = 512,
                 truncation: bool = True, return_tensors: str = "np"
                 ) -> dict[str, np.ndarray]:
        if padding != "max_length" or return_tensors != "np":
            raise NotImplementedError(
                "only padding='max_length', return_tensors='np'")
        if isinstance(prompts, str):
            prompts = [prompts]
        ids = np.full((len(prompts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, text in enumerate(prompts):
            toks = self.encode(text)
            if len(toks) > max_length:
                if not truncation:
                    raise ValueError(f"prompt {i} has {len(toks)} tokens > "
                                     f"max_length {max_length}")
                toks = toks[:max_length]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
