"""Tokenizer readers for ``tokenizer.json`` (no ``tokenizers`` package).

:func:`load_tokenizer` reads the file and returns the reader for its model:

* :class:`WordLevelTokenizer`: the WordLevel model with the Whitespace
  pre-tokenizer, the layout
  ``fastvideo_tpu.models.loader.export.make_word_level_tokenizer`` writes;
* :class:`UnigramTokenizer`: the SentencePiece Unigram model (Viterbi over
  the vocabulary's log-probabilities, ``unk_id``, byte fallback off) with
  the ``Metaspace`` pre-tokenizer, the ``NFKC``, ``Precompiled`` (the
  binary character map of SentencePiece files,
  :class:`PrecompiledNormalizer`), ``Strip``, ``Replace`` and ``Sequence``
  normalizers, and a
  ``TemplateProcessing`` post-processor (the ``</s>`` a T5 tokenizer
  appends).

Both take the special tokens of ``tokenizer_config.json`` and the file's
``added_tokens``, and calling one mirrors a Hugging Face fast tokenizer
called with ``padding="max_length", truncation=True``: right padding with
the pad id, right truncation (keeping the template's special tokens),
attention mask 1 on tokens. Any other model, pre-tokenizer, normalizer or
post-processor raises with its name.
"""

from __future__ import annotations

import base64
import json
import math
import os
import re
import struct
import unicodedata

import numpy as np

from fastvideo_tpu_torch.models.loader.graphemes import grapheme_clusters

# the Whitespace pre-tokenizer's pattern
_WHITESPACE_SPLIT = re.compile(r"\w+|[^\w\s]+")


def _read_spec(directory: str) -> tuple[dict, dict]:
    """(tokenizer.json, tokenizer_config.json or {}) of a directory."""
    with open(os.path.join(directory, "tokenizer.json"),
              encoding="utf-8") as fh:
        spec = json.load(fh)
    config = {}
    cfg_path = os.path.join(directory, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as fh:
            config = json.load(fh)
    return spec, config


def _special_tokens(spec: dict, config: dict) -> list[str]:
    specials = [config.get(k) for k in ("pad_token", "eos_token",
                                        "unk_token")]
    # tokenizer_config.json may hold a token as {"content": ...}
    specials = [t.get("content") if isinstance(t, dict) else t
                for t in specials]
    return specials + [t["content"] for t in spec.get("added_tokens", [])]


class _Tokenizer:
    """Special-token splitting, padding and truncation shared by the
    readers; a subclass encodes one text section that holds no special
    token."""

    # ids the post-processor puts after the sequence
    suffix_ids: tuple[int, ...] = ()

    def __init__(self, vocab: dict[str, int], unk_id: int,
                 pad_token: str | None, special_tokens: list[str]):
        self.vocab = vocab
        self.unk_id = unk_id
        self.pad_id = vocab.get(pad_token, 0) if pad_token else 0
        specials = sorted({t for t in special_tokens if t}, key=len,
                          reverse=True)
        self._special = set(specials)
        self._special_split = (re.compile("(" + "|".join(
            re.escape(t) for t in specials) + ")") if specials else None)

    def encode_section(self, text: str, first: bool) -> list[int]:
        raise NotImplementedError

    def encode(self, text: str) -> list[int]:
        """Ids of ``text`` without the post-processor's special tokens."""
        pieces = (self._special_split.split(text)
                  if self._special_split is not None else [text])
        ids, offset = [], 0
        for piece in pieces:
            if piece in self._special:
                ids.append(self.vocab.get(piece, self.unk_id))
            elif piece:
                ids.extend(self.encode_section(piece, first=offset == 0))
            offset += len(piece)
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
        room = max_length - len(self.suffix_ids)
        for i, text in enumerate(prompts):
            toks = self.encode(text)
            if len(toks) > room:
                if not truncation:
                    raise ValueError(
                        f"prompt {i} has {len(toks) + len(self.suffix_ids)} "
                        f"tokens > max_length {max_length}")
                toks = toks[:max(room, 0)]
            toks = toks + list(self.suffix_ids)
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class WordLevelTokenizer(_Tokenizer):

    def __init__(self, vocab: dict[str, int], unk_token: str,
                 pad_token: str | None, special_tokens: list[str]):
        super().__init__(vocab, vocab[unk_token], pad_token, special_tokens)

    @classmethod
    def from_pretrained(cls, directory: str) -> "WordLevelTokenizer":
        spec, config = _read_spec(directory)
        model = spec.get("model", {})
        pre = spec.get("pre_tokenizer") or {}
        if model.get("type") != "WordLevel" or pre.get("type") != "Whitespace":
            raise NotImplementedError(
                f"tokenizer model {model.get('type')!r} with pre-tokenizer "
                f"{pre.get('type')!r}: WordLevelTokenizer reads WordLevel + "
                "Whitespace only")
        if spec.get("normalizer") or spec.get("post_processor"):
            raise NotImplementedError(
                "tokenizer.json normalizers and post-processors are not "
                "ported")
        return cls(model["vocab"], model["unk_token"],
                   config.get("pad_token"), _special_tokens(spec, config))

    def encode_section(self, text: str, first: bool) -> list[int]:
        return [self.vocab.get(w, self.unk_id)
                for w in _WHITESPACE_SPLIT.findall(text)]


# Viterbi penalty of an unknown character below the vocabulary's lowest score
_UNK_PENALTY = 10.0


def _normalizer(spec: dict | None):
    """The text -> text function of a tokenizer.json normalizer entry."""
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "NFKC":
        return lambda text: unicodedata.normalize("NFKC", text)
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec.get("normalizers", [])]

        def run(text):
            for step in steps:
                text = step(text)
            return text

        return run
    if kind == "Precompiled":
        return PrecompiledNormalizer(
            base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "Strip":
        left, right = spec.get("strip_left", False), spec.get(
            "strip_right", False)

        def strip(text):
            if left:
                text = text.lstrip(_WHITE_SPACE)
            return text.rstrip(_WHITE_SPACE) if right else text

        return strip
    if kind == "Replace":
        pattern, content = spec["pattern"], spec["content"]
        if "String" in pattern:
            return lambda text: text.replace(pattern["String"], content)
        regex = re.compile(pattern["Regex"])
        return lambda text: regex.sub(lambda m: content, text)
    raise NotImplementedError(f"tokenizer normalizer {kind!r} is not ported")


# Unicode White_Space, which the Strip normalizer strips (Rust's
# char::is_whitespace; Python's str.strip() also strips U+001C-001F)
_WHITE_SPACE = ("\t\n\v\f\r \x85\xa0\u1680\u2000\u2001\u2002\u2003"
                "\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029"
                "\u202f\u205f\u3000")


class PrecompiledNormalizer:
    """SentencePiece's precompiled character map (``Precompiled`` in
    tokenizer.json, as transformers' SpmConverter writes it).

    The map: a u32 little-endian trie size in bytes, a Darts-clone double
    array of that many bytes of u32 units, then NUL-terminated replacement
    strings. The text is cut into extended grapheme clusters; a cluster
    shorter than 6 UTF-8 bytes is looked up whole, and on a match the whole
    cluster becomes the replacement of the *shortest* key that is a prefix
    of its bytes; otherwise each code point is looked up alone and kept
    where no key is its prefix.
    """

    def __init__(self, charsmap: bytes):
        (size,) = struct.unpack_from("<I", charsmap, 0)
        if size % 4 or 4 + size > len(charsmap):
            raise ValueError(f"precompiled charsmap: a trie of {size} bytes "
                             f"in a map of {len(charsmap)}")
        self.units = struct.unpack_from(f"<{size // 4}I", charsmap, 4)
        self.normalized = charsmap[4 + size:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def _shortest_match(self, key: bytes) -> int | None:
        """The value of the shortest key that is a prefix of ``key``."""
        units = self.units
        pos = self._offset(units[0])
        for c in key:
            if c == 0:
                return None
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & 0x800000FF != c:  # the label
                return None
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:  # has a leaf: a key ends here
                return units[pos] & 0x7FFFFFFF
        return None

    def transform(self, chunk: str) -> str | None:
        """The replacement of ``chunk``, None where no key matches."""
        value = self._shortest_match(chunk.encode("utf-8"))
        if value is None:
            return None
        end = self.normalized.find(b"\0", value)
        return self.normalized[value:end if end >= 0 else None].decode(
            "utf-8")

    def __call__(self, text: str) -> str:
        out = []
        for cluster in grapheme_clusters(text):
            if len(cluster.encode("utf-8")) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in cluster:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


class UnigramTokenizer(_Tokenizer):
    """SentencePiece Unigram model with the Metaspace pre-tokenizer."""

    def __init__(self, pieces: list[tuple[str, float]], unk_id: int,
                 pad_token: str | None, special_tokens: list[str], *,
                 normalizer=None, replacement: str = "\u2581",
                 prepend_scheme: str = "always", split: bool = True,
                 suffix_ids: tuple[int, ...] = ()):
        # a repeated piece keeps its last id and score
        vocab = {piece: i for i, (piece, _) in enumerate(pieces)}
        super().__init__(vocab, unk_id, pad_token, special_tokens)
        self.scores = {piece: float(score) for piece, score in pieces}
        self.max_piece_len = max((len(p) for p in vocab), default=1)
        self.unk_score = min((s for _, s in pieces), default=0.0) - \
            _UNK_PENALTY
        self.normalizer = normalizer or (lambda text: text)
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split
        self.suffix_ids = tuple(suffix_ids)

    @classmethod
    def from_pretrained(cls, directory: str) -> "UnigramTokenizer":
        spec, config = _read_spec(directory)
        model = spec.get("model", {})
        if model.get("type") != "Unigram":
            raise NotImplementedError(
                f"tokenizer model {model.get('type')!r}: UnigramTokenizer "
                "reads Unigram only")
        if model.get("byte_fallback"):
            raise NotImplementedError("Unigram byte fallback is not ported")
        if model.get("unk_id") is None:
            raise NotImplementedError("a Unigram model without unk_id")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "Metaspace":
            raise NotImplementedError(
                f"pre-tokenizer {pre.get('type')!r} with the Unigram model: "
                "only Metaspace is ported")
        scheme = pre.get("prepend_scheme")
        if scheme is None:  # files written before prepend_scheme existed
            scheme = "always" if pre.get("add_prefix_space", True) else "never"
        return cls([(p, s) for p, s in model["vocab"]], int(model["unk_id"]),
                   config.get("pad_token"), _special_tokens(spec, config),
                   normalizer=_normalizer(spec.get("normalizer")),
                   replacement=pre.get("replacement", "\u2581"),
                   prepend_scheme=scheme, split=pre.get("split", True),
                   suffix_ids=_template_suffix(spec.get("post_processor")))

    def _words(self, text: str, first: bool) -> list[str]:
        """Metaspace: spaces become the replacement character, one is
        prepended per the scheme, and each replacement starts a new word."""
        rep = self.replacement
        if not text:  # nothing to prepend to (a normalizer stripped it all)
            return []
        text = text.replace(" ", rep)
        if (self.prepend_scheme == "always" or
                (self.prepend_scheme == "first" and first)) and \
                not text.startswith(rep):
            text = rep + text
        if not self.split:
            return [text] if text else []
        words, start = [], 0
        for i, ch in enumerate(text):
            if ch == rep and i > start:
                words.append(text[start:i])
                start = i
        if start < len(text):
            words.append(text[start:])
        return words

    def _viterbi(self, word: str) -> list[int]:
        """The best-scoring segmentation of ``word`` into vocabulary pieces;
        a character no piece covers costs ``unk_score`` and neighbouring
        unknown characters fuse into one unk token."""
        n = len(word)
        best = [-math.inf] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        for start in range(n):
            has_single = False
            for end in range(start + 1, min(n, start + self.max_piece_len) +
                             1):
                piece = word[start:end]
                score = self.scores.get(piece)
                if score is None:
                    continue
                cand = best[start] + score
                if back[end] is None or cand > best[end]:
                    best[end], back[end] = cand, (start, self.vocab[piece])
                has_single = has_single or end == start + 1
            if not has_single:
                cand = best[start] + self.unk_score
                if back[start + 1] is None or cand > best[start + 1]:
                    best[start + 1] = cand
                    back[start + 1] = (start, self.unk_id)
        ids, end = [], n
        while end > 0:
            start, tok = back[end]
            if not (tok == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(tok)
            end = start
        return ids[::-1]

    def encode_section(self, text: str, first: bool) -> list[int]:
        ids = []
        for word in self._words(self.normalizer(text), first):
            ids.extend(self._viterbi(word))
        return ids


def _template_suffix(post: dict | None) -> tuple[int, ...]:
    """The ids a TemplateProcessing post-processor appends to a single
    sequence (``$A </s>``); a template that prepends raises."""
    if post is None:
        return ()
    if post.get("type") != "TemplateProcessing":
        raise NotImplementedError(
            f"tokenizer post-processor {post.get('type')!r} is not ported")
    suffix, seen_sequence = [], False
    for item in post.get("single", []):
        if "Sequence" in item:
            seen_sequence = True
        elif not seen_sequence:
            raise NotImplementedError(
                "a TemplateProcessing template that prepends special tokens")
        else:
            name = item["SpecialToken"]["id"]
            suffix.extend(post["special_tokens"][name]["ids"])
    return tuple(suffix)


def load_tokenizer(directory: str) -> _Tokenizer:
    """The reader for the model type of ``directory``'s tokenizer.json."""
    spec, _ = _read_spec(directory)
    kind = spec.get("model", {}).get("type")
    if kind == "WordLevel":
        return WordLevelTokenizer.from_pretrained(directory)
    if kind == "Unigram":
        return UnigramTokenizer.from_pretrained(directory)
    raise NotImplementedError(
        f"tokenizer model {kind!r}: the port reads WordLevel and Unigram")
