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
import functools
import heapq
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

    # ids the post-processor puts before and after the sequence
    prefix_ids: tuple[int, ...] = ()
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
        extra = len(self.prefix_ids) + len(self.suffix_ids)
        room = max_length - extra
        for i, text in enumerate(prompts):
            toks = self.encode(text)
            if len(toks) > room:
                if not truncation:
                    raise ValueError(
                        f"prompt {i} has {len(toks) + extra} "
                        f"tokens > max_length {max_length}")
                toks = toks[:max(room, 0)]
            toks = list(self.prefix_ids) + toks + list(self.suffix_ids)
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


# -- BPE (CLIP's byte-level BPE with the </w> end-of-word suffix) ------------

# What ``tokenizers`` knows of Unicode 16.0 and 17.0 and Python 3.12's
# ``unicodedata`` (Unicode 15.0) does not: code points that Oniguruma's
# \p{L} and \p{N} match and Python leaves unassigned (ranges, inclusive),
# and the lowercase mappings of Rust's ``to_lowercase`` that ``str.lower``
# lacks (start, end, offset). Read from ``tokenizers`` over every code point.
_NEW_LETTERS = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF),
    (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D),
)
_NEW_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9),
    (0x1E5F1, 0x1E5FA),
)
_NEW_LOWER = (
    (0x1C89, 0x1C89, 1),
    (0xA7CB, 0xA7CB, -42343),
    (0xA7CC, 0xA7CC, 1),
    (0xA7CE, 0xA7CE, 1),
    (0xA7D2, 0xA7D2, 1),
    (0xA7D4, 0xA7D4, 1),
    (0xA7DA, 0xA7DA, 1),
    (0xA7DC, 0xA7DC, -42561),
    (0x10D50, 0x10D65, 32),
    (0x16EA0, 0x16EB8, 27),
)
_NEW_LOWER_MAP = {cp: cp + off for lo, hi, off in _NEW_LOWER
                  for cp in range(lo, hi + 1)}


@functools.lru_cache(maxsize=None)
def _category_ranges(major: str) -> str:
    """A regex character-class body (no brackets) of every code point whose
    general category starts with ``major``."""
    out, start, prev = [], None, None
    for cp in range(0x110000):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append(_class_range(start, prev))
            start = None
    if start is not None:
        out.append(_class_range(start, prev))
    extra = {"L": _NEW_LETTERS, "N": _NEW_NUMBERS}[major]
    return "".join(out) + "".join(_class_range(lo, hi) for lo, hi in extra)


def _class_range(lo: int, hi: int) -> str:
    return (re.escape(chr(lo)) if lo == hi else
            f"{re.escape(chr(lo))}-{re.escape(chr(hi))}")


def _translate_split_pattern(pattern: str) -> re.Pattern:
    r"""An Oniguruma Split pattern as a Python regex: ``\p{L}`` and
    ``\p{N}`` become explicit classes of the general categories L* and N*,
    ``\s`` one of Unicode White_Space (``_WHITE_SPACE``), as Oniguruma
    reads them. Alternation is leftmost-first in both engines."""
    ws = "".join(re.escape(c) for c in _WHITE_SPACE)
    out, i, depth = [], 0, 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            m = re.match(r"\\p\{(\w+)\}", pattern[i:])
            if m:
                if m.group(1) not in ("L", "N"):
                    raise NotImplementedError(
                        f"Split pattern class {m.group(0)!r} is not ported")
                body = _category_ranges(m.group(1))
                out.append(body if depth else f"[{body}]")
                i += m.end()
                continue
            if pattern[i:i + 2] == "\\s":
                out.append(ws if depth else f"[{ws}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not depth:
            depth = 1
        elif ch == "]" and depth:
            depth = 0
        out.append(ch)
        i += 1
    return re.compile("".join(out))


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character table (ByteLevel)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs, n = list(bs), 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHARS = _bytes_to_unicode()


def _bpe_normalizer(spec: dict | None):
    r"""The normalizers of a BPE tokenizer.json: those of :func:`_normalizer`
    plus ``NFC`` and ``Lowercase`` (CLIP's Sequence[NFC, Replace(\s+,
    " "), Lowercase]). ``Replace``'s regex goes through the Split pattern
    translation (Oniguruma's \s)."""
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "NFC":
        return lambda text: unicodedata.normalize("NFC", text)
    if kind == "Lowercase":
        # character by character, as Rust's char::to_lowercase: no final
        # sigma rule (str.lower of a whole word has one)
        return lambda text: "".join(c.lower() for c in text).translate(
            _NEW_LOWER_MAP)
    if kind == "Sequence":
        steps = [_bpe_normalizer(n) for n in spec.get("normalizers", [])]

        def run(text):
            for step in steps:
                text = step(text)
            return text

        return run
    if kind == "Replace" and "Regex" in spec["pattern"]:
        regex = _translate_split_pattern(spec["pattern"]["Regex"])
        content = spec["content"]
        return lambda text: regex.sub(lambda m: content, text)
    return _normalizer(spec)


def _bpe_post_processor(post: dict | None) -> tuple[tuple[int, ...],
                                                     tuple[int, ...]]:
    """(prefix ids, suffix ids) of a single sequence: RobertaProcessing's
    cls and sep, or a TemplateProcessing's special tokens around ``$A``."""
    if post is None:
        return (), ()
    kind = post.get("type")
    if kind == "RobertaProcessing":
        return (int(post["cls"][1]),), (int(post["sep"][1]),)
    if kind == "TemplateProcessing":
        prefix, suffix, seen = [], [], False
        for item in post.get("single", []):
            if "Sequence" in item:
                seen = True
                continue
            name = item["SpecialToken"]["id"]
            (suffix if seen else prefix).extend(
                post["special_tokens"][name]["ids"])
        return tuple(prefix), tuple(suffix)
    raise NotImplementedError(
        f"tokenizer post-processor {kind!r} is not ported")


# a CLIPTokenizerFast's special tokens where its config names none
_CLIP_DEFAULTS = {"bos_token": "<|startoftext|>",
                  "eos_token": "<|endoftext|>",
                  "unk_token": "<|endoftext|>",
                  "pad_token": "<|endoftext|>"}


def _token_content(token) -> str | None:
    return token.get("content") if isinstance(token, dict) else token


class BPETokenizer(_Tokenizer):
    """Byte-level BPE as ``transformers.AutoTokenizer`` runs a CLIP
    tokenizer.json: added tokens split out (those marked ``normalized``
    after normalization), the normalizer, the ``Split`` pre-tokenizer
    (``invert``, ``Removed``: the pattern's matches are the words), the
    ``ByteLevel`` byte map (``use_regex`` false), BPE merges by rank over
    each word (the ``</w>`` suffix on its last character; a character not
    in the vocabulary is the unk token), and the post-processor's special
    tokens around the sequence."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 unk_token: str | None, pad_token: str | None,
                 raw_specials: list[str], normalized_specials: list[str], *,
                 normalizer=None, split: re.Pattern | None = None,
                 end_of_word_suffix: str = "",
                 continuing_subword_prefix: str = "",
                 ignore_merges: bool = False, fuse_unk: bool = False,
                 prefix_ids: tuple[int, ...] = (),
                 suffix_ids: tuple[int, ...] = ()):
        unk_id = vocab[unk_token] if unk_token is not None else None
        super().__init__(vocab, unk_id, pad_token, raw_specials)
        if pad_token is None:
            self.pad_id = None
        self._norm_special = set(normalized_specials)
        self._norm_split = (re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self._norm_special, key=len,
                                         reverse=True)) + ")")
            if self._norm_special else None)
        self.normalizer = normalizer or (lambda text: text)
        self.split = split
        self.suffix = end_of_word_suffix
        self.prefix = continuing_subword_prefix
        self.ignore_merges = ignore_merges
        self.fuse_unk = fuse_unk
        self.prefix_ids = tuple(prefix_ids)
        self.suffix_ids = tuple(suffix_ids)
        cut = len(continuing_subword_prefix)
        self.merges = {}
        for rank, (a, b) in enumerate(merges):
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[a + b[cut:]])
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_pretrained(cls, directory: str) -> "BPETokenizer":
        spec, config = _read_spec(directory)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise NotImplementedError(
                f"tokenizer model {model.get('type')!r}: BPETokenizer reads "
                "BPE only")
        if model.get("dropout") or model.get("byte_fallback"):
            raise NotImplementedError(
                "BPE dropout and byte fallback are not ported")
        split, byte_level = None, False
        pre = spec.get("pre_tokenizer") or {}
        steps = (pre.get("pretokenizers", []) if pre.get("type") == "Sequence"
                 else [pre] if pre else [])
        for step in steps:
            kind = step.get("type")
            if (kind == "Split" and step.get("invert")
                    and step.get("behavior") == "Removed" and split is None
                    and not byte_level):
                split = _translate_split_pattern(step["pattern"]["Regex"])
            elif (kind == "ByteLevel" and not step.get("use_regex", True)
                  and not step.get("add_prefix_space", False)):
                byte_level = True
            else:
                raise NotImplementedError(
                    f"pre-tokenizer {kind!r} with the BPE model: only "
                    "CLIP's Split (invert, Removed) then ByteLevel "
                    "(use_regex false) is ported")
        if not byte_level:
            raise NotImplementedError(
                "a BPE model without the ByteLevel pre-tokenizer")
        smap = {}
        smap_path = os.path.join(directory, "special_tokens_map.json")
        if os.path.exists(smap_path):
            with open(smap_path, encoding="utf-8") as fh:
                smap = json.load(fh)
        clip = config.get("tokenizer_class") in ("CLIPTokenizer",
                                                 "CLIPTokenizerFast")

        def token(key):
            value = _token_content(config.get(key)) or _token_content(
                smap.get(key))
            return value or (_CLIP_DEFAULTS.get(key) if clip else None)

        added = spec.get("added_tokens", [])
        normalized = [t["content"] for t in added if t.get("normalized")]
        raw = [t["content"] for t in added if not t.get("normalized")]
        # special tokens the config names join as raw added tokens
        raw += [t for t in (token(k) for k in ("bos_token", "eos_token",
                                               "unk_token", "pad_token"))
                if t and t not in normalized and t not in raw]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        prefix_ids, suffix_ids = _bpe_post_processor(
            spec.get("post_processor"))
        return cls(model["vocab"], merges, model.get("unk_token"),
                   token("pad_token"), raw, normalized,
                   normalizer=_bpe_normalizer(spec.get("normalizer")),
                   split=split,
                   end_of_word_suffix=model.get("end_of_word_suffix") or "",
                   continuing_subword_prefix=model.get(
                       "continuing_subword_prefix") or "",
                   ignore_merges=bool(model.get("ignore_merges")),
                   fuse_unk=bool(model.get("fuse_unk")),
                   prefix_ids=prefix_ids, suffix_ids=suffix_ids)

    def __call__(self, prompts, **kwargs) -> dict[str, np.ndarray]:
        if self.pad_id is None:
            raise ValueError("Asking to pad but the tokenizer has no pad "
                             "token")
        return super().__call__(prompts, **kwargs)

    def encode(self, text: str) -> list[int]:
        """Ids of ``text`` without the post-processor's special tokens."""
        ids = []
        for piece, special in _split_on(text, self._special_split):
            if special:
                ids.append(self.vocab[piece])
                continue
            for sub, nspecial in _split_on(self.normalizer(piece),
                                           self._norm_split):
                if nspecial:
                    ids.append(self.vocab[sub])
                else:
                    ids.extend(self.encode_section(sub, first=False))
        return ids

    def encode_section(self, text: str, first: bool) -> list[int]:
        words = self.split.findall(text) if self.split is not None else [text]
        ids = []
        for word in words:
            if not word:
                continue
            mapped = "".join(_BYTE_CHARS[b] for b in word.encode("utf-8"))
            if mapped not in self._cache:
                self._cache[mapped] = self._bpe(mapped)
            ids.extend(self._cache[mapped])
        return ids

    def _bpe(self, word: str) -> list[int]:
        """``tokenizers``' BPE.merge_word and Word.merge_all: the word's
        characters as symbols, then the lowest-ranked pair merged first,
        the leftmost of equal ranks."""
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: list[int] = []
        unk = None
        for i, ch in enumerate(word):
            s = ch if i == 0 else self.prefix + ch
            if i == len(word) - 1:
                s += self.suffix
            tok = self.vocab.get(s)
            if tok is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tok)
            elif self.unk_id is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self.unk_id
        if unk is not None:
            syms.append(unk)
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = [(self.merges[(syms[i], syms[i + 1])][0], i)
                for i in range(n - 1) if (syms[i], syms[i + 1]) in self.merges]
        heapq.heapify(heap)
        while heap:
            rank, pos = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            merge = self.merges.get((syms[pos], syms[right]))
            if merge is None or merge[0] != rank:
                continue  # an expired entry
            syms[pos] = merge[1]
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self.merges.get((syms[prev[pos]], syms[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos]))
            if nxt[pos] < n:
                m = self.merges.get((syms[pos], syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos))
        return [s for s, a in zip(syms, alive) if a]


def _split_on(text: str, pattern: re.Pattern | None):
    """(piece, is_special) over ``text`` cut at ``pattern``'s matches."""
    if pattern is None:
        if text:
            yield text, False
        return
    for i, piece in enumerate(pattern.split(text)):
        if piece:
            yield piece, bool(i % 2)


def load_tokenizer(directory: str) -> _Tokenizer:
    """The reader for the model type of ``directory``'s tokenizer.json."""
    spec, _ = _read_spec(directory)
    kind = spec.get("model", {}).get("type")
    if kind == "WordLevel":
        return WordLevelTokenizer.from_pretrained(directory)
    if kind == "Unigram":
        return UnigramTokenizer.from_pretrained(directory)
    if kind == "BPE":
        return BPETokenizer.from_pretrained(directory)
    raise NotImplementedError(
        f"tokenizer model {kind!r}: the port reads WordLevel, Unigram and "
        "BPE")
