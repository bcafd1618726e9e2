"""The port's ``Precompiled`` normalizer (SentencePiece's binary character
map) and the ``Strip`` / ``Replace`` normalizers of transformers'
SpmConverter sequences, against the ``tokenizers`` package on a character
map built here (a Darts-clone double array); and the port's grapheme
cluster splitter against ``regex``'s ``\\X``."""

import base64
import json
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fastvideo_tpu_torch.models.loader.graphemes import grapheme_clusters
from fastvideo_tpu_torch.models.loader.tokenizer import (
    PrecompiledNormalizer, UnigramTokenizer, _normalizer, load_tokenizer)

tokenizers = pytest.importorskip("tokenizers")
regex = pytest.importorskip("regex")

# key -> replacement: single code points (1-4 UTF-8 bytes), keys of several
# code points, a key that is a prefix of another ("é" of "é" + U+0301, so a
# cluster "é" + U+0301 takes the shorter key's replacement whole), and
# empty replacements
CHARSMAP = {
    "Ａ": "A", "ｂ": "b", "①": "1", "ﬁ": "fi", " ": " ",
    "　": " ", " ": " ", "~": "-", "é": "E1", "é́": "E2",
    "é": "é", "́": "'", "ᅡ": "a", "각": "gak",
    "​": "", "­": "", "‍": "", "\U0001F1EF": "[J]",
    "\U0001F44D": ":+1:", "가": "ga", "ab": "AB",
}


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """SentencePiece's precompiled map of ``mapping``: a u32 trie size, a
    Darts-clone double array over the keys' UTF-8 bytes (a node's children
    at base ^ label, the leaf at base ^ 0 holding the replacement's offset
    with bit 31 set, each base used by one node), then the NUL-terminated
    replacements."""
    blob, values = bytearray(), {}
    for key, rep in sorted(mapping.items()):
        values[key.encode()] = len(blob)
        blob += rep.encode() + b"\0"
    trie: dict = {}
    for key in values:
        node = trie
        for c in key:
            node = node.setdefault(c, {})
        node[None] = values[key]
    units = {0: 0}
    used_bases: set[int] = set()

    def place(node, pos):
        labels = sorted(c for c in node if c is not None)
        slots = labels + ([0] if None in node else [])
        base = 1
        while (base in used_bases or base ^ pos >= 1 << 21
               or any((base ^ c) in units for c in slots)):
            base += 1
        used_bases.add(base)
        units[pos] |= (base ^ pos) << 10
        if None in node:
            units[base] = node[None] | (1 << 31)
        for c in labels:
            units[base ^ c] = c | ((1 << 8) if None in node[c] else 0)
        for c in labels:
            place(node[c], base ^ c)

    place(trie, 0)
    # whole blocks of 256 units, as Darts-clone allocates them: a lookup
    # goes to base ^ byte, so every base's block must lie inside the array
    top = max(max(units), *(b | 0xFF for b in used_bases))
    array = [0] * ((top // 256 + 1) * 256)
    for pos, unit in units.items():
        array[pos] = unit
    raw = struct.pack(f"<{len(array)}I", *array)
    return struct.pack("<I", len(raw)) + raw + bytes(blob)


def _precompiled():
    return {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
        build_charsmap(CHARSMAP)).decode()}


# the SpmConverter's sequence (transformers 4.57) and an older converter's
NEW_FORM = [{"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": "▁"}]
OLD_FORM = [{"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": " "}]
STRING_FORM = [{"type": "Replace", "pattern": {"String": "  "},
                "content": "_"},
               {"type": "Strip", "strip_left": True, "strip_right": False}]
FORMS = {"spm_converter": NEW_FORM, "older_converter": OLD_FORM,
         "string_replace": STRING_FORM}

FIXED = [
    "", " ", "abc", "Ａｂ ① ﬁ~", "é é é́ ́x x́",
    "é́́", "각 각 가 가",
    "\U0001F1EF\U0001F1F5\U0001F1FA\U0001F1F8 \U0001F1EF",
    "\U0001F468‍\U0001F469‍\U0001F467 \U0001F44D\U0001F3FD "
    "\U0001F44D",
    "a  b   c    d  e　　f  ", "  lead and trail   ",
    "zero​width­soft", "ab abab aab", "\r\n\t x  y",
    "क्षि ab", "क्ष́",
]
# hypothesis draws text from these classes
POOL = (list("abex ~\r\n\t") + ["  ", " ", "　", " ",
                                "́", "̈", "‍", "‌",
                                "​", "­", "️", "é", "Ａ",
                                "ｂ", "①", "ﬁ", "ᄀ", "ᅡ",
                                "ᆨ", "가", "각", "\U0001F1EF",
                                "\U0001F1F5", "\U0001F44D", "\U0001F3FD",
                                "\U0001F468", "क", "्", "ष"])
TEXT = st.lists(st.sampled_from(POOL), max_size=24).map("".join)


def _reference(normalizer: dict, pieces):
    from tokenizers import Tokenizer

    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": 0, "content": "<unk>", "single_word":
                              False, "lstrip": False, "rstrip": False,
                              "normalized": False, "special": True}],
            "normalizer": normalizer,
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "always", "split": True},
            "post_processor": None, "decoder": None,
            "model": {"type": "Unigram", "unk_id": 0, "vocab": pieces,
                      "byte_fallback": False}}
    return spec, Tokenizer.from_str(json.dumps(spec))


def _pieces():
    rng = np.random.default_rng(0)
    chars = sorted(set("".join(CHARSMAP.values()) + "abcdex-'▁_"
                       + "".join(POOL)))
    pieces = [["<unk>", 0.0]]
    pieces += [[c, float(-rng.uniform(2, 6))] for c in chars]
    pieces += [["▁a", -1.5], ["ab", -1.0], ["▁ab", -2.0],
               ["gak", -2.5], ["E1", -1.0], ["fi", -2.0]]
    return pieces


@pytest.fixture(scope="module", params=list(FORMS))
def form(request):
    normalizer = {"type": "Sequence",
                  "normalizers": [_precompiled(), *FORMS[request.param]]}
    spec, ref = _reference(normalizer, _pieces())
    return spec, ref


def test_charsmap_lookups():
    norm = PrecompiledNormalizer(build_charsmap(CHARSMAP))
    for key, rep in CHARSMAP.items():
        if key != "é́":  # shadowed by its prefix "é"
            assert norm.transform(key) == rep, key
    assert norm.transform("é́") == "E1"  # the shortest prefix wins
    assert norm.transform("q") is None and norm.transform("ᄀ") is None
    ref = tokenizers.normalizers.Precompiled(build_charsmap(CHARSMAP))
    for text in FIXED:
        assert norm(text) == ref.normalize_str(text), repr(text)


def _check(spec, ref, text):
    ours = _normalizer(spec["normalizer"])
    assert ours(text) == ref.normalizer.normalize_str(text), repr(text)
    tok = UnigramTokenizer(
        [(p, s) for p, s in spec["model"]["vocab"]], 0, None, ["<unk>"],
        normalizer=ours)
    assert tok.encode(text) == ref.encode(text).ids, repr(text)


@pytest.mark.parametrize("text", FIXED)
def test_fixed_strings_equal_tokenizers(form, text):
    _check(*form, text)


@settings(max_examples=150, deadline=None, database=None, derandomize=True)
@given(text=TEXT)
def test_drawn_strings_equal_tokenizers(text):
    normalizer = {"type": "Sequence",
                  "normalizers": [_precompiled(), *NEW_FORM]}
    _check(*_reference(normalizer, _pieces()), text)


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(text=TEXT)
def test_grapheme_clusters_equal_regex(text):
    assert grapheme_clusters(text) == regex.findall(r"\X", text)


@pytest.mark.parametrize("text", FIXED)
def test_grapheme_clusters_of_fixed_strings(text):
    assert grapheme_clusters(text) == regex.findall(r"\X", text)


def test_load_tokenizer_reads_the_spm_converter_file(tmp_path):
    """A whole tokenizer.json in the published UMT5 layout (Precompiled,
    Strip, Replace; Metaspace; the </s> template) through load_tokenizer."""
    spec, ref = _reference({"type": "Sequence", "normalizers": [
        _precompiled(), *NEW_FORM]}, _pieces() + [["</s>", 0.0]])
    eos = len(spec["model"]["vocab"]) - 1
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "</s>", "type_id": 0}}],
        "pair": [], "special_tokens": {"</s>": {"id": "</s>", "ids": [eos],
                                                "tokens": ["</s>"]}}}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    ours = load_tokenizer(str(tmp_path))
    ref = tokenizers.Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    for text in FIXED:
        assert ours.encode(text) + [eos] == ref.encode(text).ids, repr(text)
    out = ours(FIXED, max_length=16)
    assert out["input_ids"].shape == (len(FIXED), 16)
