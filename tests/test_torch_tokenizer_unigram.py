"""The port's Unigram ``tokenizer.json`` reader against the ``tokenizers``
package on a small SentencePiece-style tokenizer built here: Unigram model
(random log-probabilities, ``<unk>``, no byte fallback), NFKC inside a
Sequence normalizer, the Metaspace pre-tokenizer and a TemplateProcessing
post-processor that appends ``</s>``. Ids and masks must be equal."""

import base64
import json
import os
import sys

import numpy as np
import pytest

from fastvideo_tpu_torch.models.loader.tokenizer import (UnigramTokenizer,
                                                         WordLevelTokenizer,
                                                         load_tokenizer)

tokenizers = pytest.importorskip("tokenizers")

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_tokenizer_precompiled import build_charsmap  # noqa: E402

# a valid precompiled character map (a double array built by the test)
CHARSMAP = base64.b64encode(build_charsmap(
    {"ａ": "a", "ｂ": "b", "ﬁ": "fi", "①": "1", "  ": " "})).decode()

CHARS = "abcdefghij"
SPACE = "▁"


def _pieces(rng):
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    seen = set()
    for c in CHARS[:8] + SPACE:  # 'i' and 'j' have no piece of their own
        pieces.append((c, float(-rng.uniform(2, 6))))
        seen.add(c)
    while len(pieces) < 200:
        word = "".join(rng.choice(list(CHARS + SPACE), rng.integers(2, 5)))
        if word in seen or SPACE in word[1:]:
            continue
        seen.add(word)
        pieces.append((word, float(-rng.uniform(1, 8))))
    pieces.append(("fi", -2.5))  # what NFKC makes of the ligature U+FB01
    return pieces


@pytest.fixture(scope="module", params=["always", "first"])
def tok_dir(request, tmp_path_factory):
    from tokenizers import (Tokenizer, models, normalizers, pre_tokenizers,
                            processors)

    root = tmp_path_factory.mktemp(f"unigram_{request.param}")
    tok = Tokenizer(models.Unigram(_pieces(np.random.default_rng(0)),
                                   unk_id=2, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([normalizers.NFKC()])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        prepend_scheme=request.param)
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    tok.add_special_tokens(["<pad>", "</s>", "<unk>"])
    tok.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>"}))
    return str(root)


def _prompts():
    rng = np.random.default_rng(1)
    prompts = [
        "abc def", "", " ", "  a  b ", "abcxyz zzz abc",
        "ab</s>cd <pad> e", "</s>", "ﬁ ab ａｂ",
        "hello, WORLD! abcabcabc jjj iij",
        " ".join("abcdefgh"[i % 8] * (i % 4 + 1) for i in range(100)),
    ]
    prompts += ["".join(rng.choice(list(CHARS + "  xyz"),
                                   rng.integers(1, 40))) for _ in range(40)]
    return prompts


@pytest.mark.parametrize("max_length", [64, 8, 1])
def test_ids_and_masks_equal_tokenizers(tok_dir, max_length):
    ref = tokenizers.Tokenizer.from_file(f"{tok_dir}/tokenizer.json")
    ref.enable_truncation(max_length=max_length)
    ref.enable_padding(length=max_length, pad_id=0, pad_token="<pad>")
    ours = load_tokenizer(tok_dir)
    assert isinstance(ours, UnigramTokenizer)
    prompts = _prompts()
    got = ours(prompts, padding="max_length", max_length=max_length,
               truncation=True, return_tensors="np")
    want = ref.encode_batch(prompts)
    assert got["input_ids"].shape == (len(prompts), max_length)
    for i, enc in enumerate(want):
        assert got["input_ids"][i].tolist() == enc.ids, prompts[i]
        assert got["attention_mask"][i].tolist() == enc.attention_mask


def test_unknown_characters_fuse_into_one_unk(tok_dir):
    ours = load_tokenizer(tok_dir)
    ids = ours.encode("a xyz a")
    assert ids.count(ours.unk_id) == 1
    assert ours("a", max_length=4)["input_ids"][0, -1] == ours.pad_id
    # the template's </s> survives truncation
    long = ours("a b c d e f g h", max_length=4)
    assert long["input_ids"][0, -1] == 1 and long["attention_mask"].all()


def _rewrite(tok_dir, tmp_path, edit):
    with open(f"{tok_dir}/tokenizer.json", encoding="utf-8") as fh:
        spec = json.load(fh)
    edit(spec)
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    return str(tmp_path)


@pytest.mark.parametrize("edit,match", [
    (lambda s: s.update(normalizer={"type": "Precompiled",
                                    "precompiled_charsmap": CHARSMAP}),
     None),
    (lambda s: s.update(normalizer={"type": "Sequence", "normalizers": [
        {"type": "NFKC"}, {"type": "Precompiled",
                           "precompiled_charsmap": CHARSMAP}]}), None),
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "Lowercase"),
    (lambda s: s.update(pre_tokenizer={"type": "ByteLevel"}), "ByteLevel"),
    (lambda s: s["model"].update(byte_fallback=True), "byte fallback"),
    (lambda s: s.update(post_processor={"type": "BertProcessing"}),
     "BertProcessing"),
    (lambda s: s["model"].update(type="BPE"), "BPE"),
], ids=["precompiled", "precompiled_in_sequence", "other_normalizer",
        "other_pre_tokenizer", "byte_fallback", "other_post_processor",
        "other_model"])
def test_unported_pieces_raise_with_their_name(tok_dir, tmp_path, edit,
                                               match):
    """What the reader does not take raises with its name. The Precompiled
    normalizer (``match`` None) is ported: alone and in a Sequence, on a
    valid character map, it loads and tokenizes like ``tokenizers``."""
    path = _rewrite(tok_dir, tmp_path, edit)
    if match is None:
        ours = load_tokenizer(path)
        ref = tokenizers.Tokenizer.from_file(f"{path}/tokenizer.json")
        for prompt in _prompts() + ["ａｂ ①  ﬁ", "  ａ  "]:
            assert ours.encode(prompt) + list(ours.suffix_ids) == \
                ref.encode(prompt).ids, prompt
        return
    with pytest.raises(NotImplementedError, match=match):
        load_tokenizer(path)


def test_load_tokenizer_still_reads_word_level(tmp_path):
    (tmp_path / "tokenizer.json").write_text(json.dumps({
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None, "added_tokens": [],
        "model": {"type": "WordLevel", "unk_token": "<unk>",
                  "vocab": {"<pad>": 0, "<unk>": 1, "w1": 2}}}))
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, WordLevelTokenizer)
    assert tok("w1 w2", max_length=3)["input_ids"].tolist() == [[2, 1, 0]]
