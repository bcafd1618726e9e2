"""The port's BPE reader (``BPETokenizer``, CLIP's byte-level BPE) against
``transformers.AutoTokenizer``, which the JAX package's CLIP scorers call,
on CLIP-style ``tokenizer.json`` files that the test builds with
``tokenizers``: CLIP's normalizer (NFC, whitespace runs to one space,
lowercase), its Split pattern and ByteLevel pre-tokenizers, BPE merges
with the ``</w>`` suffix and RobertaProcessing. Ids and attention masks
must be equal, padded to 77 with truncation, for random Unicode strings,
contractions, digits, text past 77 tokens and empty text; with the pad
token from tokenizer_config.json, from special_tokens_map.json, or the
CLIP class default."""

import json
import os
import random
import unicodedata

import numpy as np
import pytest
import transformers
from tokenizers import (Regex, Tokenizer, models, normalizers,
                        pre_tokenizers, processors, trainers)

from fastvideo_tpu_torch.models.loader import tokenizer as ttok
from fastvideo_tpu_torch.models.loader.tokenizer import (BPETokenizer,
                                                         load_tokenizer)

# CLIP's Split pattern, as openai/clip-vit-large-patch14's tokenizer.json
CLIP_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")
WORDS = ["a", "photo", "of", "cat", "dog", "the", "running", "blue", "sky",
         "über", "café", "naïve", "日本", "東京", "데이터", "ру́сский", "12",
         "3", "it's", "we're", "they'll", "I'd", "you've", "don't", "!!",
         "emoji🙂", "x²", "½"]


def _corpus(rng):
    for _ in range(2000):
        yield " ".join(rng.choice(WORDS) for _ in range(rng.randint(1, 12)))


def write_clip_tokenizer(directory: str, pad: str | None = "<|endoftext|>",
                         pad_in_special_map: bool = False,
                         vocab_size: int = 700) -> str:
    """A CLIP-layout tokenizer directory: tokenizer.json trained by
    ``tokenizers`` on a small corpus, every byte character and its
    ``</w>`` form in the vocabulary (as CLIP's has them), the special
    tokens marked ``normalized`` (as CLIP's are), and a
    tokenizer_config.json of class CLIPTokenizer."""
    os.makedirs(directory, exist_ok=True)
    tok = Tokenizer(models.BPE(unk_token="<|endoftext|>",
                               continuing_subword_prefix="",
                               end_of_word_suffix="</w>", fuse_unk=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
        normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(CLIP_PATTERN), behavior="removed",
                             invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=["<|startoftext|>", "<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        end_of_word_suffix="</w>", show_progress=False, min_frequency=2)
    tok.train_from_iterator(_corpus(random.Random(0)), trainer)
    sot, eot = (tok.token_to_id("<|startoftext|>"),
                tok.token_to_id("<|endoftext|>"))
    tok.post_processor = processors.RobertaProcessing(
        sep=("<|endoftext|>", eot), cls=("<|startoftext|>", sot),
        trim_offsets=False, add_prefix_space=False)
    path = os.path.join(directory, "tokenizer.json")
    tok.save(path)
    with open(path) as fh:
        spec = json.load(fh)
    vocab = spec["model"]["vocab"]
    for ch in sorted(pre_tokenizers.ByteLevel.alphabet()):
        for t in (ch, ch + "</w>"):
            vocab.setdefault(t, len(vocab))
    for added in spec["added_tokens"]:
        added["normalized"] = True
    with open(path, "w") as fh:
        json.dump(spec, fh)
    cfg = {"tokenizer_class": "CLIPTokenizer", "model_max_length": 77,
           "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
           "unk_token": "<|endoftext|>"}
    if pad is not None and pad_in_special_map:
        with open(os.path.join(directory, "special_tokens_map.json"),
                  "w") as fh:
            json.dump({"pad_token": pad}, fh)
    elif pad is not None:
        cfg["pad_token"] = pad
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump(cfg, fh)
    return directory


def _random_text(rng: random.Random, n: int) -> str:
    """Code points over every plane (most from the BMP), no surrogates."""
    out = []
    while len(out) < n:
        cp = rng.randint(0, 0xFFFF if rng.random() < 0.6 else 0x10FFFF)
        if not 0xD800 <= cp <= 0xDFFF:
            out.append(chr(cp))
    return "".join(out)


def _prompts() -> list[str]:
    rng = random.Random(1)
    fixed = [
        "a photo of a cat", "", " ", "It's THE dog's, we're they'll",
        "I'd you've DON'T 'S 'Ll", "12345 678 x² ½ ٣ ⅷ",
        "Café naïve ÜBER 日本 東京!!! <|endoftext|> x", "<|ENDOFTEXT|>hey",
        "<|startoftext|><|endoftext|>", "a　b\x1cc\td\n\ne​f",
        " ".join(["word"] * 100), "a!b!c ! !! ?!", "  leading   trailing  ",
        "ΣΑΣ ΌΣΟΣ İstanbul ǅ ﬁ", "é 가", "🙂🙃 emoji🙂!",
    ]
    return fixed + [_random_text(rng, rng.randint(1, 60))
                    for _ in range(250)]


@pytest.mark.parametrize("pad,in_map", [
    ("<|endoftext|>", False), ("!", False), ("<|endoftext|>", True),
    (None, False)], ids=["config", "bang", "special_map", "class_default"])
def test_ids_and_masks_equal_autotokenizer(tmp_path, pad, in_map):
    """Equal ids and attention masks, bit for bit, at padding="max_length",
    max_length 77, truncation on: the pad token from tokenizer_config.json,
    from special_tokens_map.json, "!" (a vocabulary token: the config's
    special tokens are split out of the text), or the CLIPTokenizer
    default when neither names one."""
    d = write_clip_tokenizer(str(tmp_path / "tok"), pad=pad,
                             pad_in_special_map=in_map)
    ref = transformers.AutoTokenizer.from_pretrained(d)
    ours = load_tokenizer(d)
    assert isinstance(ours, BPETokenizer)
    prompts = _prompts()
    kw = dict(padding="max_length", max_length=77, truncation=True,
              return_tensors="np")
    got, want = ours(prompts, **kw), ref(prompts, **kw)
    for i, p in enumerate(prompts):
        assert np.array_equal(got["input_ids"][i], want["input_ids"][i]), p
        assert np.array_equal(got["attention_mask"][i],
                              want["attention_mask"][i]), p
    long = prompts.index(" ".join(["word"] * 100))
    assert got["attention_mask"][long].all()  # truncated, ends with eos
    assert got["input_ids"][long, -1] == ref.eos_token_id


def test_unicode_tables_match_tokenizers():
    """The port's classes and lowercase against ``tokenizers``' Oniguruma
    and Rust over every code point of the Unicode 16-17 tables and 30,000
    random code points: \\p{L}, \\p{N}, \\s and Lowercase agree."""
    letters = pre_tokenizers.Split(Regex(r"[\p{L}]+"), behavior="removed",
                                   invert=True)
    numbers = pre_tokenizers.Split(Regex(r"[\p{N}]"), behavior="removed",
                                   invert=True)
    spaces = normalizers.Replace(Regex(r"\s"), " ")
    lower = normalizers.Lowercase()
    ours_l = ttok._translate_split_pattern(r"[\p{L}]")
    ours_n = ttok._translate_split_pattern(r"[\p{N}]")
    ours_s = ttok._translate_split_pattern(r"\s")
    ours_lower = ttok._bpe_normalizer({"type": "Lowercase"})
    cps = {cp for lo, hi in ttok._NEW_LETTERS + ttok._NEW_NUMBERS
           for cp in range(lo, hi + 1)}
    cps |= {cp for lo, hi, _ in ttok._NEW_LOWER for cp in range(lo, hi + 1)}
    rng = random.Random(3)
    cps |= {rng.randint(0, 0x10FFFF) for _ in range(30000)}
    for cp in sorted(cps):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        c = chr(cp)
        assert bool(letters.pre_tokenize_str(c)) == bool(
            ours_l.fullmatch(c)), hex(cp)
        assert bool(numbers.pre_tokenize_str(c)) == bool(
            ours_n.fullmatch(c)), hex(cp)
        assert (spaces.normalize_str(c) == " ") == bool(
            ours_s.fullmatch(c)), hex(cp)
        assert lower.normalize_str(c) == ours_lower(c), hex(cp)
    # the tables hold only what Python's unicodedata leaves unassigned
    for lo, hi in ttok._NEW_LETTERS + ttok._NEW_NUMBERS:
        assert all(unicodedata.category(chr(cp)) == "Cn"
                   for cp in range(lo, hi + 1))


def test_bpe_merges_and_unknown_characters(tmp_path):
    """A hand-written vocabulary: the lowest-ranked pair merges first, the
    leftmost of equal ranks; the end-of-word suffix joins the last
    character; a character outside the vocabulary is the unk token (not
    fused); ids as AutoTokenizer gives them."""
    chars = ["a", "b", "c"]
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in chars:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    merges = [("a", "a"), ("aa", "a</w>"), ("b", "c</w>"), ("a", "b")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges,
                               unk_token="<|endoftext|>",
                               continuing_subword_prefix="",
                               end_of_word_suffix="</w>", fuse_unk=False))
    tok.normalizer = normalizers.Lowercase()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(CLIP_PATTERN), behavior="removed",
                             invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.add_special_tokens(["<|startoftext|>", "<|endoftext|>"])
    tok.post_processor = processors.RobertaProcessing(
        sep=("<|endoftext|>", 1), cls=("<|startoftext|>", 0))
    d = tmp_path / "hand"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "CLIPTokenizer"}))
    ref = transformers.AutoTokenizer.from_pretrained(str(d))
    ours = load_tokenizer(str(d))
    for text in ["aaa", "aaaa", "aaaaa", "abc", "abab", "bc", "xaax",
                 "aa qq a", "ABC CBA", "a-a b.c"]:
        want = ref(text)["input_ids"]
        assert list(ours.prefix_ids) + ours.encode(text) + list(
            ours.suffix_ids) == want, text


def test_what_is_not_ported_raises(tmp_path):
    """Other pre-tokenizers, post-processors and BPE options raise with
    their name; padding without a pad token raises as AutoTokenizer
    does."""
    d = write_clip_tokenizer(str(tmp_path / "tok"))
    path = os.path.join(d, "tokenizer.json")
    with open(path) as fh:
        base = json.load(fh)

    def load_with(edit):
        spec = json.loads(json.dumps(base))
        edit(spec)
        with open(path, "w") as fh:
            json.dump(spec, fh)
        return load_tokenizer(d)

    with pytest.raises(NotImplementedError, match="Metaspace"):
        load_with(lambda s: s.update(pre_tokenizer={"type": "Metaspace"}))
    with pytest.raises(NotImplementedError, match="BertProcessing"):
        load_with(lambda s: s.update(post_processor={
            "type": "BertProcessing", "sep": ["x", 1], "cls": ["y", 0]}))
    with pytest.raises(NotImplementedError, match="dropout"):
        load_with(lambda s: s["model"].update(dropout=0.1))
    plain = load_with(lambda s: None)
    plain.pad_id = None
    with pytest.raises(ValueError, match="pad"):
        plain(["a cat"])
