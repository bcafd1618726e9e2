"""The port's YAML reader against ``yaml.safe_load``, which the JAX package
uses whenever PyYAML imports (fastvideo_tpu/api/parser.py:119-126): the
JAX repo's training examples, and flow collections nested in a block
mapping with quoted strings that hold ':', ',' and '#'."""

import glob
import os

import pytest

from fastvideo_tpu_torch.api.errors import ConfigValidationError
from fastvideo_tpu_torch.api.parser import parse_simple_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "training",
                                         "*.yaml")))

CASES = {
    "nested_flow_mappings": """\
callbacks:
  grad_clip: {max_norm: 1.0}
  nested: {a: {b: {c: [1, 2, {d: e}]}}, f: [], g: {}}
  ema: {decay: 0.995, start: 100}
""",
    "quoted_strings": """\
paths:
  url: "http://host:8000/v1, then more"
  single: 'it''s: a, b'
  in_flow: {k: "x: y, z", 'q:r': 's, t', u: ["a, b", 'c: d']}
  hash: "a # not a comment"   # but this is
  escapes: "tab\\there \\"quoted\\""
""",
    "scalars": """\
values:
  ints: [0, -3, 1_000, 0x1F, 017, 0b101]
  floats: [1.0e-5, 2.5e+3, .5, -1., .inf, -.Inf]
  bools: [yes, No, TRUE, off, On]
  nulls: [~, null, Null]
  strings: [none, y, n, oN, inf, 1.2.3, a b c]
  empty_value_in_flow: {a: , b: c}
""",
}


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_training_examples_read_as_safe_load_reads_them(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as fh:
        text = fh.read()
    assert parse_simple_yaml(text) == yaml.safe_load(text)


def test_examples_hold_flow_mappings():
    """The examples exercise the repair: their callbacks are flow mappings
    (the reader once kept '{max_norm: 1.0}' as a string)."""
    with open(os.path.join(ROOT, "examples", "training", "sft.yaml")) as fh:
        cfg = parse_simple_yaml(fh.read())
    assert cfg["callbacks"] == {"grad_clip": {"max_norm": 1.0},
                                "ema": {"decay": 0.995},
                                "validation": {"every_n_steps": 500}}
    assert cfg["training"]["learning_rate"] == 1.0e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_flow_collections_and_quotes_read_as_safe_load_reads_them(name):
    yaml = pytest.importorskip("yaml")
    text = CASES[name]
    assert parse_simple_yaml(text) == yaml.safe_load(text)


def test_exponent_without_a_dot_is_a_float():
    """The one stated difference: YAML 1.1 (PyYAML) keeps "1e-3" a string;
    the reader reads it as JSON and YAML 1.2 do, so a config's JSON and YAML
    forms agree."""
    assert parse_simple_yaml("a:\n  lr: 1e-3\n  b: -2E+2\n") == {
        "a": {"lr": 1e-3, "b": -200.0}}


@pytest.mark.parametrize("text", [
    "just a line\n",
    "a: {b: 1\n",
    "a: [1, 2\n",
    "a: 'unterminated\n",
    "a: {b: 1} trailing\n",
    "a: [1, 2]]\n",
], ids=["no_colon", "open_mapping", "open_sequence", "open_quote",
        "trailing_text", "extra_close"])
def test_malformed_lines_raise(text):
    with pytest.raises(ConfigValidationError):
        parse_simple_yaml(text)
