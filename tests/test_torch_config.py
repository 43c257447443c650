"""The port's YAML reader (``monocon_tpu_torch/config/yaml_subset.py``)
against PyYAML's ``yaml.safe_load``: every file in ``configs/``, the dump of
the default tree, the ``config.yaml`` that the JAX package writes (PyYAML's
block sequences), hypothesis-drawn documents of the subset and dumped
trees, and the constructs outside the subset, which raise with their line
number."""

import json
import math
import re
from pathlib import Path

import pytest
import yaml

import torch_port_helpers  # noqa: F401 -- caps torch's threads
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from monocon_tpu_torch.config import export_cfg, get_default_cfg, load_cfg
from monocon_tpu_torch.config.yaml_subset import (YAMLSubsetError, dump,
                                                  safe_load)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = settings(max_examples=200, deadline=None, database=None,
                    derandomize=True)

# Plain scalars whose YAML 1.1 reading is easy to get wrong.
SPECIAL = ["1e-5", "4.5e-4", "1.0e-05", "1.0e5", "1.0e+5", "1.", ".5", "-.5",
           "+1", "-0", "0", "012", "08", "0x1F", "0b101", "1_000", "1:30",
           "1:30.5", ".inf", "-.Inf", "+.INF", ".NaN", "inf", "nan", "e5",
           "on", "Off", "ON", "yes", "No", "y", "n", "true", "False", "TRUE",
           "null", "Null", "NULL", "~", "abc def", "a#b", "http://x:8", "-x"]


def same(a, b) -> bool:
    """Equal all the way down, types included (``True`` is not ``1``), with
    NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def read_both(text):
    """(PyYAML's result or exception, the port's result or exception)."""
    out = []
    for load in (yaml.safe_load, safe_load):
        try:
            out.append(load(text))
        except Exception as e:  # noqa: BLE001 -- compared below
            out.append(e)
    return out


def assert_reads_as_pyyaml(text):
    want, got = read_both(text)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (text, want, got)
    else:
        assert same(got, want), (text, want, got)


# ------------------------------------------------------- the repo's files
@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_config_files_read_as_pyyaml(path):
    text = path.read_text()
    assert same(safe_load(text), yaml.safe_load(text))
    assert load_cfg(str(path)).to_plain_dict()["SOLVER"]["OPTIM"]["LR"] in (
        4.5e-4, 3.6e-3)


def test_default_tree_dump_reads_back(tmp_path):
    path = tmp_path / "config.yaml"
    export_cfg(get_default_cfg(), str(path))
    text = path.read_text()
    want = get_default_cfg().to_plain_dict()
    assert same(yaml.safe_load(text), want)
    assert same(safe_load(text), want)
    assert same(load_cfg(str(path)).to_plain_dict(), want)


@pytest.mark.parametrize("source", ["default", *sorted(
    p.name for p in (ROOT / "configs").glob("*.yaml"))])
def test_reads_the_jax_packages_config_dump(source, tmp_path):
    """The JAX engine writes the run's config with ``yaml.safe_dump(...,
    default_flow_style=False)``: lists as block sequences at their key's
    indentation. The port reads that file as PyYAML does, and as the JAX
    tree it was written from."""
    from monocon_tpu.config import export_cfg as jax_export_cfg
    from monocon_tpu.config import get_default_cfg as jax_default_cfg
    from monocon_tpu.config import load_cfg as jax_load_cfg

    cfg = (jax_default_cfg() if source == "default"
           else jax_load_cfg(str(ROOT / "configs" / source)))
    path = tmp_path / "config.yaml"
    jax_export_cfg(cfg, str(path))
    text = path.read_text()
    assert "\n  - " in text or "\n- " in text  # a block sequence is there
    want = cfg.to_plain_dict()
    assert same(yaml.safe_load(text), want)
    assert same(safe_load(text), want)
    assert same(load_cfg(str(path)).to_plain_dict(), want)


# ------------------------------------------------------- drawn documents
TIMESTAMP_LIKE = re.compile(r"[0-9]{4}-")
PLAIN = (st.sampled_from(SPECIAL)
         | st.from_regex(r"[A-Za-z0-9][A-Za-z0-9_.:+\-]{0,7}",
                         fullmatch=True)
         .filter(lambda t: not t.endswith(":")
                 and not TIMESTAMP_LIKE.match(t)))
BMP_TEXT = st.text(st.characters(max_codepoint=0xFFFF,
                                 exclude_categories=("Cs",)), max_size=10)
QUOTED = (BMP_TEXT.map(json.dumps)
          | st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E),
                    max_size=10).map(lambda s: "'" + s.replace("'", "''")
                                     + "'"))
FLOW_ITEM = st.recursive(
    PLAIN | QUOTED | st.just("{}"),
    lambda inner: st.lists(inner, max_size=4).map(
        lambda items: "[" + ", ".join(items) + "]"), max_leaves=6)
VALUE = PLAIN | QUOTED | st.just("{}") | st.just("") | st.lists(
    FLOW_ITEM, max_size=4).map(lambda items: "[" + ", ".join(items) + "]")
KEY = (PLAIN.filter(lambda t: t.lower() not in (".nan", "nan"))
       | QUOTED)
ITEM = PLAIN | QUOTED
COMMENT = st.sampled_from(["", "  # a comment", " #", "   # x: [1, 'a'"])


def _key_value(text):
    return next(iter(yaml.safe_load(f"{text}: 0")))


@st.composite
def documents(draw):
    """Nested block mappings (indent steps of 1 to 4 spaces) of plain,
    quoted, flow-list, ``{}`` and empty values and of block sequences of
    scalars (indentless, as PyYAML writes them, or indented), with
    comments and blank lines between and after them."""
    lines = []

    def mapping(depth, indent):
        keys = draw(st.lists(KEY, min_size=1, max_size=4, unique=True))
        resolved = [_key_value(k) for k in keys]
        assume(len(dict.fromkeys(resolved)) == len(keys))
        pad = " " * indent
        for key in keys:
            kind = draw(st.integers(0, 5))
            if depth < 3 and kind == 0:
                lines.append(f"{pad}{key}:{draw(COMMENT)}")
                mapping(depth + 1, indent + draw(st.integers(1, 4)))
            elif kind == 1:
                lines.append(f"{pad}{key}:{draw(COMMENT)}")
                items = " " * (indent + draw(st.integers(0, 3)))
                for value in draw(st.lists(ITEM, min_size=1, max_size=4)):
                    lines.append(f"{items}- {value}{draw(COMMENT)}")
            else:
                lines.append(f"{pad}{key}: {draw(VALUE)}{draw(COMMENT)}")
            lines.extend(draw(st.lists(st.sampled_from(
                ["", "# between", "      # deeper comment"]), max_size=1)))

    mapping(0, draw(st.integers(0, 2)))
    return "\n".join(lines) + "\n"


@EXAMPLES
@given(documents())
def test_drawn_documents_read_as_pyyaml(text):
    assert_reads_as_pyyaml(text)


@pytest.mark.parametrize("token", SPECIAL)
def test_plain_scalars_resolve_as_pyyaml(token):
    """As a value, in flow sequences, and as a key (but NaN, which no key
    lookup finds)."""
    as_key = "" if token.lower() == ".nan" else f"{token}: 1\n"
    assert_reads_as_pyyaml(f"KEY: {token}\nLIST: [{token}, [{token}], "
                           f"'{token}']\n{as_key}")


SCALARS = (st.none() | st.booleans() | st.integers() | st.floats(
    allow_nan=False) | BMP_TEXT)
TREES = st.recursive(
    st.dictionaries(BMP_TEXT, st.recursive(
        SCALARS, lambda inner: st.lists(inner, max_size=3), max_leaves=6)
        | st.just({}), max_size=3),
    lambda inner: st.dictionaries(BMP_TEXT, inner, min_size=1, max_size=3),
    max_leaves=10)


@EXAMPLES
@given(TREES.filter(bool))
def test_dumped_trees_read_back(tree):
    """``dump`` writes what both readers read back as the tree."""
    text = dump(tree)
    assert same(yaml.safe_load(text), tree), text
    assert same(safe_load(text), tree), text


# ------------------------------------------------------- outside the subset
@pytest.mark.parametrize("text, line", [
    ("A: 1\nB: &anchor 2\n", 2),
    ("A: 1\nB: *alias\n", 2),
    ("A: !!str 1\n", 1),
    ("A:\n  B: |\n    text\n", 2),
    ("A: >\n  folded\n", 1),
    ("A:\n  - B: 1\n  - 2\n", 2),
    ("A:\n- [1, 2]\n", 2),
    ("A:\n  - - 1\n", 2),
    ("A:\n- {}\n", 2),
    ("A:\n  - 1\n    - 2\n", 3),
    ("A:\n  - 1\n - 2\n", 3),
    ("A:\n-\n", 2),
    ("- 1\n", 1),
    ("A: 1\n- 2\n", 2),
    ("A: {B: 1}\n", 1),
    ("A:\n\tB: 1\n", 2),
    ("A: 1\t# tab\n", 1),
    ("A: 1\nB: 2\nA: 3\n", 3),
    ("A:\n  B: 1\n  B: 2\n", 3),
    ("A: a plain\n  continued\n", 2),
    ("A: [1,\n  2]\n", 1),
    ("A: \"open\n  quote\"\n", 1),
    ("---\nA: 1\n", 1),
    ("%YAML 1.1\nA: 1\n", 1),
    ("A: 2001-12-14\n", 1),
    ("<<: 1\n", 1),
    ("A: b: c\n", 1),
    ("A:\n    B: 1\n  C: 2\n", 3),
    ("? A\n: 1\n", 1),
    ("just a scalar\n", 1),
    ("A: \"\\q\"\n", 1),
    ("A: 1\nB: \x07\n", 2),
], ids=["anchor", "alias", "tag", "literal block", "folded block",
        "block sequence", "flow sequence item", "nested block sequence",
        "flow mapping item", "deeper item", "shallower item", "empty item",
        "root sequence", "sequence after a value", "flow mapping", "tab indent", "tab after value",
        "duplicate key", "nested duplicate", "multi-line plain",
        "multi-line flow", "multi-line quoted", "document marker",
        "directive", "timestamp", "merge key", "nested mapping in a value",
        "bad dedent", "complex key", "root scalar", "unknown escape",
        "control character"])
def test_outside_the_subset_raises_with_the_line(text, line):
    with pytest.raises(YAMLSubsetError, match=rf"\bline {line}\b"):
        safe_load(text)


def test_comments_and_blank_lines_are_no_document():
    for text in ("", "\n\n", "# only a comment\n  # and another\n"):
        assert safe_load(text) is None and yaml.safe_load(text) is None
