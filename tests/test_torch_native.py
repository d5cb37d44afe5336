"""The port's native parsers (``cldrd_tpu_torch.native``) against the JAX
package's and the pure-Python loaders, on the cases of
tests/test_native.py: EQUAL outputs, the same errors, and the loaders'
paths (native, and the logged pure-Python fallbacks)."""
import json
import logging
import os

import numpy as np
import pytest

from cldrd_tpu import native as jnative
from cldrd_tpu_torch import native
from cldrd_tpu_torch.data import loaders

TSV_ROWS = [
    "0\thello world\n",
    "7\t  padded text \n",
    "123456789012\tbig id row\n",
    "\n",  # blank line skipped
    "3\ttab-free trailing\n",
]

JSONL_ROWS = [
    {"qid": 188714, "relT_pids": [1, 2, 3], "most_hard_pids": [],
     "semi_hard_pids": [9, -8, 70000000000]},
    {"qid": 0, "relT_pids": [5], "relT_scores": [9.25, -0.5, 1e-3],
     "neg_scores": [2.0, 3.5]},
    {"text": "plain words", "esc": "tab\there \"q\" back\\slash",
     "mixed": [1, 2.5, -3]},
    {"empty": [], "strs": ["a", "b c"], "unicode": "naïve café ≤"},
    {},
]


@pytest.fixture()
def python_only(monkeypatch):
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")


def test_library_builds_outside_the_package():
    mod = native.load("_tsvparse")
    path = os.path.realpath(mod.__file__)
    assert path.startswith(str(native.BUILD_DIR))
    assert mod.__name__ == "cldrd_tpu_torch.native._tsvparse"
    assert native.load("_jsonlparse").__name__.endswith("_jsonlparse")


@pytest.mark.parametrize("allow_title", [False, True])
def test_tsv_matches_reference(tmp_path, allow_title):
    two = tmp_path / "two.tsv"
    two.write_text("".join(TSV_ROWS), encoding="utf-8")
    three = tmp_path / "three.tsv"
    three.write_text("5\tThe Title\tThe para body\n9\tplain only\n")
    for path in (two, three):
        ours = native.parse_id_text_tsv(str(path), allow_title=allow_title)
        assert ours == jnative.parse_id_text_tsv(str(path),
                                                 allow_title=allow_title)
    assert native.parse_id_text_tsv(str(two)) == {
        0: "hello world", 7: "padded text", 123456789012: "big id row",
        3: "tab-free trailing"}
    assert native.count_lines(str(two)) == jnative.count_lines(str(two)) == 5


def test_loaders_native_and_python_paths_agree(tmp_path, monkeypatch,
                                               caplog):
    rng = np.random.default_rng(0)
    path = tmp_path / "corpus.tsv"
    with open(path, "w", encoding="utf-8") as f:
        for pid in range(500):
            words = " ".join(str(rng.integers(1e6)) for _ in range(8))
            f.write(f"{pid}\tpassage {words}\n")
        f.write("500\ta title\tand its para\n")
    before = dict(loaders.PARSES)
    fast = loaders.load_passages(str(path))
    queries = loaders.load_queries(str(path))
    assert loaders.PARSES["native"] == before["native"] + 2
    assert loaders.PARSES["python"] == before["python"]
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    with caplog.at_level(logging.WARNING, logger=loaders.__name__):
        slow = loaders.load_passages(str(path))
        slow_q = loaders.load_queries(str(path))
    assert loaders.PARSES["python"] == before["python"] + 2
    assert "pure-Python TSV parse" in caplog.text
    assert fast == slow and queries == slow_q
    assert fast[500] == {"title": "a title", "para": "and its para"}
    assert fast == jnative.parse_id_text_tsv(str(path), allow_title=True)


@pytest.mark.parametrize("mod", [native, jnative], ids=["torch", "jax"])
def test_tsv_errors(tmp_path, mod):
    bad = tmp_path / "bad.tsv"
    bad.write_text("notanint\ttext\n")
    with pytest.raises(ValueError, match="bad integer id"):
        mod.parse_id_text_tsv(str(bad))
    notab = tmp_path / "notab.tsv"
    notab.write_text("42 no tab here\n")
    with pytest.raises(ValueError, match="no tab"):
        mod.parse_id_text_tsv(str(notab))
    with pytest.raises(OSError):
        mod.parse_id_text_tsv(str(tmp_path / "missing.tsv"))


def test_jsonl_matches_reference_and_json_loads(tmp_path):
    path = tmp_path / "train.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for obj in JSONL_ROWS:
            f.write(json.dumps(obj, ensure_ascii=False) + "\n")
    ours = native.parse_jsonl(str(path))
    assert ours == jnative.parse_jsonl(str(path)) == JSONL_ROWS
    assert list(loaders.iter_jsonl(str(path))) == JSONL_ROWS


@pytest.mark.parametrize("text", [
    '{"a": {"nested": 1}}\n', '{"a": true}\n', '{"a": null}\n',
    '{"a": "\\u00e9"}\n', '{"a": 1}\n\n{"b": 2}\n', '{"a": 1} trailing\n'],
    ids=["nested", "bool", "null", "u_escape", "blank_line", "trailing"])
def test_jsonl_outside_schema_falls_back(tmp_path, text, caplog):
    """Constructs outside the flat training schema raise in both native
    parsers; ``iter_jsonl`` then parses with json.loads and says so."""
    path = tmp_path / "x.jsonl"
    path.write_text(text, encoding="utf-8")
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.parse_jsonl(str(path))
    from cldrd_tpu.data import loaders as jloaders

    before = loaders.PARSES["python"]
    if "\n\n" in text or text.endswith("trailing\n"):
        # not JSONL line by line either: both packages' loaders raise
        for mod in (loaders, jloaders):
            with pytest.raises(json.JSONDecodeError):
                list(mod.iter_jsonl(str(path)))
        return
    with caplog.at_level(logging.INFO, logger=loaders.__name__):
        rows = list(loaders.iter_jsonl(str(path)))
    assert rows == list(jloaders.iter_jsonl(str(path))) == [
        json.loads(line) for line in text.splitlines()]
    assert loaders.PARSES["python"] == before + 1
    assert "json.loads" in caplog.text


def test_jsonl_python_path_and_sharding(tmp_path, python_only, caplog):
    path = tmp_path / "train.jsonl"
    path.write_text("".join(json.dumps(o) + "\n" for o in JSONL_ROWS[:4]))
    with caplog.at_level(logging.WARNING, logger=loaders.__name__):
        assert list(loaders.iter_jsonl(str(path))) == JSONL_ROWS[:4]
    assert "pure-Python JSONL parse" in caplog.text
    assert list(loaders.iter_jsonl(str(path), rank=1, nranks=2)) == \
        JSONL_ROWS[1:4:2]
    with pytest.raises(ImportError, match=native.NO_NATIVE_ENV):
        native.load("_tsvparse")
