"""The in-repo YAML reader/writer (sad_tpu/config/yaml_subset.py) against
PyYAML, which is a test-only dependency."""

import glob
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sad_tpu.config import Config, load_cfg
from sad_tpu.config.config import cfg_to_dict, cfg_to_yaml, merge_cfg_from_dict
from sad_tpu.config import yaml_subset

yaml = pytest.importorskip("yaml")

CONFIGS = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml"))
)


def test_repo_has_configs():
    assert len(CONFIGS) >= 2


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_matches_pyyaml_on_repo_configs(path):
    with open(path) as f:
        text = f.read()
    assert yaml_subset.loads(text) == yaml.safe_load(text)


SHARED_SCALES = (64,)

SNIPPETS = {
    "scalars": "A: 1\nB: -2\nC: 0.5\nD: 1e-4\nE: .5\nF: True\nG: off\n"
               "H: ~\nI: null\nJ: (600,)\nK: a#b\nL: 'x # y'\nM: \"q\\tz\"\n",
    "nesting": "TOP:\n  MID:\n    LEAF: 3  # comment\n  OTHER: x\n# full line\nZ:\n",
    "inline_lists": "S: [0, 180000, 240000]\nN: [['a', 'box', 'AP', 0.36]]\n"
                   "E: []\nD: {}\nQ: ['it''s', \"b\"]\n",
    "block_sequence": "TRAIN:\n  SCALES:\n  - 64\n  - 96\n  NAMES:\n"
                      "    - a\n    - 'b c'\nX: 1\n",
    "continuation": "A: [1, 2,\n  3]\nB: some long\n  plain text\n",
    "url_and_path": "W: https://example.com/R-50.pkl\nP: /tmp/x:y\n",
    "anchors": "A: &a [1, 2]\nB: *a\nC: [&b 3, *b]\nD: &d\n  E: 1\nF: *d\n"
               "G: &g\n- x\nH: *g\nI:\n- &i 5\n- *i\n",
    # what PyYAML's dumper writes for configs that hold one object twice
    "pyyaml_dump_shared_list": yaml.safe_dump(
        {key: {"SCALES": SHARED_SCALES} for key in ("TEST", "TRAIN")}
    ),
    "compact_sequences": "R:\n- - ds\n  - box\n  - 0.5\n- - a\n  - - b\n"
                         "    - c\nM:\n- K: 1\n  L: [2]\n- K: 3\n",
    "pyyaml_dump_nested_lists": yaml.safe_dump(
        {"EXPECTED_RESULTS": [["ds", "box", "AP", 0.0], ["ds", "segm", "AP", 1]]}
    ),
    "pyyaml_dump_shared_map": yaml.safe_dump(
        dict.fromkeys(("TEST", "TRAIN"), {"SCALES": [64]})
    ),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_reader_matches_pyyaml_on_snippets(name):
    text = SNIPPETS[name]
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text", ["A: !!int 1\n", "A: |\n  text\n", "A: {b: 1}\n", "A: [1, 2\n",
             "A: *undefined\n"]
)
def test_reader_refuses_unsupported_syntax(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_writer_round_trips_loaded_configs(path):
    cfg = load_cfg(path, ["NUM_GPUS", "2", "OUTPUT_DIR", "/tmp/o u't"])
    text = cfg_to_yaml(cfg)
    assert yaml.safe_load(text) == cfg_to_dict(cfg)
    assert merge_cfg_from_dict(Config(), yaml_subset.loads(text)) == cfg


def test_writer_round_trips_awkward_values():
    d = {
        "a": {"b": [1.5, 2.0, 1e-05, float("inf")], "c": ""},
        "d": ["True", "1", "x: y", "#c", None, False],
        "e": [["coco_2014_minival", "box", "AP", 0.366]],
        "f": {},
        "g": 3,
    }
    text = yaml_subset.dumps(d)
    assert yaml_subset.loads(text) == d
    assert yaml.safe_load(text) == d


_KEYS = st.from_regex(r"[A-Z][A-Z0-9_]{0,11}", fullmatch=True)
_SCALARS = (
    st.none() | st.booleans() | st.integers(-10 ** 12, 10 ** 12)
    | st.floats(allow_nan=False, width=64)
    | st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=90)
)
_VALUES = st.recursive(
    _SCALARS,
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(_KEYS, inner, max_size=4),
    max_leaves=12,
)


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(_KEYS, _VALUES, max_size=6))
def test_reader_reads_what_pyyaml_dumps(doc):
    """Configs written with PyYAML's safe_dump load unchanged."""
    text = yaml.safe_dump(doc)
    assert yaml_subset.loads(text) == yaml.safe_load(text)
