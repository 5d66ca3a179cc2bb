"""bench.validate_tuned_configs: the --quick CI path must catch a
malformed committed config before it crashes a long GPU run."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import bench


@pytest.fixture
def configs(tmp_path, monkeypatch):
    path = tmp_path / "tuned_configs.json"
    monkeypatch.setattr(bench, "TUNED_CONFIGS", path)
    return path


def test_committed_file_is_valid():
    # the real results/tuned_configs.json must always parse clean
    assert bench.validate_tuned_configs() == []


def test_missing_file_ok(configs):
    assert bench.validate_tuned_configs() == []


def test_good_entries(configs):
    configs.write_text(json.dumps({
        "_comment": "x",
        "k128": {"m1": {"alpha": 0.3, "delta": 0.05, "g": 2, "c": 1,
                        "merge": True, "hub": 2048,
                        "a_layout": "panels", "rowslab_pre": 1024},
                 "m2": {"dense": True}}}))
    assert bench.validate_tuned_configs() == []


@pytest.mark.parametrize("entry, frag", [
    ({"alpha": 0.3, "delta": 0.05, "a_layout": "panles"}, "a_layout"),
    ({"alpha": 0.3, "delta": 0.05, "gg": 2}, "unknown key"),
    # the removed tile-kernel switch is not a config key any more
    ({"alpha": 0.3, "delta": 0.05, "pallas": True}, "unknown key 'pallas'"),
    ({"alpha": 0.3}, "missing 'delta'"),
    ({"alpha": "0.3", "delta": 0.05}, "not a number"),
    ({"alpha": 0.3, "delta": 0.05, "g": 2.5}, "not an int"),
    ({"dense": True, "alpha": 0.3}, "dense entry with extra"),
    ("not-a-dict", "not an object"),
])
def test_malformed_entries_caught(configs, entry, frag):
    configs.write_text(json.dumps({"k128": {"m": entry}}))
    errors = bench.validate_tuned_configs()
    assert errors and frag in errors[0]


def test_bad_json_caught(configs):
    configs.write_text("{nope")
    errors = bench.validate_tuned_configs()
    assert errors and "invalid JSON" in errors[0]


def test_bad_k_key(configs):
    configs.write_text(json.dumps({"q128": {}}))
    errors = bench.validate_tuned_configs()
    assert errors and "bad K key" in errors[0]
