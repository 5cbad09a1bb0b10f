"""The port's config helpers (``dct_tpu_torch/config.py``) against dct_tpu's:
every shipped YAML file read, written and overridden alike, CLI values
parsed alike, and ``tests/test_config_schedules.py``'s config cases. No JAX
computation runs."""
from pathlib import Path

import pytest

from dct_tpu import config as jax_config
from dct_tpu_torch.config import (dict_merge, flatten_dict, load_yaml,
                                  parse_dotted_arg, parse_value, save_yaml,
                                  yaml_parser)

ROOT = Path(__file__).resolve().parents[1]
YAML_FILES = sorted(p.relative_to(ROOT).as_posix() for p in
                    list((ROOT / "configs").glob("*.yaml"))
                    + list((ROOT / "results").glob("*/*.yml")))
CONFIGS = [p for p in YAML_FILES if p.startswith("configs/")]


@pytest.mark.parametrize("path", YAML_FILES)
def test_yaml_files_load_as_dct_tpu_loads_them(path):
    assert load_yaml(ROOT / path) == jax_config.load_yaml(ROOT / path)


@pytest.mark.parametrize("path", YAML_FILES)
def test_saved_yaml_is_dct_tpus_and_reads_back(path, tmp_path):
    config = load_yaml(ROOT / path)
    save_yaml(config, tmp_path / "port" / "config.yml")
    jax_config.save_yaml(config, tmp_path / "ref" / "config.yml")
    assert (tmp_path / "port" / "config.yml").read_bytes() == \
        (tmp_path / "ref" / "config.yml").read_bytes()
    assert load_yaml(tmp_path / "port" / "config.yml") == config


# plain, quoted and flow values as a CLI override gives them, and ones that
# are not YAML at all (they stay strings)
TOKENS = ["1", "0.5", "True", "[1,2,3]", "hello", "runs/x", "1e-3", "1.0e-3",
          "0x1F", "017", "1_000", "-0", ".inf", "~", "null", "", "yes", "off",
          "a: b", "[a, {b: 1}]", "'q''s'", "- a", "segment_transform((256,256))",
          "(patient\\d+_\\d+)_\\d+", "foo # c", "a, b", "{a: 1, b: [2, 3]}",
          "a: b: c", "[1, 2", "-1.5e-5", " x", "a:b", "http://x:1",
          "{grp_regex: '(Case\\d+_\\d+)_\\d+', shuffle: False}"]


@pytest.mark.parametrize("raw", TOKENS)
def test_parse_value_as_dct_tpu(raw):
    ref, got = jax_config.parse_value(raw), parse_value(raw)
    assert got == ref and type(got) is type(ref), (raw, got, ref)
    assert parse_dotted_arg(f"A.B={raw}") == jax_config.parse_dotted_arg(f"A.B={raw}")


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_parser_as_dct_tpu(path, capsys):
    """``--config`` plus dotted overrides that add, replace and nest keys."""
    argv = ["--config", str(ROOT / path), "Trainer.save_dir=runs/x",
            "Trainer.max_epoch=2", "StartTraining.train_jsd=True",
            "Dataset.transform=segment_transform((32,32))", "New.Deep.key=[1, 2]"]
    got = yaml_parser("unused.yaml", argv)
    port_out = capsys.readouterr().out
    assert got == jax_config.yaml_parser("unused.yaml", argv)
    assert port_out == capsys.readouterr().out
    assert got["Trainer"]["max_epoch"] == 2 and got["New"]["Deep"]["key"] == [1, 2]


def test_dct_tpu_config_cases():
    """tests/test_config_schedules.py's TestConfig cases on the port."""
    assert parse_value("1") == 1
    assert parse_value("0.5") == 0.5
    assert parse_value("True") is True
    assert parse_value("[1,2,3]") == [1, 2, 3]
    assert parse_value("hello") == "hello"
    assert parse_dotted_arg("A.B.C=4") == {"A": {"B": {"C": 4}}}
    assert parse_dotted_arg("Trainer.save_dir=runs/x") == {
        "Trainer": {"save_dir": "runs/x"}}
    base = {"A": {"x": 1, "y": 2}, "B": 3}
    assert dict_merge(base, {"A": {"y": 5}}) == {"A": {"x": 1, "y": 5}, "B": 3}
    assert base["A"]["y"] == 2
    assert dict_merge({"a": 1}, None) == {"a": 1}
    assert flatten_dict({"a": {"b": 1}, "c": 2}) == {"a.b": 1, "c": 2}
    with pytest.raises(ValueError):
        parse_dotted_arg("no_equals_sign")
