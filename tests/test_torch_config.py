"""The port's `config.py` against the JAX package's: the same YAML gives the
same `to_dict()`, the same defaults, the same checks and the same
unknown-key warnings; `Flags` reads a path or an inline string. Exact
equality (the trees are plain Python values)."""

import warnings

import pytest

from openembedding_tpu import config as jax_config
from openembedding_tpu_torch import EnvConfig, Flags
from openembedding_tpu_torch import config

YAMLS = [
    "",
    "mesh:\n  num_model_shards: 2\n",
    "server:\n  pull_capacity_factor: 1.5\n  report_interval: 10\n"
    "checkpoint:\n  include_optimizer: false\n  files_per_shard: 4\n",
    "mesh:\n  axis_data: dp\n  axis_model: mp\n"
    "server:\n  default_num_shards: 8\n"
    "checkpoint:\n  persist_pending_window: 3\n",
]


def _warnings(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("text", YAMLS)
def test_same_yaml_same_tree(text):
    got = config.EnvConfig.from_yaml(text)
    want = jax_config.EnvConfig.from_yaml(text)
    assert got.to_dict() == want.to_dict()
    assert config.EnvConfig.from_yaml(got.to_yaml()).to_dict() == \
        got.to_dict()
    assert got.to_yaml() == want.to_yaml()


def test_defaults_match():
    assert EnvConfig().to_dict() == jax_config.EnvConfig().to_dict()
    for name in ("MeshConfig", "ServerConfig", "CheckpointConfig"):
        assert getattr(config, name)().to_dict() == \
            getattr(jax_config, name)().to_dict()


@pytest.mark.parametrize("tree", [
    {"server": {"bogus": 1}},
    {"nope": {}, "mesh": {"num_model_shards": 1, "extra": True}},
    {"checkpoint": {"files_per_shard": 2, "x": 1, "y": 2}},
])
def test_unknown_keys_warn_alike(tree):
    got, got_warn = _warnings(lambda: config.EnvConfig.from_dict(tree))
    want, want_warn = _warnings(lambda: jax_config.EnvConfig.from_dict(tree))
    assert got.to_dict() == want.to_dict()
    assert got_warn == want_warn and got_warn


def test_checks_raise_alike():
    for mod in (config, jax_config):
        with pytest.raises(ValueError, match="num_model_shards must be"):
            mod.EnvConfig.from_yaml("mesh:\n  num_model_shards: 0\n")


def test_flags_read_a_path_or_an_inline_string(tmp_path):
    text = YAMLS[2]
    path = tmp_path / "env.yaml"
    path.write_text(text)
    for source in (str(path), text):
        flags, jflags = Flags(), jax_config.Flags()
        flags.config = jflags.config = source
        assert flags.env.to_dict() == jflags.env.to_dict()
        assert flags.env.server.pull_capacity_factor == 1.5
        assert flags.env is flags.env  # built once
        flags.reset()
        assert flags.config == "" and flags.env.to_dict() == \
            EnvConfig().to_dict()
    assert isinstance(config.flags, Flags)
