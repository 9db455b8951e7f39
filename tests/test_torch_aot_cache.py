"""Warm start, layer 1 and the spec: the port's kernel build cache root and
EngineSpec against the JAX package's ``aot.cache`` and ``aot.spec`` --
resolution order and off-spellings, the root's layout beside JAX's, the
canonical form, description, cache key and ``from_dict`` errors of the
same dicts, and the backend ``resolve()`` picks on the CPU. Pure Python on
both sides: no JAX engine is stepped."""

import json
import os

import pytest

from gameoflifewithactors_torch import _build
from gameoflifewithactors_torch.aot import EngineSpec, cache as aot_cache
from gameoflifewithactors_torch.aot.spec import environment_fingerprint
from gameoflifewithactors_tpu.aot import EngineSpec as JaxSpec
from gameoflifewithactors_tpu.aot import cache as jax_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_root():
    """Put the process's cache root back after a test re-points it."""
    saved, build_dir = dict(aot_cache._state), _build.BUILD_DIR
    yield
    aot_cache._state.update(saved)
    _build.BUILD_DIR = build_dir


def test_resolve_cache_root_precedence_matches_jax(monkeypatch, tmp_path):
    monkeypatch.delenv(aot_cache.ENV_CACHE_DIR, raising=False)
    # the default differs by design: in the repo, beside the package
    assert aot_cache.resolve_cache_root() == aot_cache.default_cache_root() \
        == os.path.join(_REPO, "gameoflifewithactors_torch", "_build")
    assert jax_cache.resolve_cache_root() == jax_cache.default_cache_root()
    cases = [str(tmp_path / "x"), ""]
    for env in [str(tmp_path / "env"), "", "0", "off", "none", "OFF",
                "disabled", " Off "]:
        monkeypatch.setenv(aot_cache.ENV_CACHE_DIR, env)
        assert aot_cache.ENV_CACHE_DIR == jax_cache.ENV_CACHE_DIR
        assert aot_cache.resolve_cache_root() == jax_cache.resolve_cache_root()
        # an explicit path beats the env; an empty explicit path disables
        for explicit in cases:
            assert aot_cache.resolve_cache_root(explicit) == \
                jax_cache.resolve_cache_root(explicit)
    monkeypatch.setenv(aot_cache.ENV_CACHE_DIR, "off")
    assert aot_cache.resolve_cache_root() is None


def test_libraries_and_records_live_beside_jax_not_in_its_dirs(
        tmp_path, restore_root):
    root = str(tmp_path / "root")
    assert aot_cache.ensure_persistent_cache(root) == os.path.join(root, "cuda")
    assert _build.BUILD_DIR == aot_cache.current_cache_dir() == \
        os.path.join(root, "cuda")
    path = _build.library_path("life_packed")
    assert os.path.dirname(path) == os.path.join(root, "cuda")
    assert os.path.isdir(os.path.join(root, "cuda"))
    ours = {_build.BUILD_DIR, aot_cache.aot_registry_dir()}
    theirs = {jax_cache.xla_cache_dir(root), jax_cache.aot_registry_dir(root)}
    assert aot_cache.aot_registry_dir() == os.path.join(root, "torch_aot")
    for a in ours:
        for b in theirs:
            assert not a.startswith(b) and not b.startswith(a), (a, b)


def test_first_call_wins_and_an_explicit_path_repoints(tmp_path, restore_root):
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    aot_cache.ensure_persistent_cache(first)
    # an implicit call (every Engine makes one) keeps the root in effect
    assert aot_cache.ensure_persistent_cache() == os.path.join(first, "cuda")
    assert aot_cache.ensure_persistent_cache(second) == \
        os.path.join(second, "cuda")
    assert _build.library_path("life_ltl").startswith(
        os.path.join(second, "cuda"))
    assert aot_cache.aot_registry_dir() == os.path.join(second, "torch_aot")


def test_a_disabled_cache_builds_into_a_temporary_directory(restore_root):
    assert aot_cache.ensure_persistent_cache("") is None
    assert aot_cache.current_cache_dir() is None
    assert aot_cache.aot_registry_dir() is None
    tmp = _build.BUILD_DIR
    assert os.path.isdir(tmp) and not tmp.startswith(_REPO)
    assert _build.library_path("life_slab").startswith(tmp)
    # the process keeps one temporary directory
    aot_cache.ensure_persistent_cache("")
    assert _build.BUILD_DIR == tmp


def _manifest_specs():
    with open(os.path.join(_REPO, "results", "serve_manifest.json")) as f:
        shipped = json.load(f)
    for entry in shipped:
        entry.pop("lanes", None)
    return shipped + [
        {"rule": "conway", "shape": [48, 96], "backend": "packed"},
        {"rule": "brain", "height": 32, "width": 64, "topology": "dead"},
        {"rule": "bosco", "shape": [64, 64], "mesh": [2, 1],
         "gens_per_exchange": 4},
        {"rule": "R2,C3,M1,S3..8,B5..9,NN", "shape": [16, 32]},
        {"rule": "B2/S/C3", "shape": [8, 32], "backend": "sparse",
         "mesh": (1, 1)},
    ]


@pytest.mark.parametrize("d", _manifest_specs(),
                         ids=lambda d: f"{d['rule']}-{d.get('shape')}")
def test_spec_identity_matches_jax(d):
    env = {"torch": "x", "cuda": "y", "platform": "cpu"}
    ours, theirs = EngineSpec.from_dict(d), JaxSpec.from_dict(d)
    assert ours.canonical() == theirs.canonical()
    assert ours.describe() == theirs.describe()
    assert ours.cache_key(env) == theirs.cache_key(env)
    assert ours.cache_key(env) != ours.cache_key({**env, "cuda": "z"})


def test_from_dict_errors_match_jax():
    for bad in [{"shape": [8, 8], "gird": "typo"},
                {"height": 8, "width": 8, "lanes": [1], "device": "cpu"}]:
        with pytest.raises(ValueError) as ours:
            EngineSpec.from_dict(bad)
        with pytest.raises(ValueError) as theirs:
            JaxSpec.from_dict(bad)
        assert str(ours.value) == str(theirs.value)
        assert "unknown EngineSpec fields" in str(ours.value)


def test_resolve_on_the_cpu_is_the_jax_backend():
    for rule, shape in [("B3/S23", (48, 96)), ("brain", (40, 64)),
                        ("bosco", (40, 64)), ("R2,C4,M1,S3..8,B5..9", (40, 64)),
                        ("R4,C3,M1,S3..8,B5..9", (8, 64)),
                        ("R5,C3,M1,S3..8,B5..9,NN", (8, 64))]:
        spec = EngineSpec(*shape, rule=rule)
        got = spec.resolve("cpu")
        want = JaxSpec(*shape, rule=rule).resolve()
        assert got.canonical() == want.canonical(), rule
        # a resolved spec resolves to itself
        assert got.resolve("cpu") is got


def test_spec_round_trips_through_an_engine():
    spec = EngineSpec(32, 64, rule="brain", topology="dead")
    engine = spec.build_engine(device="cpu")
    assert EngineSpec.from_engine(engine) == spec.resolve("cpu")
    assert engine.backend == "packed" and engine.device.type == "cpu"


def test_environment_fingerprint_names_torch_cuda_and_the_card():
    import torch

    env = environment_fingerprint()
    assert set(env) == {"torch", "cuda", "platform", "device_name",
                        "capability", "device_count"}
    assert env["torch"] == torch.__version__
    assert env["platform"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert env == environment_fingerprint()
