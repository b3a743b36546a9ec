"""The port's configs (``repro_torch.configs``) against the JAX
package's: every one of the ten ``ArchConfig``s and its ``reduced()``
equal field for field, and the registry's names, aliases and
properties."""
import dataclasses

import pytest

pytest.importorskip("jax")

from repro import configs as ref  # noqa: E402
from repro_torch import configs  # noqa: E402


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_assigned_names_match():
    assert configs.ASSIGNED == ref.ASSIGNED


@pytest.mark.parametrize("name", ref.ASSIGNED)
def test_config_and_reduced_equal_field_for_field(name):
    got, want = configs.get_config(name), ref.get_config(name)
    assert type(got).__module__.startswith("repro_torch.")
    assert _fields(got) == _fields(want)
    assert _fields(got.reduced()) == _fields(want.reduced())
    for prop in ("padded_vocab", "is_encdec", "d_inner", "ssm_heads"):
        assert getattr(got, prop) == getattr(want, prop), prop
        assert getattr(got.reduced(), prop) == \
            getattr(want.reduced(), prop), prop


@pytest.mark.parametrize("alias", ["minicpm-2b", "qwen2.5-14b", "zamba2-1.2b",
                                   "h2o-danube-3-4b", "internvl2-2b"])
def test_aliases_resolve_to_the_same_config(alias):
    assert _fields(configs.get_config(alias)) == \
        _fields(ref.get_config(alias))


def test_all_configs_and_schema_fields():
    assert list(configs.all_configs()) == list(ref.all_configs())
    assert [f.name for f in dataclasses.fields(configs.ArchConfig)] == \
        [f.name for f in dataclasses.fields(ref.ArchConfig)]


def test_minicpm_full_width():
    cfg = configs.get_config("minicpm-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.padded_vocab) == \
        (40, 2304, 36, 36, 64, 5760, 122_880)
