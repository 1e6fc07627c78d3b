"""The port's LM configs (``repro_torch.configs``, ``repro_torch.models.
config``) against the JAX package's: all ten architectures' published
``CONFIG`` and ``reduced()`` field by field, the derived layouts, the
registry and the shape cells."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import config as jconfig
from repro.models import transformer as jT
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as tT

DTYPES = {jnp.dtype("bfloat16"): torch.bfloat16,
          jnp.dtype("float32"): torch.float32}


def fields(cfg):
    """Every field, the nested ``AespaConfig`` as a dict."""
    return dataclasses.asdict(cfg)


def test_registry_matches_jax():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.all_archs() == jconfigs.all_archs()
    assert len(tconfigs.ARCHS) == 10


@pytest.mark.parametrize("arch", jconfigs.all_archs())
@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_matches_jax(arch, which):
    get = {"CONFIG": "get_config", "reduced": "get_reduced"}[which]
    jc = getattr(jconfigs, get)(arch)
    tc = getattr(tconfigs, get)(arch)
    assert type(tc) is tconfig.ModelConfig
    assert fields(tc) == fields(jc)
    assert tc.param_dtype == DTYPES[jc.param_dtype]
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.pattern_split() == jc.pattern_split()
    assert tc.param_count() == jc.param_count()
    assert tT.padded_vocab(tc) == jT.padded_vocab(jc)
    for prop in ("d_inner", "ssm_heads", "attention_free",
                 "supports_long_context", "has_decoder"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    tc.validate()


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_alias_and_module_name_lookups(arch):
    """A CLI id and its module name give the same ``CONFIG`` object."""
    mod = tconfigs.ALIASES[arch]
    assert tconfigs.get_config(arch) is tconfigs.get_config(mod)
    assert tconfigs.get_config(arch).name == arch
    assert fields(tconfigs.get_reduced(mod)) == fields(
        jconfigs.get_reduced(mod))


def test_validate_rejects_what_jax_rejects():
    base = tconfigs.get_reduced("llama3.2-3b")
    jbase = jconfigs.get_reduced("llama3.2-3b")
    bad = [dict(n_kv_heads=3), dict(family="moe", n_experts=0),
           dict(frontend="vision_stub", n_frontend_tokens=0),
           dict(family="encdec", n_enc_layers=0)]
    for kw in bad:
        with pytest.raises(AssertionError):
            dataclasses.replace(jbase, **kw).validate()
        with pytest.raises(AssertionError):
            dataclasses.replace(base, **kw).validate()


def test_shapes_and_aespa_config_match_jax():
    assert [dataclasses.asdict(s) for s in tconfig.SHAPES] == [
        dataclasses.asdict(s) for s in jconfig.SHAPES]
    assert list(tconfig.SHAPES_BY_NAME) == list(jconfig.SHAPES_BY_NAME)
    assert [s.is_train for s in tconfig.SHAPES] == [
        s.is_train for s in jconfig.SHAPES]
    assert dataclasses.asdict(tconfig.AespaConfig()) == dataclasses.asdict(
        jconfig.AespaConfig())
