"""The port's LM configs (``repro_torch.configs``, ``repro_torch.models.
config``) against the JAX package's: all ten of JAX's architectures'
published ``CONFIG`` and ``reduced()`` field by field on JAX's fields
(the port's own fields, ``config.PORT_FIELDS``, at their defaults), the
derived layouts, the registry and the shape cells. The port's own
architectures (``PORT_ARCHS``) are checked on their own."""
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
    """Every field of JAX's ``ModelConfig``, the nested ``AespaConfig`` as
    a dict."""
    jax_fields = {f.name for f in dataclasses.fields(jconfig.ModelConfig)}
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in jax_fields}


def port_fields_at_defaults(cfg):
    """The port's own fields hold their defaults."""
    defaults = {f.name: f.default
                for f in dataclasses.fields(tconfig.ModelConfig)}
    jax_fields = {f.name for f in dataclasses.fields(jconfig.ModelConfig)}
    assert set(defaults) - jax_fields == set(tconfig.PORT_FIELDS)
    for name in tconfig.PORT_FIELDS:
        assert getattr(cfg, name) == defaults[name], name


def test_registry_matches_jax():
    """JAX's ten, in JAX's order, with JAX's ids; the port's own
    architectures after them."""
    port_only = {m for m in tconfigs.PORT_ARCHS}
    assert tuple(a for a in tconfigs.ARCHS
                 if a not in port_only) == jconfigs.ARCHS
    assert {k: v for k, v in tconfigs.ALIASES.items()
            if v not in port_only} == jconfigs.ALIASES
    assert [a for a in tconfigs.all_archs()
            if tconfigs.ALIASES[a] not in port_only] == jconfigs.all_archs()
    assert len(jconfigs.ARCHS) == 10
    assert tconfigs.ARCHS[len(jconfigs.ARCHS):] == tconfigs.PORT_ARCHS


def test_port_only_archs_are_registered():
    """deepseek-v2-lite: the port's own, found by id and module name,
    unknown to JAX's registry."""
    assert tconfigs.PORT_ARCHS == ("deepseek_v2_lite",)
    assert tconfigs.ALIASES["deepseek-v2-lite"] == "deepseek_v2_lite"
    assert "deepseek-v2-lite" in tconfigs.all_archs()
    assert "deepseek-v2-lite" not in jconfigs.all_archs()
    cfg = tconfigs.get_config("deepseek-v2-lite")
    assert cfg is tconfigs.get_config("deepseek_v2_lite")
    assert cfg.name == "deepseek-v2-lite" and cfg.mla
    cfg.validate()
    tconfigs.get_reduced("deepseek-v2-lite").validate()


@pytest.mark.parametrize("arch", jconfigs.all_archs())
@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_matches_jax(arch, which):
    get = {"CONFIG": "get_config", "reduced": "get_reduced"}[which]
    jc = getattr(jconfigs, get)(arch)
    tc = getattr(tconfigs, get)(arch)
    assert type(tc) is tconfig.ModelConfig
    assert fields(tc) == fields(jc)
    port_fields_at_defaults(tc)
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
