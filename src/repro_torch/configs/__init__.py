"""Assigned architecture configs (one module per arch) + registry — the
port's copies of ``repro.configs``, unchanged but for the import, and the
port's own architectures (:data:`PORT_ARCHS`), which the JAX package does
not run.

Every module exposes ``CONFIG`` (the exact published hyper-parameters) and
``reduced()`` (a same-family CPU-smoke-test configuration).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS = (
    "whisper_base",
    "llama3_2_3b",
    "gemma3_1b",
    "qwen1_5_0_5b",
    "qwen2_5_3b",
    "dbrx_132b",
    "olmoe_1b_7b",
    "mamba2_370m",
    "recurrentgemma_2b",
    "internvl2_1b",
    "deepseek_v2_lite",
)

#: The architectures of :data:`ARCHS` that only the port runs.
PORT_ARCHS = ("deepseek_v2_lite",)

#: CLI ids (``--arch <id>``) -> module names.
ALIASES: Dict[str, str] = {
    "whisper-base": "whisper_base",
    "llama3.2-3b": "llama3_2_3b",
    "gemma3-1b": "gemma3_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-3b": "qwen2_5_3b",
    "dbrx-132b": "dbrx_132b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-1b": "internvl2_1b",
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def get_config(arch: str) -> ModelConfig:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}").reduced()


def all_archs():
    return list(ALIASES.keys())
