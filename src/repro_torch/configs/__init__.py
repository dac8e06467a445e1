"""Assigned architecture configs (10): copies of ``repro.configs``.

Each module exposes CONFIG (full, exact per the assignment); reduced smoke
variants come from ``CONFIG.smoke()``. ``get(name)`` resolves the same arch
ids and aliases as the reference; the port's model runs every family.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "deepseek_v3_671b",
    "llama4_scout_17b_a16e",
    "zamba2_1p2b",
    "granite_34b",
    "qwen1p5_4b",
    "phi4_mini_3p8b",
    "minitron_8b",
    "internvl2_2b",
    "mamba2_780m",
    "hubert_xlarge",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-34b": "granite_34b",
    "qwen1.5-4b": "qwen1p5_4b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "minitron-8b": "minitron_8b",
    "internvl2-2b": "internvl2_2b",
    "mamba2-780m": "mamba2_780m",
    "hubert-xlarge": "hubert_xlarge",
})


def get(name: str):
    mod_name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
