"""Architecture + shape registry: the assigned 10 archs x 4 shapes = 40 cells.

``cells()`` enumerates every (arch, shape) pair with its applicability ruling
(long_500k requires sub-quadratic sequence handling — run for ssm/hybrid/SWA,
skip for pure full-attention archs; see DESIGN.md §4)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, smoke_variant

ARCH_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "llava-next-34b": "llava_next_34b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-7b": "zamba2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen3-4b": "qwen3_4b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-1.7b": "qwen3_1_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG.validate()


def get_smoke(name: str, **overrides) -> ModelConfig:
    return smoke_variant(get(name), **overrides)


def arch_names() -> list[str]:
    return list(ARCH_MODULES)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 512k dense-KV decode is "
                       "out of scope per assignment (needs sub-quadratic "
                       "attention); see DESIGN.md §4")
    return True, ""


def cells():
    """Yield (arch_name, cfg, shape, runnable, skip_reason) for all 40 cells."""
    for name in ARCH_MODULES:
        cfg = get(name)
        for shape in SHAPES.values():
            ok, reason = applicable(cfg, shape)
            yield name, cfg, shape, ok, reason
