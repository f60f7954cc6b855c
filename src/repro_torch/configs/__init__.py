"""Config registry: ``get_config(name)`` / ``--arch <id>``."""

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                shape_applicable)
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite_moe
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.gemma_7b import CONFIG as _gemma7b
from repro_torch.configs.granite_3_2b import CONFIG as _granite2b
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma

ARCHITECTURES = {
    cfg.name: cfg
    for cfg in (
        _granite_moe, _xlstm, _llava, _gemma3, _hubert,
        _gemma7b, _granite2b, _grok, _gemma2, _rgemma,
    )
}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise ValueError(
            f"unknown architecture {name!r}; available: {sorted(ARCHITECTURES)}"
        ) from None


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCHITECTURES",
           "get_config", "shape_applicable"]
