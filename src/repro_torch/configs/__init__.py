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
from repro_torch.configs.granite_4_0_h_small import CONFIG as _granite4h
from repro_torch.configs.moonlight_16b_a3b import CONFIG as _moonlight

ARCHITECTURES = {
    cfg.name: cfg
    for cfg in (
        _granite_moe, _xlstm, _llava, _gemma3, _hubert,
        _gemma7b, _granite2b, _grok, _gemma2, _rgemma,
    )
}

# Architectures of the port alone (the reference package has no Mamba-2 and
# no latent attention): ``get_config`` finds them; ``ARCHITECTURES`` stays
# the reference's set.
PORT_ARCHITECTURES = {cfg.name: cfg for cfg in (_granite4h, _moonlight)}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHITECTURES.get(name) or PORT_ARCHITECTURES[name]
    except KeyError:
        raise ValueError(
            f"unknown architecture {name!r}; available: "
            f"{sorted(ARCHITECTURES) + sorted(PORT_ARCHITECTURES)}"
        ) from None


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCHITECTURES",
           "PORT_ARCHITECTURES", "get_config", "shape_applicable"]
