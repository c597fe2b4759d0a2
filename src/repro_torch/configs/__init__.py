"""Architecture configs (data only; the port's copy of ``repro.configs``).
``get_config(name)`` resolves any assigned arch."""

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig,  # noqa: F401
                                      ShapeSpec, get_config, list_archs,
                                      reduced)
