"""Architecture configs: the 10 assigned archs + the paper's imagery config,
and the inter-region table.  Copies of ``repro/configs`` with only the
import prefix changed; they are pure data.

Use `repro_torch.configs.get_config("<arch-id>")` (or `--arch` on the
launchers).
"""

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_archs,
)

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_archs"]
