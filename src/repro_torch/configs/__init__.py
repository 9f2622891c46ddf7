"""The architectures of the port (copies of `repro/configs`): dense, moe, ssm,
hybrid, encdec and vlm.

`get_config(name)` gives the published configuration, `get_smoke_config`
the reduced same-family one of the CPU tests.
"""

from .base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeSpec, arch_ids, get_config, get_smoke_config, long_context_supported)
