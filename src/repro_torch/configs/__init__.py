"""The dense and MoE architectures the port serves (copies of `repro/configs`).

`get_config(name)` gives the published configuration, `get_smoke_config`
the reduced same-family one of the CPU tests.
"""

from .base import ModelConfig, arch_ids, get_config, get_smoke_config  # noqa: F401
