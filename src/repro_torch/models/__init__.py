"""The LM stack of the port (twin of `repro/models`): the dense, moe, ssm,
hybrid, encdec and vlm families."""

from .registry import ModelApi, get_model, init_all, input_specs  # noqa: F401
