"""The dense LM stack of the port (twin of `repro/models`, dense family)."""

from .registry import ModelApi, get_model, init_all  # noqa: F401
