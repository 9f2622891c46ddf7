from .engine import Engine, Request, generate_reference  # noqa: F401
from .sampling import SamplingParams, sample  # noqa: F401
