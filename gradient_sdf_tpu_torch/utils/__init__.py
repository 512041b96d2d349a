from . import se3  # noqa: F401
from .timer import Timer  # noqa: F401
