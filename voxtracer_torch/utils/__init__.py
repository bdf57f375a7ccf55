from .log import setup_logging  # noqa: F401
from .timing import FpsCounter, StageTimer, span  # noqa: F401
