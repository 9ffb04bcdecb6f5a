from .analysis import polyphase_analysis  # noqa: F401
from .synthesis import polyphase_synthesis  # noqa: F401
