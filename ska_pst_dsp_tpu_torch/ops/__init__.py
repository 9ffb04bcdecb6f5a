from .analysis import polyphase_analysis, polyphase_analysis_padded  # noqa: F401
from .lowcbf import polyphase_analysis_lowcbf  # noqa: F401
from .synthesis import polyphase_synthesis  # noqa: F401
