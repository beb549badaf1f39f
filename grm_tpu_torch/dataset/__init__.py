from .artifact import GrmDataset, MemoryArtifact  # noqa: F401
from .create import from_numpy_artifact, write_artifact  # noqa: F401
from .split import split_with_proportion  # noqa: F401
