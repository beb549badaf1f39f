from .artifact import GrmDataset, MemoryArtifact, as_dataset  # noqa: F401
from .create import (  # noqa: F401
    from_contigs,
    from_numpy_artifact,
    from_reads,
    from_tsv,
    write_artifact,
)
from .split import split_with_ids, split_with_proportion  # noqa: F401
