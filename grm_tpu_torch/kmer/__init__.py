from .counter import count_fasta, count_reads_dir, GenomeKmers  # noqa: F401
from .matrix import (  # noqa: F401
    KmerMatrix,
    build_presence_matrix,
    counts_to_tsv,
    matrix_to_tsv,
    read_matrix_tsv,
)
