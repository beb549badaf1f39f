"""load_s: the mean seconds of a job's ``load`` span, the artifact's
matrix onto the card (``GrmDataset.bit_matrix``: ``BitMatrix.from_u64``
-> ``split_u64``, pinned staging, the copy stream, ``deinterleave_u64``),
ended by a synchronize."""


def read(run):
    return run.spans.mean_s("load") if run.spans else None
