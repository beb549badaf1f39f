"""build_s: the mean seconds of a job's ``build`` span in the device
ingest: ``build_matrix_device_batched`` (each batch's padding and upload,
``kmer_canon``, ``radix_sort``, ``build_columns``; the union's
``merge_keys``, ``merge_columns``, ``compact_columns``), ended by a
synchronize."""


def read(run):
    return run.spans.mean_s("build") if run.spans else None
