"""The learn cells' dataset: an in-memory artifact made from the seed, with
the split written into it as ``grm dataset split`` writes it.

The matrix's noise words are made on the card (:func:`harness.recipes.
card_noise`) and the markers planted on the host; the artifact stays in
host memory as a ``MemoryArtifact``, standing for the dataset file in the
page cache. The split is the reference's own (:func:`reference.scm.
make_split`, on the card): the program's takes 21 s of host work at the
largest dataset's size, and is ``learn``'s input, not its work.
"""

from __future__ import annotations

import torch

from harness import recipes
from reference import scm as ref

SPLIT = "sp"


def make_artifact(config, seed, device):
    """(the MemoryArtifact, its arrays, the split) of ``config``'s dataset
    from ``seed``."""
    from grm_tpu_torch.dataset import from_numpy_artifact

    data = config["dataset"]
    n, k = data["n_genomes"], data["n_kmers"]
    words = recipes.card_noise(n, k, seed, device)
    arrays, attrs = recipes.synthetic_arrays(n, k, seed % 2 ** 32,
                                             words=words)
    mem = from_numpy_artifact(arrays, attrs)
    sp = config["split"]
    pm = ref.PackedMatrix(arrays["kmer_matrix"], n, device)
    split = ref.make_split(pm, arrays["phenotype"], sp["train_prop"],
                           sp["random_seed"], sp["n_folds"])
    del pm
    ref.write_split(mem, split, SPLIT, sp["random_seed"], n)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return mem, arrays, split


def packed(arrays, device):
    """The reference's copy of the artifact's matrix, on the card."""
    return ref.PackedMatrix(arrays["kmer_matrix"], len(arrays["phenotype"]),
                            device)


def matrix_mismatches(bm, pm):
    """Words of the program's loaded matrix that differ from the
    artifact's."""
    data = bm.data
    n = 0
    for lo in range(0, pm.k, pm.chunk):
        hi = min(pm.k, lo + pm.chunk)
        n += int((data[:, lo:hi] != pm.words32(lo, hi)).sum())
    return n + abs(data.shape[1] - pm.k)
