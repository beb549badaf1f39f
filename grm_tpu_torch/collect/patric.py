"""PATRIC/BV-BRC FTP genome + metadata download utilities (port of
``grm_tpu/collect/patric.py``: the same ``ftplib`` client).

Headless re-implementation of the GUI's data-collection download paths
(``src/app.py:529-882`` and the AMR DB updater ``src/app.py:67-77,
3074-3166``): contig FASTA (``genomes/<id>/<id>.fna``) and feature tables
(``genomes/<id>/<id>.PATRIC.features.tab``) from ``ftp.bvbrc.org``, with
bounded concurrency (ThreadPoolExecutor(10), app.py:743-793), cancellation
and partial-file cleanup, plus the release-notes MDTM freshness check.

Network access is required; in offline environments these functions raise
ordinary socket/FTP errors which callers should surface.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from ftplib import FTP

__all__ = [
    "PATRIC_FTP_HOST",
    "AMR_METADATA_PATH",
    "download_genomes",
    "download_amr_metadata",
    "remote_amr_metadata_mdtm",
]

PATRIC_FTP_HOST = "ftp.bvbrc.org"
AMR_METADATA_PATH = "RELEASE_NOTES/PATRIC_genomes_AMR.txt"
MAX_WORKERS = 10  # reference: ThreadPoolExecutor(max_workers=10)


def _connect(host=PATRIC_FTP_HOST, timeout=60):
    ftp = FTP(host, timeout=timeout)
    ftp.login()
    return ftp


def remote_amr_metadata_mdtm(host=PATRIC_FTP_HOST):
    """Modification time string of the AMR metadata file (app.py:67-77)."""
    ftp = _connect(host)
    try:
        resp = ftp.sendcmd("MDTM " + AMR_METADATA_PATH)
        return resp.split()[-1]
    finally:
        ftp.quit()


def download_amr_metadata(dest_dir, host=PATRIC_FTP_HOST, progress_callback=None):
    """Fetch PATRIC_genomes_AMR.txt into dest_dir; returns the local path."""
    os.makedirs(dest_dir, exist_ok=True)
    local = os.path.join(dest_dir, "PATRIC_genomes_AMR.txt")
    ftp = _connect(host)
    try:
        size = ftp.size(AMR_METADATA_PATH)
        done = [0]
        with open(local + ".part", "wb") as f:

            def write(chunk):
                f.write(chunk)
                done[0] += len(chunk)
                if progress_callback and size:
                    progress_callback("AMR metadata", done[0] / size)

            ftp.retrbinary("RETR " + AMR_METADATA_PATH, write)
        os.replace(local + ".part", local)
        return local
    except Exception:
        if os.path.exists(local + ".part"):
            os.remove(local + ".part")
        raise
    finally:
        ftp.quit()


def _download_one(genome_id, dest_dir, features, host):
    """Fetch one genome's .fna (and optionally features.tab)."""
    ftp = _connect(host)
    try:
        targets = ["genomes/%s/%s.fna" % (genome_id, genome_id)]
        if features:
            targets.append(
                "genomes/%s/%s.PATRIC.features.tab" % (genome_id, genome_id)
            )
        written = []
        for remote in targets:
            local = os.path.join(dest_dir, os.path.basename(remote))
            try:
                with open(local + ".part", "wb") as f:
                    ftp.retrbinary("RETR " + remote, f.write)
                os.replace(local + ".part", local)
                written.append(local)
            except Exception:
                if os.path.exists(local + ".part"):
                    os.remove(local + ".part")
                raise
        return genome_id, written, None
    except Exception as e:  # surfaced per-genome, like the GUI's row status
        return genome_id, [], e
    finally:
        try:
            ftp.quit()
        except Exception:
            pass


def download_genomes(genome_ids, dest_dir, features=False, host=PATRIC_FTP_HOST,
                     progress_callback=None, cancel_event=None):
    """Bulk-download contig FASTAs (app.py:529-799).

    Returns {genome_id: [local files]} for successes and a dict of errors.
    """
    os.makedirs(dest_dir, exist_ok=True)
    results, errors = {}, {}
    genome_ids = list(genome_ids)
    with ThreadPoolExecutor(max_workers=MAX_WORKERS) as pool:
        futures = {
            pool.submit(_download_one, gid, dest_dir, features, host): gid
            for gid in genome_ids
        }
        n_done = 0
        for fut in as_completed(futures):
            if cancel_event is not None and cancel_event.is_set():
                for other in futures:
                    other.cancel()
                break
            gid, files, err = fut.result()
            n_done += 1
            if err is None:
                results[gid] = files
            else:
                errors[gid] = err
            if progress_callback:
                progress_callback("Genomes", n_done / len(genome_ids))
    return results, errors
