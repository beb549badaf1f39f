"""ingest_mbp_s: genome megabases ingested a second: every completed
job's megabases over the window, from the start of the first job to the
end of the last."""


def read(run):
    return len(run.jobs) * run.work["mbp"] / run.window_s
