"""learn_s: seconds a learn job, over the window: from the start of the
first job to the end of the last, over the jobs completed."""


def read(run):
    return run.window_s / len(run.jobs)
