"""cart_host_idle_s: the mean seconds a job in which the device was idle
inside the CART fit's host stages: the program's ``cart.advance``,
``cart.fetch``, ``cart.replay``, ``cart.finish`` and ``cart.predict``
spans."""

from harness import program_spans as ps

HOST = ("cart.advance", "cart.fetch", "cart.replay", "cart.finish",
        "cart.predict")


def read(run):
    return ps.per_job(run, ps.idle_s(run, HOST))
