from .scm_experiment import learn_SCM  # noqa: F401
