from .scm_experiment import learn_SCM  # noqa: F401
from .cart_experiment import learn_CART  # noqa: F401
