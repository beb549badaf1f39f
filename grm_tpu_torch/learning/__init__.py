from .models import (  # noqa: F401
    ConjunctionModel,
    DisjunctionModel,
    KmerRule,
)
from .rules import KmerRuleClassifications, LazyKmerRuleList  # noqa: F401
