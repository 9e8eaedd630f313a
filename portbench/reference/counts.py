"""The reference of the counts estimator (the traffic's ``sampling``
'counts'): the campaign's tables (``tables.py``) and the log-prob
(``forward.py``)."""
from .forward import Reference
from .tables import Campaign, campaign

__all__ = ["Campaign", "Reference", "campaign"]
