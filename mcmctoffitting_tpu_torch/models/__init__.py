"""Forward models and fit problems of the port: the unified forward
(``forward``), the flagship joint fits (``simult``, ``onebd`` on
``problem``), the simple family (``simple``), the template unfolding
(``templates``), the CsI-2016 skew-normal preset (``csi2016``) and frozen
parameter views (``fixed_params``).  ``shifting_gaussian`` waits for the
parallel-tempering slice."""

from . import (csi2016, fixed_params, forward, onebd, simple,  # noqa: F401
               simult, templates)
from .forward import ForwardSpec, TofForward, tof_spectrum  # noqa: F401
