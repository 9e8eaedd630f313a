"""Console-script entry points (pyproject ``[project.scripts]``:
``mcmctof-torch-simult-fit``, ``mcmctof-torch-csi-onebd``,
``mcmctof-torch-ppc``, ``mcmctof-torch-plot-chain``,
``mcmctof-torch-simple-tof``, ``mcmctof-torch-template-fit``,
``mcmctof-torch-shifting-gaussian``).

Each CLI's ``main()`` returns its result dict so tests and library
callers can assert on it; a console script ``sys.exit()``s the return
value, where a dict would read as failure.  These wrappers run the CLI and
discard the dict.
"""


def simult_fit() -> None:
    from . import simult_fit as m
    m.main()


def csi_onebd() -> None:
    from . import csi_onebd as m
    m.main()


def ppc() -> None:
    from . import ppc as m
    m.main()


def plot_chain() -> None:
    from . import plot_chain as m
    m.main()


def simple_tof() -> None:
    from . import simple_tof as m
    m.main()


def template_fit() -> None:
    from . import template_fit as m
    m.main()


def shifting_gaussian() -> None:
    from . import shifting_gaussian as m
    m.main()
