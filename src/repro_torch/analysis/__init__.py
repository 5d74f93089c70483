"""Accounting for the port on one NVIDIA H100: what a call costs (FLOPs,
bytes, peak live memory; :mod:`.count`) and the least time the card
could take for it (:mod:`.roofline`).  The twin of ``repro.analysis``,
which reads the same numbers out of XLA's compiled HLO."""

from repro_torch.analysis.count import (  # noqa: F401
    CountSummary,
    Counter,
    count_call,
)
from repro_torch.analysis.roofline import RooflineTerms  # noqa: F401
from repro_torch.analysis.roofline import \
    roofline as build_roofline  # noqa: F401
