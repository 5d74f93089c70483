"""The step loop's fault handling (``repro.distributed.fault``).  One card
has no collectives, so ``repro.distributed.compression`` has no
counterpart here."""

from repro_torch.distributed.fault import (  # noqa: F401
    StepGuard, StragglerPolicy, UnreplayableStepError)
